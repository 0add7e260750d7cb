"""The port's dataset CLI and its host modules against the JAX package's:
`io/native.py` (PNG bytes identical, the pure-Python codec, the byte
queue), `io/tum.py` (association parsing, frames), `viz.py` (overlays
equal), `viewer.py` (HTTP round trip on 127.0.0.1) and `run_tum.py` (the
synthetic dataset writer, per-frame and chunked runs on the CPU with the
reference's summary keys).

The CLI runs `synthetic_config()` (640x480, 1024 keypoints, 4096 local
points); the runs here shrink it to the other port tests' 320x240 size to
stay cheap on the CPU, where the plain Hamming version takes ~3 s per
4096x1024 matrix.
"""

import ast
import dataclasses
import functools
import json
import os
import struct
import urllib.error
import urllib.request
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu import run_tum as jrun
from sgslam_tpu import viz as jviz
from sgslam_tpu.io import checkpoint as jck
from sgslam_tpu.io import native as jnative
from sgslam_tpu.io import tum as jtum
from sgslam_tpu.semantic.dynamic import Boxes as JBoxes
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch import convert
from sgslam_tpu_torch import run_tum as trun
from sgslam_tpu_torch import viz as tviz
from sgslam_tpu_torch.io import native as tnative
from sgslam_tpu_torch.io import tum as ttum
from sgslam_tpu_torch.semantic.dynamic import Boxes as TBoxes
from sgslam_tpu_torch.viewer import LiveViewer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_MAP = os.path.join(ROOT, "sgslam_tpu", "assets", "eval_map.npz")
PNG_MAGIC = b"\x89PNG"
N_CLI = 24
SMALL = dict(orb=tcfg.OrbConfig(n_features=600, max_keypoints=640),
             capacity=tcfg.MapCapacity(max_keyframes=64, max_points=8192,
                                       local_window=4, local_points=1024))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images():
    rng = np.random.default_rng(0)
    return {"gray8": rng.integers(0, 256, (37, 53), dtype=np.uint8),
            "rgb8": rng.integers(0, 256, (29, 41, 3), dtype=np.uint8),
            "gray16": rng.integers(0, 65536, (31, 47), dtype=np.uint16)}


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_png_bytes_match_reference(tmp_path, kind):
    """The native encoder and the pure-Python one write the reference's
    bytes, and both decoders read them back."""
    img = _images()[kind]
    paths = {k: str(tmp_path / f"{k}.png") for k in ("ref", "port", "py")}
    jnative.png_write(paths["ref"], img)
    tnative.png_write(paths["port"], img)
    tnative._png_write_py(paths["py"], img, 1 if img.ndim == 2 else 3,
                          16 if img.dtype == np.uint16 else 8)
    ref = open(paths["ref"], "rb").read()
    assert tnative.available()
    assert open(paths["port"], "rb").read() == ref
    assert open(paths["py"], "rb").read() == ref
    for read in (tnative.png_read, tnative._png_read_py):
        out = read(paths["port"])
        assert out.dtype == img.dtype
        np.testing.assert_array_equal(out, img)


def _png_with_filters(img, filters):
    """An 8-bit PNG whose row y uses filter filters[y % len(filters)]."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch).astype(np.int64)
    out, prev = b"", np.zeros(w * ch, np.int64)
    for y in range(h):
        f, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prev[:-ch]])
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            enc = cur - pred
        out += bytes([f]) + (enc & 255).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if ch == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(out)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["gray8", "rgb8"])
def test_png_python_decoder_all_filters(tmp_path, kind):
    """The pure-Python reader undoes all five PNG row filters, as the
    native decoder does."""
    img = _images()[kind]
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_with_filters(img, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(tnative._png_read_py(path), img)
    np.testing.assert_array_equal(jnative.png_read(path), img)


def test_byte_queue_round_trip():
    q = tnative.ByteQueue(capacity=2)
    try:
        assert q.push(b"a") and q.try_push(b"b" * 70000)
        assert not q.try_push(b"c")               # full
        assert q.pop() == b"a" and len(q.pop()) == 70000
        q.close()
        assert q.pop() is None
    finally:
        q.destroy()


def _write_lists(d):
    """rgb.txt / depth.txt with jittered stamps, an association file and a
    ground truth, in TUM's layouts."""
    rng = np.random.default_rng(1)
    t = np.arange(12) / 30.0 + 1305031102.0
    with open(d / "rgb.txt", "w") as f:
        f.write("# color images\n" + "".join(
            f"{x:.6f} rgb/{x:.6f}.png\n" for x in t))
    with open(d / "depth.txt", "w") as f:
        f.write("# depth maps\n\n" + "".join(
            f"{x:.6f} depth/{x:.6f}.png\n"
            for x in t + rng.uniform(-0.03, 0.03, 12)))
    with open(d / "assoc.txt", "w") as f:
        f.write("".join(f"{x:.6f} rgb/{x:.6f}.png {x + 0.001:.6f} "
                        f"depth/{x:.6f}.png\n" for x in t) + "1 2\n")
    q = rng.normal(size=(12, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    with open(d / "groundtruth.txt", "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n" + "".join(
            f"{x:.4f} {a:.4f} {b:.4f} {c:.4f} {q1:.4f} {q2:.4f} {q3:.4f} "
            f"{q0:.4f}\n" for x, (a, b, c), (q0, q1, q2, q3) in zip(
                t, rng.normal(size=(12, 3)), q)))


def test_association_parsing(tmp_path):
    _write_lists(tmp_path)
    for fn, args in ((jtum.associate, ("rgb.txt", "depth.txt")),
                     (jtum.load_association, ("assoc.txt",))):
        paths = [str(tmp_path / a) for a in args]
        j, t = fn(*paths), getattr(ttum, fn.__name__)(*paths)
        np.testing.assert_array_equal(t.timestamps, j.timestamps)
        assert t.rgb_paths == j.rgb_paths and t.depth_paths == j.depth_paths
    jt, jp = jtum.load_groundtruth(str(tmp_path / "groundtruth.txt"))
    tt, tp = ttum.load_groundtruth(str(tmp_path / "groundtruth.txt"))
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tp, jp)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """One small synthetic dataset written by each package's writer."""
    cam = jcfg.synthetic_config(160, 120).camera
    root = tmp_path_factory.mktemp("seqs")
    jrun._make_synthetic_dataset(str(root / "ref"), 4, cam, False, False)
    tcam = tcfg.synthetic_config(160, 120).camera
    trun._make_synthetic_dataset(str(root / "port"), 4, tcam, False, False,
                                 torch.device("cpu"))
    return root


def test_dataset_writer_matches_reference(datasets):
    """The same lists and file names; the PNGs within the renderer's gap:
    its ~2e-3 texture differences move 0.25-0.40% of the 8-bit gray
    values by one step, and depth moves by at most one 16-bit step."""
    ref, port = datasets / "ref", datasets / "port"
    for name in ("rgb.txt", "depth.txt"):
        assert (port / name).read_text() == (ref / name).read_text()
    gj = np.loadtxt(ref / "groundtruth.txt")
    np.testing.assert_allclose(np.loadtxt(port / "groundtruth.txt"), gj,
                               atol=2e-6, rtol=0)
    for sub, share in (("rgb", 0.01), ("depth", 0.01)):
        for f in sorted(os.listdir(ref / sub)):
            a = jnative.png_read(str(ref / sub / f))
            b = tnative.png_read(str(port / sub / f))
            assert a.dtype == b.dtype and a.shape == b.shape
            d = np.abs(a.astype(np.int64) - b.astype(np.int64))
            assert d.max() <= 1 and (d > 0).mean() <= share


def test_tum_sequence_frames(datasets):
    """Frames of the reference's dataset: the port's tensors equal the
    reference's arrays, through `frame` and through the prefetcher."""
    root = str(datasets / "ref")
    j = jtum.TumSequence(root)
    t = ttum.TumSequence(root, device="cpu")
    assert len(t) == len(j) == 4
    np.testing.assert_array_equal(t.timestamps, j.timestamps)
    fetched, jfetched = list(t.prefetch()), list(j.prefetch())
    for i in range(len(j)):
        jg, jd = j.frame(i)
        tg, td = t.frame(i)
        assert tg.dtype == torch.float32 and tg.device.type == "cpu"
        np.testing.assert_array_equal(tg.numpy(), jg)
        np.testing.assert_array_equal(td.numpy(), jd)
        # the C++ prefetcher scales depth its own way: compare like with
        # like
        for a, b in zip(fetched[i], jfetched[i]):
            np.testing.assert_array_equal(
                a.numpy() if torch.is_tensor(a) else a, b)
        assert fetched[i][3].dtype == torch.uint8


def _boxes(cls, xyxy, valid):
    arrays = dict(xyxy=np.asarray(xyxy, np.float32),
                  cls=np.asarray([7] * len(valid), np.int32),
                  score=np.full(len(valid), 0.9, np.float32),
                  valid=np.asarray(valid))
    if cls is JBoxes:
        return JBoxes(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return TBoxes(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def test_viz_overlays_match_reference(tmp_path):
    rng = np.random.default_rng(2)
    gray = rng.uniform(size=(120, 160)).astype(np.float32)
    xy = rng.uniform([0, 0], [160, 120], size=(64, 2)).astype(np.float32)
    valid, culled = rng.uniform(size=64) < 0.7, rng.uniform(size=64) < 0.5
    boxes = ([[10, 10, 60, 90], [-5, 20, 200, 130]], [True, True])
    j = jviz.draw_frame(gray, xy, valid, culled,
                        person_boxes=_boxes(JBoxes, *boxes),
                        object_boxes=_boxes(JBoxes, *boxes))
    t = tviz.draw_frame(torch.from_numpy(gray), torch.from_numpy(xy),
                        torch.from_numpy(valid), torch.from_numpy(culled),
                        person_boxes=_boxes(TBoxes, *boxes),
                        object_boxes=_boxes(TBoxes, *boxes))
    np.testing.assert_array_equal(t, j)
    lo = rng.normal(size=(32, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        tviz.occupancy_to_image(torch.from_numpy(lo)),
        jviz.occupancy_to_image(lo))

    jm, _ = jck.load_map(EVAL_MAP)
    tm = convert.map_from_numpy({f.name: np.asarray(getattr(jm, f.name))
                                 for f in dataclasses.fields(jm)})
    traj = np.asarray(jm.kf_pose)[np.asarray(jm.kf_valid)][:20]
    np.testing.assert_array_equal(
        tviz.draw_map_topdown(tm, size=128, trajectory_cw=traj),
        jviz.draw_map_topdown(jm, size=128, trajectory_cw=traj))
    tviz.save_frame(str(tmp_path / "f.png"), gray, xy, valid)
    assert tnative.png_read(str(tmp_path / "f.png")).shape == (120, 160, 3)


def test_live_viewer_round_trip():
    """tests/test_viewer.py's round trip on the port's viewer (127.0.0.1,
    a free port)."""
    from sgslam_tpu_torch.mapstate import mapstate as tms

    v = LiveViewer(port=0, every=1).start()
    try:
        gray = torch.rand(120, 160, generator=torch.Generator().manual_seed(0))
        v.publish_frame(gray, xy=torch.tensor([[10.0, 10.0], [50.0, 60.0]]),
                        valid=torch.tensor([True, True]))
        v.publish_map(tms.empty_map(tcfg.MapCapacity(max_keyframes=8,
                                                     max_points=128), 64))
        v.publish_occupancy(torch.zeros(32, 32))
        v.publish_stats(frame=7, state="OK")
        base = f"http://127.0.0.1:{v.port}"
        assert b"sgslam_tpu" in urllib.request.urlopen(
            f"{base}/", timeout=10).read()
        for ep in ("frame.png", "map.png", "occ.png"):
            data = urllib.request.urlopen(f"{base}/{ep}", timeout=10).read()
            assert data.startswith(PNG_MAGIC), ep
        stats = json.loads(urllib.request.urlopen(
            f"{base}/stats.json", timeout=10).read())
        assert stats == {"frame": 7, "state": "OK"}
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope.png", timeout=10)
        assert e.value.code == 404
    finally:
        v.stop()


def _reference_summary_keys():
    """The keys of the two summary dicts of sgslam_tpu/run_tum.py, read
    from its source: {function name: [keys]}."""
    tree = ast.parse(open(jrun.__file__).read())
    out = {}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in ("main",
                                                           "_run_chunked"):
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Dict)
                        and node.targets[0].id == "result"):
                    out[fn.name] = [k.value for k in node.value.keys]
    return out


def test_run_tum_cpu(tmp_path, monkeypatch):
    """`run_tum.main` on the CPU: a 24-frame synthetic dataset, per frame
    (with the overlay export and a saved map), then chunked in
    localization-only mode on that map; each prints the reference's
    summary keys."""
    monkeypatch.setattr(tcfg, "synthetic_config", functools.partial(
        tcfg.synthetic_config, 320, 240, **SMALL))
    keys = _reference_summary_keys()
    seq, out, viz_dir = (str(tmp_path / d) for d in ("seq", "out", "viz"))
    ckpt = str(tmp_path / "map.npz")
    common = ["--synthetic", str(N_CLI), "--seq-dir", seq, "--no-semantic",
              "--no-mapping", "--cpu"]
    r1 = trun.main(common + ["--out", out, "--viz", viz_dir, "--viz-every",
                             "8", "--save-map", ckpt])
    assert list(r1) == keys["main"]
    assert r1["frames"] == N_CLI and r1["state"] == "OK"
    assert r1["ate_rmse_m"] is not None and r1["ate_rmse_m"] < 0.06, r1
    traj = np.loadtxt(os.path.join(out, "CameraTrajectory.txt"))
    assert traj.shape == (N_CLI, 8)
    # the exporter drops a frame rather than stall tracking
    written = set(os.listdir(viz_dir))
    assert "map_topdown.png" in written and len(written) >= 2
    assert written <= {"frame_000000.png", "frame_000008.png",
                       "frame_000016.png", "map_topdown.png"}
    assert os.path.exists(ckpt)

    r2 = trun.main(common + ["--out", str(tmp_path / "out2"), "--chunked",
                             "--load-map", ckpt, "--localize-only"])
    assert list(r2) == keys["_run_chunked"]
    assert r2["frames"] == N_CLI and r2["state"] == "OK"
    assert r2["keyframes"] == r1["keyframes"]      # the map stays frozen
    assert r2["ate_rmse_m"] is not None and r2["ate_rmse_m"] < 0.06, r2
