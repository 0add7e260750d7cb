"""`sgslam_tpu_torch/bench_kernels.py` against `tools/bench_kernels.py`.

- The seeded problems: the reference tool's draws from
  `numpy.random.default_rng(0)`, made here in the tool's order through the
  JAX package (`local_ba.BAProblem`, `jnp.asarray` casts, `render_frame`)
  as the tool makes them, against the port's `make_problems`: integers
  exactly, floats within 1e-5. The ORB input is not drawn but rendered at
  the identity pose, where the optical axis runs along the room's and
  cell edges fall on exact coordinates: the 43758x texture hash flips
  whole cells on an ulp (tests/test_torch_synthetic.py). The share of
  pixels beyond that file's 2.5e-3 must stay within the reference's own
  share when its camera moves by 1e-7 m (measured: the port 1.2%, the
  reference against itself 3.0%). The calibration draws are made and
  dropped on both sides (the tool's 4096^2 and 64 x 1024^2 normals), so
  the later problems show that the port draws them in the tool's order;
  `_normal` itself gives the numbers of one draw, bf16 as JAX rounds them.
- The work counts: hand counts of the port's formulation (the bf16 GEMM,
  the stream, K1's tensor-core operations and bytes, the pose graph's LU,
  the extraction's resize matmuls and per-pixel operations on a 2-level
  40x30 pyramid); the fused search K1s's row is bound by
  `ops.hamming_search.search_bound` on its own input.
- `main(["--cpu", ...])` at a tiny size: the table labelled "cpu", no
  share stated on the CPU, the BA row "not counted", K2's row not ported
  and untimed, one JSON line naming the file.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.optim import local_ba as jba
from sgslam_tpu_torch import bench_kernels as bk
from sgslam_tpu_torch import config
from sgslam_tpu_torch.ops import hamming_cuda as hc
from sgslam_tpu_torch.ops import hamming_search as hs
from sgslam_tpu_torch.ops.search_cases import search_args, search_case

TOL = 1e-5
TOL_GRAY = 2.5e-3       # tests/test_torch_synthetic.py
NUDGE_M = 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_problems():
    """tools/bench_kernels.py's problems, in its order of draws. The
    calibration normals are drawn and dropped (the 64 x 1024^2 stream one
    slab at a time: the same numbers as one draw, see
    test_normal_is_one_draw)."""
    cfg = jcfg.synthetic_config(width=640, height=480)
    cam = cfg.camera
    rng = np.random.default_rng(0)
    M = 4096
    rng.standard_normal((M, M))
    rng.standard_normal((M, M))
    for _ in range(64):
        rng.standard_normal((1024, 1024))
    g0, _ = jsyn.render_frame(cam, jnp.asarray([1.0, 0, 0, 0, 0, 0, 0],
                                               jnp.float32))
    nudged, _ = jsyn.render_frame(cam, jnp.asarray(
        [1.0, 0, 0, 0, NUDGE_M, 0, 0], jnp.float32))
    d1 = jnp.asarray(rng.integers(0, 2 ** 32, (4096, 8)), jnp.uint32)
    d2 = jnp.asarray(rng.integers(0, 2 ** 32, (1024, 8)), jnp.uint32)
    C, N, P = 24, 1024, 4096
    pose0 = jnp.tile(jnp.asarray([1.0, 0, 0, 0, 0, 0, 0], jnp.float32),
                     (C, 1))
    pts = jnp.asarray(rng.uniform(-2, 2, (P, 3)), jnp.float32)
    pts = pts.at[:, 2].add(3.0)
    obs_pt = jnp.asarray(rng.integers(0, P, (C, N)), jnp.int32)
    uvr = jnp.asarray(rng.uniform(0, 480, (C, N, 3)), jnp.float32)
    w = jnp.ones((C, N), jnp.float32)
    prob = jba.BAProblem(
        poses=pose0, opt_mask=jnp.ones(C, bool).at[0].set(False),
        points=pts, obs_pt=obs_pt, obs_uvr=uvr, obs_w=w)
    Kk, E = 256, 1024
    pg = {"poses": jnp.tile(jnp.asarray([1.0, 0, 0, 0, 0, 0, 0, 1.0],
                                        jnp.float32), (Kk, 1)),
          "edge_i": jnp.asarray(rng.integers(0, Kk, E), jnp.int32),
          "edge_j": jnp.asarray(rng.integers(0, Kk, E), jnp.int32),
          "edge_meas": jnp.tile(jnp.asarray([1.0, 0, 0, 0, 0, 0, 0, 1.0],
                                            jnp.float32), (E, 1)),
          "edge_weight": jnp.ones(E, jnp.float32),
          "pose_valid": jnp.ones(Kk, bool),
          "fixed_mask": jnp.zeros(Kk, bool).at[0].set(True)}
    return cfg, {"gray": g0, "nudged": nudged, "d1": d1, "d2": d2,
                 "ba": prob, "pose_graph": pg}


def _assert_same(got, want, name):
    got = got.cpu().numpy()
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_problems_match_the_tool():
    jc, ref = _reference_problems()
    cfg = bk.make_config()
    assert (bk.GEMM_N, bk.STREAM_SHAPE, bk.DESC_ROWS) == (
        4096, (64, 1024, 1024), (4096, 1024))
    assert (bk.BA_C, bk.BA_N, bk.BA_P, bk.PG_K, bk.PG_E, bk.PG_ITERS) == (
        24, 1024, 4096, 256, 1024, 40)
    assert (cfg.tracker.local_ba_iters1, cfg.tracker.local_ba_iters2) == (
        jc.tracker.local_ba_iters1, jc.tracker.local_ba_iters2)
    got = bk.make_problems(cfg, "cpu", calibration=False)
    assert got["gemm_a"] is None and got["stream"] is None
    share = (np.abs(got["gray"].numpy() - np.asarray(ref["gray"]))
             > TOL_GRAY).mean()
    own = (np.abs(np.asarray(ref["nudged"]) - np.asarray(ref["gray"]))
           > TOL_GRAY).mean()
    assert share <= own, (share, own)
    for key in ("d1", "d2"):
        _assert_same(got[key], ref[key], key)
    for field in ("poses", "opt_mask", "points", "obs_pt", "obs_uvr",
                  "obs_w"):
        _assert_same(getattr(got["ba"], field), getattr(ref["ba"], field),
                     f"ba.{field}")
    for key, want in ref["pose_graph"].items():
        _assert_same(got["pose_graph"][key], want, f"pose_graph.{key}")


def test_normal_is_one_draw():
    want = np.random.default_rng(5).standard_normal((3, 4, 5))
    got = bk._normal(np.random.default_rng(5), (3, 4, 5), "cpu",
                     torch.float32, True)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    got = bk._normal(np.random.default_rng(5), (3, 4, 5), "cpu",
                     torch.bfloat16, True)
    ref = jnp.asarray(want, jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref))


def test_work_counts_are_the_hand_counts():
    cfg = bk.make_config()
    c = bk.work_counts(cfg)
    assert c["calibration_bf16_gemm"] == {
        "ops": 2 * 4096 ** 3, "peak": "bf16_flops",
        "bytes": 3 * 4096 * 4096 * 2}
    assert c["calibration_stream"]["bytes"] == 2 * 64 * 1024 * 1024 * 4
    assert c["hamming_k1_4096x1024"] == {
        "ops": 2 * 4096 * 1024 * 256, "peak": "int8_ops",
        "bytes": (4096 + 1024) * 32 + 4096 * 1024 * 4}
    n = 7 * 256
    pg = c["pose_graph_K256_E1024_40it"]
    assert pg["ops"] == 40 * 2 * n ** 3 // 3 and pg["peak"] == "fp32_flops"
    assert pg["bytes"] == 40 * 2 * n * n * 4
    assert not any(k.startswith("local_ba") for k in c)
    # a 2-level pyramid of a 40x30 image at scale 1.2: level 1 is 33x25;
    # its resize = 2*25*30*40 + 2*25*40*33 flops; 321 FAST + 11 NMS + 1
    # mask + 28 blur operations on each of 1200 + 825 pixels
    tiny = config.synthetic_config(
        width=40, height=30, orb=config.OrbConfig(n_levels=2))
    assert bk.orb_ops(tiny) == (2 * 25 * 30 * 40 + 2 * 25 * 40 * 33
                                + (321 + 11 + 1 + 28) * (1200 + 825))
    # K1 on the tensor-core route: its [n, m] output's bytes bound it
    b, by = bk.bound_ms(c["hamming_k1_4096x1024"])
    assert by == "bytes" and b == pytest.approx(
        ((4096 + 1024) * 32 + 4096 * 1024 * 4) / 3.35e12 * 1e3)
    assert b == pytest.approx(hc.hamming_bound(4096, 1024)[0])
    assert 5.05e-3 < b < 5.07e-3
    # the search's row is bound by what its own input needs, as
    # ops.hamming_search.search_bound counts it: every pair's window test
    # and the candidates' distances, below every pair's distance
    assert "hamming_search_4096x1024" not in c
    args = search_args(search_case(np.random.default_rng(0), 4096, 1024,
                                   edge=False), "cpu")
    b, by, n_cand = bk.search_row_bound(args)
    assert n_cand == int(hs.candidates(args[1], args[3], args[4]).sum())
    assert 0 < n_cand < 4096 * 1024 // 100
    assert by == "operations" and b == pytest.approx(
        hs.search_bound(4096, 1024, window=True, n_cand=n_cand)[0])
    assert b == pytest.approx((4096 * 1024 * 7 / 67e12
                               + 2 * n_cand * 256 / 1979e12) * 1e3)
    assert b < hs.search_bound(4096, 1024)[0]


def test_main_on_the_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(bk, "make_config", lambda: config.synthetic_config(
        width=160, height=120))
    for name, value in (("GEMM_N", 64), ("STREAM_SHAPE", (2, 64, 64)),
                        ("DESC_ROWS", (64, 32)), ("BA_C", 4), ("BA_N", 32),
                        ("BA_P", 64), ("PG_K", 8), ("PG_E", 16),
                        ("PG_ITERS", 2)):
        monkeypatch.setattr(bk, name, value)
    out = tmp_path / "kernels.json"
    assert bk.main(["--cpu", "--reps", "1", "--k", "1", "--out",
                    str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip())
    assert line["kernels"] == str(out) and line["device"] == "cpu"
    table = json.loads(out.read_text())
    assert table["device"] == "cpu" and "not a device" in table["method"]
    rows = table["kernels"]
    assert list(rows) == [
        "orb_extract_160x120_8lvl", "hamming_plain_64x32",
        "hamming_cdist_64x32", "hamming_search_64x32",
        "hamming_mxu_bitmatmul_64x32",
        "local_ba_C4_N32_P64_20it_budget", "pose_graph_K8_E16_2it"]
    assert "not_ported" in rows["hamming_mxu_bitmatmul_64x32"]
    assert rows["local_ba_C4_N32_P64_20it_budget"]["work"] == "not counted"
    for name, r in rows.items():
        assert "share_of_bound" not in r and "bound_ms" not in r, name
        if "ms" in r:
            assert np.isfinite(r["ms"]) and r["ms"] > 0, name
    assert table["calibration"]["bf16_gemm_tflops"] > 0


def test_cdist_on_unpacked_bits_is_k1s_function():
    """The library row computes K1's function: cdist(p=0) on the unpacked
    bits equals the plain version, and the bits pack back to the words."""
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.integers(0, 2 ** 32, (n, 8)).astype(
        np.uint32).view(np.int32)) for n in (37, 21))
    ba, bb = hc.unpack_bits(a), hc.unpack_bits(b)
    assert ba.shape == (37, 256) and set(ba.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(torch.cdist(ba, bb, p=0).round().to(torch.int32),
                       hc.hamming_matrix_reference(a, b))
    weights = 2 ** torch.arange(32, dtype=torch.int64)
    words = (ba.reshape(37, 8, 32).to(torch.int64) * weights).sum(-1)
    np.testing.assert_array_equal(
        words.numpy().astype(np.uint32).view(np.int32), a.numpy())
