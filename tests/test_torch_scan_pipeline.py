"""The port's chunked pipeline against the JAX package's.

  * one chunk function on the same map, carry and (JAX-extracted)
    features: identical keyframe flags and insertion indices, inliers
    within max(3, 2%), poses within 5e-3 m until an in-chunk back-end pass
    and within the reference's own one-ulp spread after it;
  * a `ChunkedTracker` run (with a tail chunk) at 320x240 on each
    package's own features and a `ChunkedSemanticTracker` run on the
    reference's features: identical keyframe frames, the reference's gates
    on both;
  * localization-only resume from the reference's checkpoint, and the
    stereo constructors' guards.

The port gets the reference's random draws replayed: `Replay` for the
bootstrap's per-frame cull, `JaxKeys` for the chunk's per-frame keys
(`jax.random.split` of the carried key, `randint` per cull).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.eval import ate as jate
from sgslam_tpu.geometry import se3 as jse3
from sgslam_tpu.io import checkpoint as jck
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.models import detector as jdet
from sgslam_tpu.slam import scan_pipeline as jsp
from sgslam_tpu.slam import tracking as jtr
from sgslam_tpu.slam.loop_closing import LoopCloser as JLoop
from sgslam_tpu.slam.system import System as JSystem
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch import convert
from sgslam_tpu_torch.models import detector as tdet
from sgslam_tpu_torch.slam import scan_pipeline as tsp
from sgslam_tpu_torch.slam import tracking as ttr
from sgslam_tpu_torch.slam.loop_closing import LoopCloser as TLoop


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(c):
    return c.synthetic_config(
        width=320, height=240,
        orb=c.OrbConfig(n_features=600, max_keypoints=640),
        tracker=c.TrackerConfig(max_frames_between_kf=4,
                                depth_threshold_factor=70.0),
        capacity=c.MapCapacity(max_keyframes=64, max_points=8192,
                               local_window=4, local_points=1024))


JCFG, TCFG = _cfg(jcfg), _cfg(tcfg)
CHUNK = 4
N = 23                     # leaves a 3-frame tail after the chunks
ATE_GATE = 0.06            # tests/test_chunked_parity.py's tail gate
# the reference's own spread on the two chunks of test_chunk_fn_same_
# features (python tools/parity_spread.py chunk, CPU): with its images
# moved by one ulp, keyframe flags stay equal and poses move by 0.0241,
# 0.0355 and 0.0418 m (inliers by 8-15); the port fed the reference's
# features: 0.0064 m, 1 inlier. Frames tracked after an in-chunk back-end
# pass are held to the smallest seed's gap; earlier frames to 5e-3 m.
TOL_AFTER_BA = 0.024


class Replay:
    """The JAX `SemanticFrontend`'s draws: PRNGKey(seed) split per cull."""

    def __init__(self, seed=3):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, n_valid, iters):
        self.key, sub = jax.random.split(self.key)
        r = jax.random.randint(sub, (iters, 8), 0, max(int(n_valid), 8))
        return torch.from_numpy(np.asarray(r).astype(np.int64))


class JaxKeys:
    """The reference chunk's keys: PRNGKey seeds, `split`, `randint`."""

    def seed(self, s):
        return jax.random.PRNGKey(s)

    def split(self, key, n):
        return list(jax.random.split(jnp.asarray(key), n))

    def draw(self, key, n_valid, iters, k):
        r = jax.random.randint(key, (iters, k), 0, max(int(n_valid), k))
        return torch.from_numpy(np.asarray(r).astype(np.int64))


def replay_draws(seed, n_valid, iters, k):
    r = jax.random.randint(jax.random.PRNGKey(int(seed)), (iters, k), 0,
                           max(int(n_valid), k))
    return torch.from_numpy(np.asarray(r).astype(np.int64))


def _tree_np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _tree_np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.array(x)


def _drive(ct, frames, to, stop):
    i = 0
    while ct._carry is None:
        ct.bootstrap(to(frames[i][0]), to(frames[i][1]))
        i += 1
    boot = i
    snapshot = (_tree_np(ct._map), _tree_np(ct._carry)) \
        if isinstance(ct, jsp._ChunkRunnerBase) else None
    stack = (lambda xs: jnp.stack(xs)) if to is jnp.asarray else \
        (lambda xs: torch.stack(xs))
    while i + CHUNK <= stop:
        ct.process_chunk(stack([to(f[0]) for f in frames[i:i + CHUNK]]),
                         stack([to(f[1]) for f in frames[i:i + CHUNK]]))
        i += CHUNK
    if i < stop:
        ct.process_tail(stack([to(f[0]) for f in frames[i:stop]]),
                        stack([to(f[1]) for f in frames[i:stop]]))
    ct.flush()
    return boot, snapshot


def _kf_frames(m):
    v = np.asarray(m.kf_valid.numpy() if torch.is_tensor(m.kf_valid)
                   else m.kf_valid)
    f = m.kf_frame_id
    return sorted(np.asarray(f.numpy() if torch.is_tensor(f) else f)[v]
                  .tolist())


def _ate(poses_cw, gt_wc):
    wc = np.stack([np.asarray(jse3.se3_inverse(jnp.asarray(p)))
                   for p in poses_cw])
    return jate.ate_rmse(wc, gt_wc[:len(wc)])[0]


@pytest.fixture(scope="module")
def geo():
    seq = jsyn.SyntheticSequence(JCFG.camera, n_frames=N)
    frames = [tuple(np.array(x) for x in seq.frame(i)) for i in range(N)]
    gt = np.stack([np.asarray(seq.gt_pose_wc(i)) for i in range(N)])
    cj = jsp.ChunkedTracker(JCFG, chunk=CHUNK, fetch_every=2,
                            loop=JLoop(JCFG))
    boot, snap = _drive(cj, frames, jnp.asarray, N)
    ct = tsp.ChunkedTracker(TCFG, chunk=CHUNK, fetch_every=2,
                            loop=TLoop(TCFG, device="cpu",
                                       draws=replay_draws),
                            device="cpu", keys=JaxKeys())
    _drive(ct, frames, torch.from_numpy, N)
    return dict(jax=cj, port=ct, frames=frames, gt=gt, boot=boot, snap=snap)


def reference_chunks(snap, frames, boot, move=None):
    """Two chunks of the reference's chunk function from a post-bootstrap
    (map, carry) snapshot; `move(x)` perturbs the gray and depth images.
    Returns (packed rows per chunk, the reference's features of each chunk
    as the port's `Features`)."""
    m_np, c_np = snap
    mj = jtr.ms.MapState(**{k: jnp.asarray(v) for k, v in m_np.items()})
    cj = jax.tree.map(jnp.asarray, jsp.TrackCarry(
        **{k: v for k, v in c_np.items()
           if k not in ("prev_feats", "prev_boxes")},
        prev_feats=jtr.orb.Features(**c_np["prev_feats"]),
        prev_boxes=jsp.Boxes(**c_np["prev_boxes"])))
    fn = jsp.make_track_chunk(JCFG)
    extract = jax.vmap(lambda g, d: jtr.extract_frame(JCFG, g, d))
    packed, fed = [], []
    for c in range(2):
        lo = boot + c * CHUNK
        g = jnp.stack([jnp.asarray(f[0]) for f in frames[lo:lo + CHUNK]])
        d = jnp.stack([jnp.asarray(f[1]) for f in frames[lo:lo + CHUNK]])
        if move is not None:
            g, d = move(g), move(d)
        fb = extract(g, d)
        mj, cj, pj, _, _, _ = fn(None, mj, cj, g, d)
        packed.append(np.asarray(pj))
        fed.append([convert.features_from_numpy(
            {k: np.asarray(v[j]) for k, v in _tree_np(fb).items()})
            for j in range(CHUNK)])
    return packed, fed


def port_chunks(snap, frames, boot, fed):
    queue = [f for chunk in fed for f in chunk]
    fn = tsp.make_track_chunk(TCFG, keys=JaxKeys(), device="cpu",
                              extract=lambda *_: queue.pop(0))
    mt = convert.map_from_numpy(snap[0])
    ct = convert.track_carry_from_numpy(snap[1])
    packed = []
    for c in range(2):
        lo = boot + c * CHUNK
        g = np.stack([f[0] for f in frames[lo:lo + CHUNK]])
        d = np.stack([f[1] for f in frames[lo:lo + CHUNK]])
        mt, ct, pt, _, _, _ = fn(mt, ct, g, d)
        packed.append(pt.numpy())
    return packed


def reference_extract(cfg, gray, depth, device):
    """The reference's features of a frame, as the port's `Features`."""
    f = jtr.extract_frame(JCFG, jnp.asarray(gray.numpy()),
                          jnp.asarray(depth.numpy()))
    return convert.features_from_numpy(_tree_np(f), device)


def test_chunk_fn_same_features(geo):
    """Two chunks from the reference's post-bootstrap map and carry, both
    packages fed the reference's features: identical keyframe flags and
    stats rows; inliers within max(3, 2%); poses within 5e-3 m up to the
    first in-chunk keyframe and, on frames tracked after a back-end pass,
    within the reference's own spread (TOL_AFTER_BA)."""
    pj_all, fed = reference_chunks(geo["snap"], geo["frames"], geo["boot"])
    pt_all = port_chunks(geo["snap"], geo["frames"], geo["boot"], fed)
    flagged = 0
    for pj, pt in zip(pj_all, pt_all):
        np.testing.assert_array_equal(pt[:, 8], pj[:, 8])      # kf flags
        np.testing.assert_array_equal(pt[-1, :5], pj[-1, :5])  # stats row
        inl_j, inl_t = pj[:-1, 7], pt[:-1, 7]
        assert (np.abs(inl_t - inl_j) <= np.maximum(3, 0.02 * inl_j)).all()
        # rows up to the first insertion of the first chunk met no BA
        pre = int(pj[-1, 3]) + 1 if flagged == 0 and pj[-1, 2] else CHUNK
        if flagged == 0:
            np.testing.assert_allclose(pt[:pre, 4:7], pj[:pre, 4:7],
                                       atol=5e-3)
        np.testing.assert_allclose(pt[:-1, 4:7], pj[:-1, 4:7],
                                   atol=TOL_AFTER_BA)
        flagged += int(pj[-1, 2])
    assert flagged >= 1, "no keyframe was inserted in-chunk"


def test_chunk_fn_reuses_a_kept_front_end(geo):
    """A `ChunkFront` that a chunk's first call filled stands in for the
    extraction and the detection of a second call over the same frames
    (the seam replay's): the same outputs to the bit, and the same marks,
    with no frame extracted and no batch detected again."""
    calls = {"extract": 0, "detect": 0}
    det = tdet.Detector2D(TCFG.detector, pretrained=False, device="cpu")
    detect = det.detect_batch

    def counted_detect(*a):
        calls["detect"] += 1
        return detect(*a)
    det.detect_batch = counted_detect

    def extract(cfg, gray, depth, device):
        calls["extract"] += 1
        return ttr.extract_frame(cfg, gray, depth, device)
    marks = []
    fn = tsp.make_track_chunk(TCFG, det, semantic=True, device="cpu",
                              on_stage=marks.append, extract=extract)
    lo = geo["boot"]
    g = np.stack([f[0] for f in geo["frames"][lo:lo + CHUNK]])
    d = np.stack([f[1] for f in geo["frames"][lo:lo + CHUNK]])
    front = tsp.ChunkFront()
    runs = []
    for want in ({"extract": CHUNK, "detect": 1},) * 2:
        del marks[:]
        out = fn(convert.map_from_numpy(geo["snap"][0]),
                 convert.track_carry_from_numpy(geo["snap"][1]), g, d,
                 None, front)
        assert calls == want
        assert len(front.feats) == CHUNK and len(front.boxes) == 3
        runs.append((_tree_np(out[0]), _tree_np(out[1].Tcw),
                     out[2].numpy(), _tree_np(out[3]), list(marks)))
    (m1, t1, p1, f1, k1), (m2, t2, p2, f2, k2) = runs
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(t1, t2)
    for k in m1:
        np.testing.assert_array_equal(m1[k], m2[k], err_msg=k)
    for k in f1:
        np.testing.assert_array_equal(f1[k], f2[k], err_msg=k)
    assert k1 == k2 and k1[:4] == ["begin", "extract", "detector", "cull"]


def test_chunked_tracker_matches(geo):
    """Identical keyframe frames; the tail is tracked; the reference's
    ATE gate holds for both."""
    cj, ct, gt = geo["jax"], geo["port"], geo["gt"]
    assert _kf_frames(ct.map) == _kf_frames(cj.map)
    assert ct.n_kf >= 3
    pj, pt = cj.poses_cw(), ct.poses_cw()
    assert pt.shape == pj.shape == (N, 7)
    assert len(ct.lost_mask()) == N and not ct.lost_mask().any()
    for p in (pj, pt):
        assert _ate(p, gt) < ATE_GATE
    assert min(ct.n_inliers_hist) > 30


def test_chunked_semantic_tracker_matches():
    """The semantic runner (the port's detector batch, per-frame cull with
    the reference's keys, tracking, back-end) on the walking-person scene,
    both packages on the reference's features: identical keyframe frames,
    healthy tracking on both. (On its own features the port flags one
    keyframe fewer, on the last frame, where its inliers 147 against the
    reference's 145 sit on either side of 0.75 x the reference keyframe's
    count: the reference's own spread flips keyframe decisions too,
    ROADMAP section 3.)"""
    n = 18
    seq = jsyn.SyntheticSequence(JCFG.camera, n_frames=n, dynamic=True)
    frames = [tuple(np.array(x) for x in seq.frame(i)) for i in range(n)]
    gt = np.stack([np.asarray(seq.gt_pose_wc(i)) for i in range(n)])
    cj = jsp.ChunkedSemanticTracker(JCFG, jdet.Detector2D(JCFG.detector),
                                    chunk=CHUNK, fetch_every=2)
    _drive(cj, frames, jnp.asarray, n)
    ct = tsp.ChunkedSemanticTracker(
        TCFG, tdet.Detector2D(TCFG.detector, device="cpu"), chunk=CHUNK,
        fetch_every=2, device="cpu", sampler=Replay(3), keys=JaxKeys(),
        extract=reference_extract)
    _drive(ct, frames, torch.from_numpy, n)
    assert _kf_frames(ct.map) == _kf_frames(cj.map)
    for c in (cj, ct):
        assert len(c.poses_cw()) == n
        assert _ate(c.poses_cw(), gt) < 0.09      # the dynamic-scene gate
        assert sorted(c.n_inliers_hist)[len(c.n_inliers_hist) // 2] >= 30


def test_localization_only_resume_from_reference_checkpoint(tmp_path):
    """The reference maps 28 frames and saves a checkpoint; the port's
    chunked tracker reopens it in localization-only mode: the bootstrap
    relocalizes against the restored database, chunks track, no keyframe
    is added (test_chunked_parity.py's contract). The port's checkpoint
    reads back into the reference."""
    n = 40
    poses = jsyn.make_circuit_trajectory(n, loops=0.5)
    seq = jsyn.SyntheticSequence(JCFG.camera, n_frames=n,
                                 planes=jsyn.ROOM_CLOSED, poses=poses)
    frames = [tuple(np.array(x) for x in seq.frame(i)) for i in range(n)]
    s1 = JSystem(JCFG, enable_semantic=False, enable_mapping=False)
    for i in range(28):
        s1.track_rgbd(*map(jnp.asarray, frames[i]))
    path = str(tmp_path / "map.npz")
    s1.save_checkpoint(path)
    traj = s1.tracker.poses_cw()

    ct = tsp.ChunkedTracker(TCFG, chunk=CHUNK, fetch_every=2,
                            loop=TLoop(TCFG, device="cpu",
                                       draws=replay_draws),
                            only_tracking=True, device="cpu")
    ct.load_checkpoint(path)
    n_kf = int(ct.inner.map.next_kf)
    j = 8
    while ct._carry is None and j < 16:
        ct.bootstrap(*map(torch.from_numpy, frames[j]))
        j += 1
    assert ct._carry is not None, "never relocalized on the bootstrap"
    assert ct.relocs >= 1
    while j + CHUNK <= 28:
        ct.process_chunk(torch.stack([torch.from_numpy(f[0])
                                      for f in frames[j:j + CHUNK]]),
                         torch.stack([torch.from_numpy(f[1])
                                      for f in frames[j:j + CHUNK]]))
        j += CHUNK
    ct.flush()
    assert int(ct.map.next_kf) == n_kf
    est = ct.poses_cw()
    errs = [float(np.linalg.norm(est[-(k + 1)][4:7] - traj[j - 1 - k][4:7]))
            for k in range(4)]
    assert min(errs) < 0.05, errs

    ct.save_checkpoint(str(tmp_path / "port.npz"))
    m, extra = jck.load_map(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(extra["bow_db"], np.asarray(s1.loop.bow_db))
    np.testing.assert_array_equal(np.asarray(m.kf_pose),
                                  np.asarray(s1.tracker.map.kf_pose))


def test_stereo_constructors_raise():
    """The stereo runners are ported (tests/test_torch_stereo_system.py
    runs them): they build, and they raise only where the reference does,
    with a mapper (the right image is not a depth map) and, as every entry
    point, on a CUDA device where there is none."""
    det = tdet.Detector2D(TCFG.detector, pretrained=False, device="cpu")
    for ct in (tsp.ChunkedStereoTracker(TCFG, device="cpu"),
               tsp.ChunkedSemanticStereoTracker(TCFG, det, device="cpu")):
        assert ct.stereo and ct._extract is ttr.extract_frame_stereo
    assert callable(tsp.make_track_chunk(TCFG, stereo=True, device="cpu"))
    from sgslam_tpu_torch.mapping.semantic_mapper import SemanticMapper

    with pytest.raises(ValueError, match="right image"):
        tsp.ChunkedStereoTracker(TCFG, mapper=SemanticMapper(
            TCFG, device="cpu"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsp.ChunkedTracker(TCFG)              # default device: cuda
