"""The port's stereo tracking paths against the JAX package's, at the
reference tests' sizes (320x240): `System.track_stereo` over
tests/test_mono_stereo.py's 24 frames, `ChunkedStereoTracker` over the
same walk, `ChunkedSemanticStereoTracker` over
tests/test_chunked_parity.py's 26 dynamic frames, and the stereo + mapper
guard. Both packages get the reference's rendered pairs; each extracts its
own features (pyramid levels 1-7 differ by f32 ulps, test_torch_orb.py),
and the port gets the reference's random draws replayed.

Whole runs are held to the reference's own spread, `python
tools/parity_spread.py stereo` (CPU; the reference with its images moved
by one ulp, seeds 0-3): `System.track_stereo` ends at ATE 0.0406-0.0502 m
against 0.0533 m unmoved (up to 0.0127 m from it), 3 keyframes;
`ChunkedStereoTracker` at 0.0735-0.0839 m against 0.0969 m (up to
0.0234 m), 6 keyframes; `ChunkedSemanticStereoTracker` at 0.0669-0.0859 m
against 0.0764 m (up to 0.0095 m), 8-9 keyframes. The port: 0.0549 m
(0.0016 m from the reference), 3 keyframes; 0.0845 m (0.0124 m), 6;
0.0794 m (0.0030 m), 9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.eval import ate as jate
from sgslam_tpu.geometry import se3 as jse3
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.models import detector as jdet
from sgslam_tpu.slam import scan_pipeline as jsp
from sgslam_tpu.slam.system import System as JSystem
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch.mapping.semantic_mapper import SemanticMapper
from sgslam_tpu_torch.models import detector as tdet
from sgslam_tpu_torch.slam import scan_pipeline as tsp
from sgslam_tpu_torch.slam.system import System as TSystem
from sgslam_tpu_torch.slam.tracking import Tracker


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(c, kf_every=None):
    tracker = ({} if kf_every is None else dict(tracker=c.TrackerConfig(
        max_frames_between_kf=kf_every, depth_threshold_factor=70.0)))
    return c.synthetic_config(
        width=320, height=240,
        orb=c.OrbConfig(n_features=600, max_keypoints=640),
        capacity=c.MapCapacity(max_keyframes=64, max_points=8192,
                               local_window=4, local_points=1024),
        **tracker)


# tests/test_mono_stereo.py's PIPE_CFG and tests/test_chunked_parity.py's
# CFG (a keyframe at least every 4 frames)
JPIPE, TPIPE = _cfg(jcfg), _cfg(tcfg)
JCHUNK, TCHUNK = _cfg(jcfg, 4), _cfg(tcfg, 4)
N_SYSTEM, N_SEMANTIC, CHUNK = 24, 26, 4
# how far the reference's moved runs end from its unmoved run (module
# docstring), rounded up; the reference tests' gates
SPREAD = {"system": 0.013, "chunked": 0.024, "semantic": 0.010}
SYSTEM_GATE, SEMANTIC_GATE = 0.06, 0.12


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


def stereo_frames(n, dynamic=False):
    """The reference's rendered (left, right) pairs of the room walk and
    the ground truth."""
    seq = jsyn.SyntheticSequence(JPIPE.camera, n_frames=n, dynamic=dynamic)
    pairs = [tuple(np.array(x) for x in seq.frame_stereo(i)[:2])
             for i in range(n)]
    return pairs, np.asarray(seq.poses)


def ate(poses_cw, gt_wc):
    wc = np.stack([np.asarray(jse3.se3_inverse(jnp.asarray(p)))
                   for p in poses_cw])
    return jate.ate_rmse(wc, gt_wc[:len(wc)])[0]


def run_system(s, pairs, to):
    for gl, gr in pairs:
        s.track_stereo(to(gl), to(gr))
    return s


def run_chunked(ct, pairs, to):
    i = 0
    while ct._carry is None:
        ct.bootstrap(to(pairs[i][0]), to(pairs[i][1]))
        i += 1
    while i + CHUNK <= len(pairs):
        chunk = pairs[i:i + CHUNK]
        ct.process_chunk(to(np.stack([p[0] for p in chunk])),
                         to(np.stack([p[1] for p in chunk])))
        i += CHUNK
    ct.flush()
    return ct


def jax_runs(pairs, dyn_pairs):
    """The three reference runs (module docstring)."""
    to = jnp.asarray
    s = run_system(JSystem(JPIPE, enable_semantic=False, enable_mapping=False,
                           enable_loop=False), pairs, to)
    c = run_chunked(jsp.ChunkedStereoTracker(JCHUNK, chunk=CHUNK,
                                             fetch_every=2), pairs, to)
    sem = run_chunked(jsp.ChunkedSemanticStereoTracker(
        JCHUNK, jdet.Detector2D(JCHUNK.detector), chunk=CHUNK,
        fetch_every=2), dyn_pairs, to)
    return {"system": s, "chunked": c, "semantic": sem}


def port_runs(pairs, dyn_pairs):
    to = torch.from_numpy
    s = run_system(TSystem(TPIPE, enable_semantic=False, enable_mapping=False,
                           enable_loop=False, device="cpu"), pairs, to)
    c = run_chunked(tsp.ChunkedStereoTracker(
        TCHUNK, chunk=CHUNK, fetch_every=2, device="cpu", keys=JaxKeys()),
        pairs, to)
    sem = run_chunked(tsp.ChunkedSemanticStereoTracker(
        TCHUNK, tdet.Detector2D(TCHUNK.detector, device="cpu"), chunk=CHUNK,
        fetch_every=2, device="cpu", sampler=Replay(3), keys=JaxKeys()),
        dyn_pairs, to)
    return {"system": s, "chunked": c, "semantic": sem}


def summary(run):
    """(poses, keyframes, inlier counts) of a run of either package's
    System or chunked runner."""
    tr = getattr(run, "tracker", run)
    poses = tr.poses_cw()
    return poses, int(np.asarray(tr.n_kf)), run.n_inliers_hist if hasattr(
        run, "n_inliers_hist") else tr.n_inliers_hist


@pytest.fixture(scope="module")
def runs():
    pairs, gt = stereo_frames(N_SYSTEM)
    dyn_pairs, dyn_gt = stereo_frames(N_SEMANTIC, dynamic=True)
    gts = {"system": gt, "chunked": gt, "semantic": dyn_gt}
    return gts, jax_runs(pairs, dyn_pairs), port_runs(pairs, dyn_pairs)


@pytest.mark.parametrize("path", ["system", "chunked", "semantic"])
def test_stereo_path_matches_reference(runs, path):
    gts, jr, tr = runs
    jposes, jkf, _ = summary(jr[path])
    tposes, tkf, inliers = summary(tr[path])
    assert len(tposes) == len(jposes)
    ja, ta = ate(jposes, gts[path]), ate(tposes, gts[path])
    assert abs(ta - ja) <= SPREAD[path], (ta, ja)
    assert abs(tkf - jkf) <= 1 and tkf >= 2
    if path == "system":
        assert tr[path].state == "OK" and ta < SYSTEM_GATE
    if path == "semantic":
        assert ta < SEMANTIC_GATE
        assert sorted(inliers)[len(inliers) // 2] >= 30


def test_stereo_system_marks_stages():
    """`track_stereo` calls `on_stage` after each of its stages, the
    features it tracks carry SAD-search depth, and `Tracker.process_stereo`
    does what it does on a first frame."""
    pairs, _ = stereo_frames(3)
    s = TSystem(TPIPE, enable_semantic=False, enable_mapping=False,
                device="cpu")
    names = []
    s.on_stage = names.append
    run_system(s, pairs[:2], torch.from_numpy)
    assert names[:6] == ["begin", "detector", "extract", "cull", "track",
                         "loop_closing"]
    assert int((s.last_feats.depth > 0).sum()) > 200
    # the Tracker's own stereo entry point initializes on the same pair
    tr = Tracker(TPIPE, device="cpu")
    np.testing.assert_array_equal(tr.process_stereo(
        *(torch.from_numpy(x) for x in pairs[0])), s.tracker.trajectory[0])
    assert tr.state == "OK" and tr.n_kf == 1


def test_stereo_mapper_guard():
    """tests/test_chunked_parity.py::test_stereo_mapper_guard: the stereo
    chunk carries the right image where RGB-D carries depth; handing it
    to the SemanticMapper is refused."""
    with pytest.raises(ValueError, match="right image"):
        tsp.ChunkedStereoTracker(TCHUNK, mapper=SemanticMapper(
            TCHUNK, device="cpu"), device="cpu")
