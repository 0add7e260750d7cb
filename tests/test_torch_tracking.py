"""The slice end to end: the JAX `Tracker` and the port's `Tracker` (CPU)
track the same 30 JAX-rendered frames with the back-end switched off
(`local_ba_every` larger than the run).

When each package extracts its own features, the two are not
bit-identical: pyramid levels 1-7 differ by f32 ulps, which reorders tied
keypoints (test_torch_orb.py), so match tie-breaks, inlier counts and
poses move a little. States and keyframe decisions must agree; the rest is
held to the tolerances below, set from this run's measured gaps
(ROADMAP.md, "Faults found in the port"). Given the same (JAX-extracted)
features, the two trackers agree to f32 rounding (`test_same_features_*`).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.eval import ate as jate
from sgslam_tpu.geometry import se3 as jse3
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.slam import tracking as jtr
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch import convert
from sgslam_tpu_torch.eval import ate as tate
from sgslam_tpu_torch.slam import tracking as ttr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the test workers share
    the host's cores (with torch's default threads, test_torch_tracking.py
    took 524 s in the 6-worker suite; with one, 39 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_FRAMES = 30
NO_BACKEND = 10 ** 9
# per-frame inlier counts: a few tie-broken matches either way (measured
# at most 4, i.e. 2.6%, over the 29 tracked frames)
INLIER_TOL_ABS, INLIER_TOL_REL = 5, 0.03
# poses, translation in m: measured median 0.003 m, at most 0.0172 m (one
# frame; 0.0091 m the frame before, the rest below 0.0063 m); both runs are
# 0.015-0.037 m from ground truth at those two frames, so this is the
# estimator's own sensitivity to f32 rounding, not a drift
TOL_T = 0.025
# quaternion entries: measured at most 2.5e-3
TOL_Q = 5e-3
ATE_GATE = 0.05     # the same gate as test_slam_e2e.py
# |ATE(port) - ATE(JAX)|: measured 0.0002 m
TOL_ATE_DIFF = 0.005


def _cfg(c):
    return c.synthetic_config(
        width=320, height=240,
        orb=c.OrbConfig(n_features=600, max_keypoints=640),
        capacity=c.MapCapacity(max_keyframes=64, max_points=8192,
                               local_window=4, local_points=1024))


JCFG, TCFG = _cfg(jcfg), _cfg(tcfg)


def _run(tracker, frames):
    states, kf_frames = [], []
    for i, (gray, depth) in enumerate(frames):
        tracker.process(gray, depth)
        states.append(tracker.state)
        if tracker.kf_inserted:
            kf_frames.append(i)
    return states, kf_frames


@pytest.fixture(scope="module")
def runs():
    seq = jsyn.SyntheticSequence(JCFG.camera, n_frames=N_FRAMES)
    frames = [tuple(np.array(x) for x in seq.frame(i))
              for i in range(N_FRAMES)]
    gt_wc = np.stack([np.asarray(seq.gt_pose_wc(i)) for i in range(N_FRAMES)])

    tj = jtr.Tracker(JCFG, local_ba_every=NO_BACKEND)
    sj, kj = _run(tj, [(jnp.asarray(g), jnp.asarray(d)) for g, d in frames])
    tt = ttr.Tracker(TCFG, local_ba_every=NO_BACKEND, device="cpu")
    st, kt = _run(tt, frames)

    cw_j, cw_t = tj.poses_cw(), tt.poses_cw()
    wc_j = np.stack([np.asarray(jse3.se3_inverse(jnp.asarray(p)))
                     for p in cw_j])
    wc_t = np.stack([np.asarray(jse3.se3_inverse(jnp.asarray(p)))
                     for p in cw_t])
    ate_j = jate.ate_rmse(wc_j, gt_wc)[0]
    ate_t = tate.ate_rmse(wc_t, gt_wc)[0]
    print(f"tracking slice ATE: JAX {ate_j:.5f} m, port {ate_t:.5f} m; "
          f"keyframes at {kj} / {kt}; min inliers "
          f"{min(tj.n_inliers_hist)} / {min(tt.n_inliers_hist)}")
    return dict(jax=(tj, sj, kj, cw_j, ate_j), port=(tt, st, kt, cw_t, ate_t))


def test_states_and_keyframes_identical(runs):
    tj, sj, kj, _, _ = runs["jax"]
    tt, st, kt, _, _ = runs["port"]
    assert st == sj
    assert kt == kj
    assert tt.n_kf == tj.n_kf >= 2
    assert int(tt.map.next_kf) == int(tj.map.next_kf)


def test_inlier_counts(runs):
    nj = np.array(runs["jax"][0].n_inliers_hist)
    nt = np.array(runs["port"][0].n_inliers_hist)
    assert nj.shape == nt.shape == (N_FRAMES - 1,)
    tol = np.maximum(INLIER_TOL_ABS, INLIER_TOL_REL * nj)
    assert (np.abs(nt - nj) <= tol).all(), np.stack([nj, nt])
    assert nt.min() > 30


def test_poses(runs):
    cw_j, cw_t = runs["jax"][3], runs["port"][3]
    np.testing.assert_allclose(cw_t[:, 4:7], cw_j[:, 4:7], atol=TOL_T, rtol=0)
    np.testing.assert_allclose(cw_t[:, :4], cw_j[:, :4], atol=TOL_Q, rtol=0)


def test_ate_gate(runs):
    ate_j, ate_t = runs["jax"][4], runs["port"][4]
    assert ate_t < ATE_GATE, ate_t
    assert ate_j < ATE_GATE, ate_j
    assert abs(ate_t - ate_j) < TOL_ATE_DIFF, (ate_t, ate_j)


@pytest.fixture(scope="module")
def same_features():
    """Both trackers, back-end off, on the same JAX-extracted features."""
    seq = jsyn.SyntheticSequence(JCFG.camera, n_frames=N_FRAMES)
    feats = [jtr.extract_frame(JCFG, *seq.frame(i)) for i in range(N_FRAMES)]
    tj = jtr.Tracker(JCFG, local_ba_every=NO_BACKEND)
    tt = ttr.Tracker(TCFG, local_ba_every=NO_BACKEND, device="cpu")
    kfs = ([], [])
    for i, f in enumerate(feats):
        arrays = {fl.name: np.asarray(getattr(f, fl.name))
                  for fl in dataclasses.fields(f)}
        tj.process(None, None, feats=f)
        tt.process(None, None, feats=convert.features_from_numpy(arrays))
        for tr, k in ((tj, kfs[0]), (tt, kfs[1])):
            if tr.kf_inserted:
                k.append(i)
    return tj, tt, kfs


def test_same_features_trackers_agree(same_features):
    """Without the pyramid in the comparison the two trackers hold the
    tolerances first asked of this slice: max(3, 2%) inliers and 5e-3 m.
    Measured: inliers identical, poses within 7.2e-7 m. (Before the port
    computed the predicted level with the reference's log polynomial,
    `mapstate/local_map._log_f32`, 35 of 256 levels flipped on frame 1 and
    the poses drifted up to 0.0105 m apart.)"""
    tj, tt, (kj, kt) = same_features
    assert kt == kj and len(kj) >= 2
    nj, nt = np.array(tj.n_inliers_hist), np.array(tt.n_inliers_hist)
    assert (np.abs(nt - nj) <= np.maximum(3, 0.02 * nj)).all(), (nj, nt)
    cw_j, cw_t = tj.poses_cw(), tt.poses_cw()
    np.testing.assert_allclose(cw_t[:, 4:7], cw_j[:, 4:7], atol=5e-3, rtol=0)
    np.testing.assert_allclose(cw_t[:, :4], cw_j[:, :4], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(tt.map.kf_obs_point.numpy(),
                                  np.asarray(tj.map.kf_obs_point))


def test_default_tracker_runs_backend():
    """With its defaults the port's `Tracker` runs the back-end pass after
    every keyframe from the second on, and `_maybe_compact` after every
    insertion, as the reference does."""
    gray, depth = (np.array(x) for x in jsyn.render_frame(
        JCFG.camera, jsyn.make_trajectory(N_FRAMES)[0]))
    cap = tcfg.MapCapacity(max_keyframes=6, max_points=8192,
                           local_window=4, local_points=1024)
    tr = ttr.Tracker(dataclasses.replace(TCFG, capacity=cap), device="cpu")
    assert tr.local_ba_every == 1
    stages = []
    tr.on_backend_stage = stages.append
    tr.process(gray, depth)                 # initialization: keyframe 1
    assert tr.n_kf == 1 and stages == [] and tr.compactions == 0
    feats = ttr.extract_frame(TCFG, gray, depth, device="cpu")
    for n_kf in (2, 3):
        tr.frame_id += TCFG.tracker.max_frames_between_kf  # force a keyframe
        tr.process(gray, depth, feats=feats)
        assert tr.n_kf == n_kf and tr.state == "OK"
    assert stages == 2 * ["begin", *ttr.BACKEND_STAGES]
    # 6 slots: from the second keyframe on, next_kf >= 6 - 4 compacts
    assert tr.compactions == 2
    assert int(tr.map.next_kf) == int(tr.map.kf_valid.sum())
