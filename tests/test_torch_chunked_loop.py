"""The chunked loop-closure fixture of tests/test_chunked_full_system.py
through both packages: 92 frames of the closed-room circuit at 320x240, a
progressive world drift injected after frame 66, `ChunkedTracker(chunk=4,
fetch_every=2, loop=LoopCloser)`; the port gets the reference's Sim3 / PnP
draws replayed.

The reference misses that file's own 1.6x gate here (its keyframe ATE goes
0.208 -> 0.274 m, VERDICT.md), so the gate is not the target. The fixture
is chaotic: with its images moved by one ulp the reference ends anywhere in
0.103-0.300 m of keyframe ATE (21 seeds, `python tools/parity_spread.py
chunk` and more seeds of it, CPU; ROADMAP section 3), closing on keyframe
pairs (23, 2), (24, 2), (24, 0), (25, 2) or (25, 3). The port, one torch
thread, closes the unmoved reference's pair (23, 2) and ends at 0.098 m,
below the reference's lowest seed; with three torch threads it closes no
loop and ends at 0.174 m. The correction itself agrees on identical inputs
(test_torch_loop_closing.py). So the port is held to what is stable: the
pre-closure state within the reference's spread, a closure, and a result
no worse than the reference's worst one-ulp run.
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
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.slam import loop_closing as jlc
from sgslam_tpu.slam import scan_pipeline as jsp
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch.geometry import se3 as tse3
from sgslam_tpu_torch.slam import loop_closing as tlc
from sgslam_tpu_torch.slam import scan_pipeline as tsp


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
DRIFT_XI = np.array([0.66, 0.0, 0.30, 0.0, 0.18, 0.0], np.float32)
N_LOOP, N_PHASE1, LOOPS, CHUNK = 92, 66, 1.15, 4
# the reference's one-ulp runs (module docstring): the drifted keyframe
# ATE moves by up to 0.052 m (0.156-0.232 against 0.208, 3 seeds); the
# final keyframe ATE reaches 0.300 m and the trajectory ATE 0.290 m
TOL_DRIFTED = 0.052
WORST_KF_ATE = 0.300
WORST_TRAJ_ATE = 0.290


def replay_draws(seed, n_valid, iters, k):
    r = jax.random.randint(jax.random.PRNGKey(int(seed)), (iters, k), 0,
                           max(int(n_valid), k))
    return torch.from_numpy(np.asarray(r).astype(np.int64))


def _drift(K, n_kf):
    frac = np.clip(np.arange(K, dtype=np.float32) / max(n_kf - 1, 1), 0, 1)
    return frac[:, None] * DRIFT_XI[None, :]


def _inject(ct, port: bool):
    """test_chunked_full_system.py's injection, on either package."""
    ct.flush()
    m = ct._map
    n_kf = int(m.next_kf)
    xi = _drift(m.max_kf, n_kf)
    if port:
        D = tse3.se3_exp(torch.from_numpy(xi))
        new = tse3.se3_compose(m.kf_pose, tse3.se3_inverse(D))
        ct._map = tlc._apply_correction(m, m.kf_pose, new)
        Tcw = tse3.se3_compose(ct._carry.Tcw, tse3.se3_inverse(D[n_kf - 1]))
        ref = ct._map.kf_pose[ct._ref_slot].numpy()
    else:
        D = jax.vmap(jse3.se3_exp)(jnp.asarray(xi))
        new = jax.vmap(lambda T, d: jse3.se3_compose(
            T, jse3.se3_inverse(d)))(m.kf_pose, D)
        ct._map = jlc._apply_correction(m, m.kf_pose, new)
        Tcw = jse3.se3_compose(ct._carry.Tcw, jse3.se3_inverse(D[n_kf - 1]))
        ref = np.asarray(ct._map.kf_pose[ct._ref_slot])
    ct._carry = dataclasses.replace(ct._carry, Tcw=Tcw)
    if ct._ref_slot >= 0:
        ct._ref_pose_ins = ref


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _kf_ate(m, gt):
    v = _np(m.kf_valid)
    est = np.stack([np.asarray(jse3.se3_inverse(jnp.asarray(p)))
                    for p in _np(m.kf_pose)[v]])
    return jate.ate_rmse(est, gt[_np(m.kf_frame_id)[v]])[0]


def run_chunked_loop(ct, frames, gt, port: bool):
    to = torch.from_numpy if port else jnp.asarray
    stack = torch.stack if port else jnp.stack
    i = 0
    while ct._carry is None:
        ct.bootstrap(to(frames[i][0]), to(frames[i][1]))
        i += 1
    clean = None
    for stop in (N_PHASE1, N_LOOP):
        while i + CHUNK <= stop:
            ct.process_chunk(stack([to(f[0]) for f in frames[i:i + CHUNK]]),
                             stack([to(f[1]) for f in frames[i:i + CHUNK]]))
            i += CHUNK
        if clean is None:
            clean = ct.loops_closed
            _inject(ct, port)
            drifted = _kf_ate(ct._map, gt)
    ct.flush()
    est = ct.poses_cw()
    wc = np.stack([np.asarray(jse3.se3_inverse(jnp.asarray(p))) for p in est])
    return dict(clean=clean, drifted=drifted, final=_kf_ate(ct.map, gt),
                traj=jate.ate_rmse(wc, gt[:len(wc)])[0],
                loops=ct.loops_closed, pairs=list(ct.loop.loops_closed),
                n=len(est))


@pytest.fixture(scope="module")
def runs():
    poses = jsyn.make_circuit_trajectory(N_LOOP, loops=LOOPS)
    seq = jsyn.SyntheticSequence(JCFG.camera, n_frames=N_LOOP,
                                 planes=jsyn.ROOM_CLOSED, poses=poses)
    frames = [tuple(np.array(x) for x in seq.frame(i))
              for i in range(N_LOOP)]
    gt = np.asarray(poses)
    rj = run_chunked_loop(
        jsp.ChunkedTracker(JCFG, chunk=CHUNK, fetch_every=2,
                           loop=jlc.LoopCloser(JCFG)), frames, gt, False)
    rt = run_chunked_loop(
        tsp.ChunkedTracker(TCFG, chunk=CHUNK, fetch_every=2,
                           loop=tlc.LoopCloser(TCFG, device="cpu",
                                               draws=replay_draws),
                           device="cpu"), frames, gt, True)
    print({"jax": rj, "port": rt})
    return rj, rt


def test_chunked_loop_closes_like_the_reference(runs):
    rj, rt = runs
    assert rj["clean"] == rt["clean"] == 0
    assert rj["loops"] >= 1 and rt["loops"] >= 1
    assert abs(rt["drifted"] - rj["drifted"]) < TOL_DRIFTED, (rt, rj)
    assert rt["n"] == rj["n"] == N_LOOP - 3      # three frames left over


def test_chunked_loop_within_reference_spread(runs):
    """Keyframe ATE after the correction and the retro-corrected
    trajectory's ATE no worse than the reference's worst one-ulp run, and
    better than the drifted map."""
    rj, rt = runs
    assert rt["final"] < min(WORST_KF_ATE, rt["drifted"]), rt
    assert rt["traj"] < WORST_TRAJ_ATE, rt
    assert rj["final"] < WORST_KF_ATE and rj["traj"] < WORST_TRAJ_ATE
