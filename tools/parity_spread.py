#!/usr/bin/env python3
"""How far the JAX reference moves from itself, beside how far the port
moves from it: the yardstick for the back-end's parity tolerances.

    python tools/parity_spread.py ba|pass|tracker|capacity|main|cull|loop|chunk|reloc|stereo|init|mono [--seeds 3]
    python tools/parity_spread.py correction --dump DUMP.npz
    python tools/parity_spread.py eval --sequence NAME --path system|chunked [--seeds 3]

Runs on the CPU (JAX and the port's CPU path). Each mode runs the
reference once as it is, then `--seeds` times with one input moved by one
ulp (every element multiplied by 1 +- 2**-23, signs from a numpy seed),
and the port once, and prints the gaps:

  ba        bundle_adjust on the eval map's 16+8 window at its newest
            keyframe (input: the window's points); poses, inlier flips,
            and point gaps where both runs keep >= 2 inlier observations;
  pass      process_new_keyframe on the eval map, window 4+2, 1024 points
            (input: the map's points); poses;
  tracker   30 frames at 320x240, back-end on, a keyframe at least every 4
            frames, JAX-extracted features (input: keypoint coordinates);
            poses and inliers;
  capacity  tests/test_maintenance_live.py's 120-frame run (input:
            keypoint coordinates); ATE, and the port on its own features
            and on the reference's;
  main      chip_smoke.py's main path (640x480, 60 frames) through the
            reference, back-end on and off; ATE (no port run: its numbers
            come from the card);
  cull      the dynamic-feature cull: (a) `reject_dynamic_matched` on
            three frame pairs of tests/test_system_dynamic.py's sequence
            (JAX features and detector boxes; input: keypoint coordinates),
            keep-mask flips and F inlier counts, the port with the
            reference's RANSAC draws replayed; (b) `System` with the real
            detector over its 30 frames (input: the gray and depth images),
            keyframe frames, pose gaps and ATE, the port on its own
            features with the draws replayed;
  loop      the loop correction: (a) `global_ba_step` (10 iterations, loop
            pair pinned) on tests/test_torch_loop_components.py's perturbed
            map (input: the map's points), pose and point gaps; (b)
            `System` with loop closing over tests/test_loop_e2e.py's
            drifted circuit (input: the gray and depth images), the loop
            pair and the keyframe ATE after the correction, the port on
            its own features with the Sim3 / PnP draws replayed;
  chunk     the chunked pipeline: (a) two chunks of the chunk function
            from tests/test_torch_scan_pipeline.py's post-bootstrap state
            (input: the chunk's images), keyframe flags, inlier and pose
            gaps, the port fed the reference's features; (b)
            tests/test_chunked_full_system.py's 92-frame chunked loop
            fixture (input: the images), loops, keyframe ATE after the
            correction and whole-trajectory ATE, the port on its own
            features with the draws replayed;
  reloc     tests/test_chunked_full_system.py's chunked kidnap (input: the
            images): relocalizations and the last four frames' gaps to the
            map's own estimate (that test's gate: the smallest < 0.06 m),
            exported and as recorded; the port on its own features with
            the reference's draws replayed (and once with its default
            draws), on the same moved images as the reference.
  stereo    (a) `stereo_match` on four frame pairs of
            tests/test_torch_stereo.py's walk (input: both images), `ok`
            flips, u_right / depth gaps and keypoints that move to another
            disparity, the port on the same keypoints; (b) the stereo runs
            of tests/test_torch_stereo_system.py (`System.track_stereo`,
            `ChunkedStereoTracker`, `ChunkedSemanticStereoTracker`; input:
            both images), ATE and keyframes, the port on its own features
            with the draws replayed;
  init      `initialize_mono` on tests/test_mono_stereo.py's three
            problems (input: the match coordinates), ok / used_H / rh, T21,
            good flips and the good points' relative gaps, the port with
            the reference's draws replayed;
  mono      tests/test_mono_stereo.py's 30-frame `MonoTracker` run (input:
            the images), initialization frame, keyframes, points and
            Sim(3)-aligned ATE, the port on its own features and on the
            reference's, with the initialization draws replayed.
  correction  one loop correction's input as `tools/card_spread.py
            correction --dump` wrote it on the card (the port's map just
            before the correction, the pair, the Sim3, the loop edges):
            the reference's `LoopCloser._correct` and the port's on the
            CPU, each without and with the pinned global BA; the keyframe
            ATE before, after the essential graph and fusion, and after the
            global BA. The map is cut to its used slots (`next_kf`,
            `next_pt`; the capacity follows): at the default 512 keyframes
            and 32768 points the reference's global BA asks the CPU for a
            74 GB buffer.
  eval      one row of `tools/run_eval.py` (`--sequence`, `--path`)
            through the reference's own `_run_system` or `_run_chunked` on
            the CPU, as rendered and with its images moved by one ulp:
            ATE, keyframes, loops (a loop closed at the default capacity
            makes the reference's global BA ask for the 74 GB buffer).
The loop, chunk, reloc, stereo, init and mono modes reuse the fixtures of
the port's test files.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from sgslam_tpu import config as jcfg  # noqa: E402
from sgslam_tpu.eval import ate as jate  # noqa: E402
from sgslam_tpu.geometry import se3 as jse3  # noqa: E402
from sgslam_tpu.io import checkpoint as jck  # noqa: E402
from sgslam_tpu.io import synthetic as jsyn  # noqa: E402
from sgslam_tpu.mapstate import local_map as jlm  # noqa: E402
from sgslam_tpu.models import detector as jdet  # noqa: E402
from sgslam_tpu.optim import local_ba as jba  # noqa: E402
from sgslam_tpu.semantic import dynamic as jdyn  # noqa: E402
from sgslam_tpu.slam import system as jsys  # noqa: E402
from sgslam_tpu.slam import tracking as jtr  # noqa: E402
from sgslam_tpu_torch import config as tcfg  # noqa: E402
from sgslam_tpu_torch import convert  # noqa: E402
from sgslam_tpu_torch.io import synthetic as tsyn  # noqa: E402
from sgslam_tpu_torch.semantic import dynamic as tdyn  # noqa: E402
from sgslam_tpu_torch.slam import system as tsys  # noqa: E402
from sgslam_tpu_torch.slam import tracking as ttr  # noqa: E402

EVAL_MAP = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "sgslam_tpu", "assets", "eval_map.npz")


def one_ulp(x, seed):
    x = np.asarray(x)
    signs = np.random.default_rng(seed).choice([-1, 1], size=x.shape)
    return jnp.asarray((x * (1 + signs * 2.0 ** -23)).astype(np.float32))


def _np_dict(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _eval_cfg(c, window, points):
    return c.synthetic_config(
        width=640, height=480,
        orb=c.OrbConfig(n_features=2048, max_keypoints=2176),
        tracker=c.TrackerConfig(max_frames_between_kf=2,
                                depth_threshold_factor=150.0),
        capacity=c.MapCapacity(max_keyframes=288, max_points=32768,
                               local_window=window, local_points=points))


def _pose_gap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (f"t {np.abs(a[..., 4:] - b[..., 4:]).max():.3g} m, "
            f"q {np.abs(a[..., :4] - b[..., :4]).max():.3g}")


def mode_ba(seeds):
    m, _ = jck.load_map(EVAL_MAP)
    kf = int(np.nonzero(np.asarray(m.kf_valid))[0].max())
    cam = _eval_cfg(jcfg, 16, 4096).camera
    ids, om = jlm.ba_window_temporal(m, kf, window=16, n_fixed=8)
    prob, pids = jlm.build_ba_problem(cam, m, ids, om)
    valid = np.asarray(pids) >= 0
    obs_pt = np.asarray(prob.obs_pt)

    def gaps(name, a, b):
        both = a[2] & b[2]
        n_inl = np.bincount(obs_pt[both], minlength=len(valid))
        d = np.linalg.norm(a[1] - b[1], axis=1)[valid & (n_inl >= 2)]
        print(f"{name}: {_pose_gap(a[0], b[0])}, flips "
              f"{int((a[2] != b[2]).sum())}; points (>= 2 inliers) median "
              f"{np.median(d):.3g} m, p95 {np.percentile(d, 95):.3g}, p99 "
              f"{np.percentile(d, 99):.3g}, max {d.max():.3g} m")

    def run(p):
        return [np.asarray(v) for v in jba.bundle_adjust(cam, p, iters1=6,
                                                         iters2=14)]

    ref = run(prob)
    for s in range(seeds):
        gaps(f"reference, points moved by one ulp (seed {s})",
             run(dataclasses.replace(prob, points=one_ulp(prob.points, s))),
             ref)
    from sgslam_tpu_torch.optim import local_ba as tba

    port = [v.numpy() for v in tba.bundle_adjust(
        _eval_cfg(tcfg, 16, 4096).camera,
        convert.ba_problem_from_numpy(_np_dict(prob)), iters1=6, iters2=14)]
    gaps("port", port, ref)


def mode_pass(seeds):
    m, _ = jck.load_map(EVAL_MAP)
    kf = int(np.nonzero(np.asarray(m.kf_valid))[0].max())
    cfg = _eval_cfg(jcfg, 4, 1024)
    ref = jtr.process_new_keyframe(cfg, m, jnp.asarray(kf)).kf_pose
    for s in range(seeds):
        mm = dataclasses.replace(m, pt_pos=one_ulp(m.pt_pos, s))
        out = jtr.process_new_keyframe(cfg, mm, jnp.asarray(kf)).kf_pose
        print(f"reference, points moved by one ulp (seed {s}): "
              f"{_pose_gap(out, ref)}")
    port = ttr.process_new_keyframe(_eval_cfg(tcfg, 4, 1024),
                                    convert.map_from_numpy(_np_dict(m)), kf)
    print(f"port: {_pose_gap(port.kf_pose.numpy(), ref)}")


def _sequence_cfg(c, capacity_run):
    if capacity_run:
        return c.synthetic_config(
            width=320, height=240,
            orb=c.OrbConfig(n_features=600, max_keypoints=640),
            tracker=c.TrackerConfig(max_frames_between_kf=2,
                                    depth_threshold_factor=70.0),
            capacity=c.MapCapacity(max_keyframes=24, max_points=8192,
                                   local_window=4, local_points=1024))
    return c.synthetic_config(
        width=320, height=240,
        orb=c.OrbConfig(n_features=600, max_keypoints=640),
        tracker=c.TrackerConfig(max_frames_between_kf=4),
        capacity=c.MapCapacity(max_keyframes=64, max_points=8192,
                               local_window=4, local_points=1024))


def _track(tracker, feats, gt_wc):
    for f in feats:
        tracker.process(None, None, feats=f)
    cw = tracker.poses_cw()
    wc = np.stack([np.asarray(jse3.se3_inverse(jnp.asarray(p))) for p in cw])
    return cw, np.array(tracker.n_inliers_hist), jate.ate_rmse(wc, gt_wc)[0]


def mode_sequence(seeds, capacity_run):
    n = 120 if capacity_run else 30
    cfg = _sequence_cfg(jcfg, capacity_run)
    seq = jsyn.SyntheticSequence(cfg.camera, n_frames=n)
    gt = np.stack([np.asarray(seq.gt_pose_wc(i)) for i in range(n)])
    feats = [jtr.extract_frame(cfg, *seq.frame(i)) for i in range(n)]
    ref = _track(jtr.Tracker(cfg), feats, gt)

    def report(name, run):
        print(f"{name}: ATE {run[2]:.4f} m (reference {ref[2]:.4f} m); "
              f"vs reference {_pose_gap(run[0], ref[0])}, inliers "
              f"{int(np.abs(run[1] - ref[1]).max())}")

    for s in range(seeds):
        moved = [dataclasses.replace(f, xy=one_ulp(f.xy, 1000 * s + i))
                 for i, f in enumerate(feats)]
        report(f"reference, keypoints moved by one ulp (seed {s})",
               _track(jtr.Tracker(cfg), moved, gt))
    tc = _sequence_cfg(tcfg, capacity_run)
    report("port, the reference's features",
           _track(ttr.Tracker(tc, device="cpu"),
                  [convert.features_from_numpy(_np_dict(f)) for f in feats],
                  gt))
    if capacity_run:
        tseq = tsyn.SyntheticSequence(tc.camera, n_frames=n, device="cpu")
        tr = ttr.Tracker(tc, device="cpu")
        for i in range(n):
            tr.process(*tseq.frame(i))
        wc = jse3.se3_inverse(jnp.asarray(tr.poses_cw()))
        print(f"port, its own features: ATE "
              f"{jate.ate_rmse(np.asarray(wc), gt)[0]:.4f} m")


def mode_main():
    cfg = jcfg.synthetic_config(640, 480)
    seq = jsyn.SyntheticSequence(cfg.camera, n_frames=60)
    gt = np.stack([np.asarray(seq.gt_pose_wc(i)) for i in range(60)])
    feats = [jtr.extract_frame(cfg, *seq.frame(i)) for i in range(60)]
    for every, name in ((1, "on"), (10 ** 9, "off")):
        _, inl, rmse = _track(jtr.Tracker(cfg, local_ba_every=every), feats,
                              gt)
        print(f"reference, 640x480, 60 frames, back-end {name}: ATE "
              f"{rmse:.4f} m, min inliers {inl.min()}")


CULL_PAIRS = (5, 12, 21)      # current frames; each is culled against i - 1
CULL_KEY = 11


class ReplaySampler:
    """The reference's F-RANSAC draws for the port: a `jax.random` key
    split once per call, `randint` over max(n_valid, 8) as
    `epipolar.ransac_fundamental` draws them."""

    def __init__(self, seed=None, key=None):
        self.key = key if key is not None else jax.random.PRNGKey(seed)
        self.split = key is None

    def __call__(self, n_valid, iters):
        key = self.key
        if self.split:
            self.key, key = jax.random.split(self.key)
        r = jax.random.randint(key, (iters, 8), 0, max(int(n_valid), 8))
        return torch.from_numpy(np.asarray(r).astype(np.int64))


def dynamic_cfg(c):
    """tests/test_system_dynamic.py's configuration."""
    return c.synthetic_config(
        width=320, height=240,
        orb=c.OrbConfig(n_features=600, max_keypoints=640),
        capacity=c.MapCapacity(max_keyframes=64, max_points=8192,
                               local_window=4, local_points=1024))


def cull_inputs(cfg, seq, det, i):
    """JAX inputs of the cull of frame i against i - 1: (current features,
    prev_xy, status, the current person-cull boxes, the previous frame's
    dynamic boxes)."""
    def frame(j):
        g, d = seq.frame(j)
        return g, d, jnp.repeat(g[..., None], 3, -1)

    gp, dp, rgbp = frame(i - 1)
    gc, dc, rgbc = frame(i)
    fp = jtr.extract_frame(cfg, gp, dp)
    fc = jtr.extract_frame(cfg, gc, dc)
    w, h = cfg.camera.width, cfg.camera.height
    prev_map = det.detect(rgbp, w, h)[2]
    cur_cull = det.detect(rgbc, w, h)[1]
    prev_xy, status = jdyn.match_prev_frame(
        cfg.matcher, cfg.orb.scale_factor, fc, fp.xy_raw, fp.level,
        fp.angle, fp.desc, fp.valid, radius=cfg.dynamic.match_radius)
    return fc, prev_xy, status, cur_cull, prev_map


def port_cull(tc, fc, prev_xy, status, cur_cull, prev_map, key):
    """The port's `reject_dynamic_matched` on the same (JAX) inputs, with
    the draws of `key` replayed."""
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    keep, _, n_inl = tdyn.reject_dynamic_matched(
        tc.dynamic, t(fc.xy_raw), t(fc.valid), t(prev_xy), t(status),
        convert.boxes_from_numpy(_np_dict(cur_cull)),
        convert.boxes_from_numpy(_np_dict(prev_map)),
        ReplaySampler(key=key))
    return keep.numpy(), int(n_inl)


def system_run(s, frames, gt, to):
    kfs = []
    for i, (g, d) in enumerate(frames):
        s.track_rgbd(to(g), to(d), rgb=to(np.repeat(g[..., None], 3, -1)))
        if s.tracker.kf_inserted:
            kfs.append(i)
    cw = s.tracker.poses_cw()
    wc = np.stack([np.asarray(jse3.se3_inverse(jnp.asarray(p))) for p in cw])
    return cw, kfs, jate.ate_rmse(wc, gt)[0]


def mode_cull(seeds):
    cfg, tc = dynamic_cfg(jcfg), dynamic_cfg(tcfg)
    seq = jsyn.SyntheticSequence(cfg.camera, n_frames=30, dynamic=True)
    det = jdet.Detector2D(cfg.detector)
    key = jax.random.PRNGKey(CULL_KEY)
    for i in CULL_PAIRS:
        fc, prev_xy, status, cur_cull, prev_map = cull_inputs(cfg, seq, det,
                                                              i)
        args = (cfg.dynamic, fc.xy_raw, fc.valid, prev_xy, status, cur_cull,
                prev_map, key)
        keep, _, n_inl = jdyn.reject_dynamic_matched(*args)
        keep, n_inl = np.asarray(keep), int(n_inl)
        print(f"frame {i}: {int(np.asarray(status).sum())} correspondences, "
              f"reference keeps {int(keep.sum())}, {n_inl} F inliers")
        for s in range(seeds):
            k2, _, n2 = jdyn.reject_dynamic_matched(
                cfg.dynamic, one_ulp(fc.xy_raw, 100 * s + i), *args[2:])
            print(f"  reference, keypoints moved by one ulp (seed {s}): "
                  f"{int((np.asarray(k2) != keep).sum())} keep flips, F "
                  f"inliers {int(n2) - n_inl:+d}")
        kt, nt = port_cull(tc, fc, prev_xy, status, cur_cull, prev_map, key)
        print(f"  port, the reference's draws: {int((kt != keep).sum())} "
              f"keep flips, F inliers {nt - n_inl:+d}")

    frames = [tuple(np.array(x) for x in seq.frame(i)) for i in range(30)]
    gt = np.stack([np.asarray(seq.gt_pose_wc(i)) for i in range(30)])

    def jsystem():
        return jsys.System(cfg, enable_loop=False, enable_mapping=False)

    ref = system_run(jsystem(), frames, gt, jnp.asarray)
    print(f"System, 30 frames, real detector: reference keyframes {ref[1]}, "
          f"ATE {ref[2]:.4f} m")

    def report(name, run):
        print(f"  {name}: keyframes {run[1]}, ATE {run[2]:.4f} m, vs "
              f"reference {_pose_gap(run[0], ref[0])}")

    for s in range(seeds):
        moved = [(np.asarray(one_ulp(g, 2000 * s + i)),
                  np.asarray(one_ulp(d, 3000 * s + i)))
                 for i, (g, d) in enumerate(frames)]
        report(f"reference, images moved by one ulp (seed {s})",
               system_run(jsystem(), moved, gt, jnp.asarray))
    port = tsys.System(tc, enable_loop=False, enable_mapping=False,
                       device="cpu", sampler=ReplaySampler(seed=7))
    report("port, own features, the reference's draws",
           system_run(port, frames, gt, torch.from_numpy))


def _test_module(name):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests"))
    import importlib

    return importlib.import_module(name)


def _moved_frames(frames, s):
    return [(np.asarray(one_ulp(g, 2000 * s + i)),
             np.asarray(one_ulp(d, 3000 * s + i)))
            for i, (g, d) in enumerate(frames)]


def mode_loop(seeds):
    from sgslam_tpu.mapstate import mapstate as jms
    from sgslam_tpu.optim import global_ba as jgba
    from sgslam_tpu_torch.optim import global_ba as tgba

    tc = _test_module("test_torch_loop_components")
    arrays = tc._perturbed_map()
    fixed = np.zeros(64, bool)
    fixed[3] = True

    def gba(pts):
        m = jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})
        m = dataclasses.replace(m, pt_pos=pts)
        out = jgba.global_ba_step(tc.GBA_CFG_J, m, iters=10,
                                  fixed_extra=jnp.asarray(fixed))
        return np.asarray(out.kf_pose)[:6], np.asarray(out.pt_pos)[:400]

    def gaps(name, a, b):
        d = np.linalg.norm(a[1] - b[1], axis=1)
        print(f"{name}: {_pose_gap(a[0], b[0])}; points median "
              f"{np.median(d):.3g} m, max {d.max():.3g} m")

    ref = gba(jnp.asarray(arrays["pt_pos"]))
    for s in range(seeds):
        gaps(f"global BA, reference, points moved by one ulp (seed {s})",
             gba(one_ulp(arrays["pt_pos"], s)), ref)
    out = tgba.global_ba_step(tc.GBA_CFG_T, convert.map_from_numpy(arrays),
                              iters=10, fixed_extra=torch.from_numpy(fixed))
    gaps("global BA, port", (out.kf_pose[:6].numpy(),
                             out.pt_pos[:400].numpy()), ref)

    tl = _test_module("test_torch_loop_closing")
    frames, gt = tl.circuit_frames()

    def jsystem():
        return jsys.System(tl.JCFG, enable_semantic=False,
                           enable_mapping=False)

    def report(name, r):
        print(f"{name}: loops {r['s'].loop.loops_closed}, keyframe ATE "
              f"drifted {r['drifted']:.4f} m -> final {r['final']:.4f} m")

    report("System loop fixture, reference",
           tl.run_drifted(jsystem(), frames, gt))
    for s in range(seeds):
        report(f"  reference, images moved by one ulp (seed {s})",
               tl.run_drifted(jsystem(), _moved_frames(frames, s), gt))
    report("  port, own features, the reference's draws", tl.run_drifted(
        tsys.System(tl.TCFG, enable_semantic=False, enable_mapping=False,
                    device="cpu", draws=tl.replay_draws), frames, gt))


def mode_chunk(seeds):
    from sgslam_tpu.slam import loop_closing as jlc
    from sgslam_tpu.slam import scan_pipeline as jsp
    from sgslam_tpu_torch.slam import loop_closing as tlc
    from sgslam_tpu_torch.slam import scan_pipeline as tsp

    ts = _test_module("test_torch_scan_pipeline")
    seq = jsyn.SyntheticSequence(ts.JCFG.camera, n_frames=ts.N)
    frames = [tuple(np.array(x) for x in seq.frame(i)) for i in range(ts.N)]
    cj = jsp.ChunkedTracker(ts.JCFG, chunk=ts.CHUNK, fetch_every=2,
                            loop=jlc.LoopCloser(ts.JCFG))
    boot, snap = ts._drive(cj, frames, jnp.asarray, ts.N)
    ref, fed = ts.reference_chunks(snap, frames, boot)

    def gaps(name, runs):
        flags = all((a[:, 8] == b[:, 8]).all() for a, b in zip(runs, ref))
        dt = max(np.abs(a[:-1, 4:7] - b[:-1, 4:7]).max()
                 for a, b in zip(runs, ref))
        di = max(np.abs(a[:-1, 7] - b[:-1, 7]).max()
                 for a, b in zip(runs, ref))
        print(f"{name}: keyframe flags {'equal' if flags else 'DIFFER'}, "
              f"poses {dt:.3g} m, inliers {di:.0f}")

    print(f"two chunks from the post-bootstrap state: reference inserts "
          f"{[int(p[-1, 2]) for p in ref]} keyframes")
    for s in range(seeds):
        gaps(f"  reference, images moved by one ulp (seed {s})",
             ts.reference_chunks(snap, frames, boot,
                                 move=lambda x, s=s: one_ulp(x, s))[0])
    gaps("  port, the reference's features",
         ts.port_chunks(snap, frames, boot, fed))

    tcl = _test_module("test_torch_chunked_loop")
    poses = jsyn.make_circuit_trajectory(tcl.N_LOOP, loops=tcl.LOOPS)
    seq = jsyn.SyntheticSequence(tcl.JCFG.camera, n_frames=tcl.N_LOOP,
                                 planes=jsyn.ROOM_CLOSED, poses=poses)
    frames = [tuple(np.array(x) for x in seq.frame(i))
              for i in range(tcl.N_LOOP)]
    gt = np.asarray(poses)

    def jrun(fr):
        return tcl.run_chunked_loop(
            jsp.ChunkedTracker(tcl.JCFG, chunk=tcl.CHUNK, fetch_every=2,
                               loop=jlc.LoopCloser(tcl.JCFG)), fr, gt, False)

    def report(name, r):
        print(f"{name}: loops {r['loops']} {r['pairs']}, keyframe ATE "
              f"drifted {r['drifted']:.4f} -> final {r['final']:.4f} m, "
              f"trajectory ATE {r['traj']:.4f} m")

    report("chunked loop fixture, reference", jrun(frames))
    for s in range(seeds):
        report(f"  reference, images moved by one ulp (seed {s})",
               jrun(_moved_frames(frames, s)))
    report("  port, own features, the reference's draws",
           tcl.run_chunked_loop(tsp.ChunkedTracker(
               tcl.TCFG, chunk=tcl.CHUNK, fetch_every=2,
               loop=tlc.LoopCloser(tcl.TCFG, device="cpu",
                                   draws=tcl.replay_draws),
               device="cpu"), frames, gt, True))


KIDNAP_N, KIDNAP_MAP, KIDNAP_TO, KIDNAP_CHUNK = 88, 44, 6, 4


def kidnap_run(ct, frames, stack):
    """tests/test_chunked_full_system.py::test_chunked_kidnap_relocalizes on
    either package's ChunkedTracker: map the first 44 frames, then three
    chunks from frame 6. Returns (relocalizations, the last four frames'
    exported gaps to the map's own estimate, their recorded poses' gaps)."""
    c = KIDNAP_CHUNK
    i = 0
    while ct._carry is None:
        ct.bootstrap(*frames[i])
        i += 1
    while i + c <= KIDNAP_MAP:
        ct.process_chunk(stack([f[0] for f in frames[i:i + c]]),
                         stack([f[1] for f in frames[i:i + c]]))
        i += c
    ct.flush()
    own = np.asarray(ct.poses_cw())
    for k in range(3):
        lo = KIDNAP_TO + k * c
        ct.process_chunk(stack([f[0] for f in frames[lo:lo + c]]),
                         stack([f[1] for f in frames[lo:lo + c]]))
    ct.flush()
    last = KIDNAP_TO + 3 * c - 1

    def gaps(poses):
        return [float(np.linalg.norm(np.asarray(poses[-(k + 1)])[4:7]
                                     - own[last - k][4:7])) for k in range(c)]

    return ct.relocs, gaps(np.asarray(ct.poses_cw())), gaps(ct.trajectory)


def mode_reloc(seeds):
    from sgslam_tpu.slam import loop_closing as jlc
    from sgslam_tpu.slam import scan_pipeline as jsp
    from sgslam_tpu_torch.slam import loop_closing as tlc
    from sgslam_tpu_torch.slam import scan_pipeline as tsp

    tcl = _test_module("test_torch_chunked_loop")
    seq = jsyn.SyntheticSequence(
        tcl.JCFG.camera, n_frames=KIDNAP_N, planes=jsyn.ROOM_CLOSED,
        poses=jsyn.make_circuit_trajectory(KIDNAP_N, loops=1.0))
    frames = [tuple(np.array(x) for x in seq.frame(i))
              for i in range(KIDNAP_N)]

    def report(name, r):
        print(f"{name}: relocalizations {r[0]}, the last 4 frames' gaps to "
              f"the map's own estimate {np.round(r[1], 4).tolist()} m (min "
              f"{min(r[1]):.4f}; gate 0.06), recorded poses "
              f"{np.round(r[2], 4).tolist()} m")

    def jrun(fr):
        return kidnap_run(jsp.ChunkedTracker(
            tcl.JCFG, chunk=KIDNAP_CHUNK, fetch_every=1,
            loop=jlc.LoopCloser(tcl.JCFG)),
            [tuple(jnp.asarray(x) for x in f) for f in fr], jnp.stack)

    def trun(fr, draws):
        return kidnap_run(tsp.ChunkedTracker(
            tcl.TCFG, chunk=KIDNAP_CHUNK, fetch_every=1, device="cpu",
            loop=tlc.LoopCloser(tcl.TCFG, device="cpu", draws=draws)),
            [tuple(torch.from_numpy(x) for x in f) for f in fr],
            torch.stack)

    report("chunked kidnap, reference", jrun(frames))
    report("  port, own features, the reference's draws",
           trun(frames, tcl.replay_draws))
    report("  port, own features, its default draws", trun(frames, None))
    for s in range(seeds):
        moved = _moved_frames(frames, s)
        report(f"  reference, images moved by one ulp (seed {s})",
               jrun(moved))
        report(f"  port, the same images, the reference's draws",
               trun(moved, tcl.replay_draws))


def mode_stereo(seeds):
    tst = _test_module("test_torch_stereo")
    for frame in (3, tst.FRAME, 18, 21):
        gl, gr, xy, lv, va = tst.stereo_pair(frame)
        ref = tst.jax_match(gl, gr, xy, lv, va)

        def gaps(name, out):
            both = ref[2] & out[2]
            du = np.abs(out[0] - ref[0])[both]
            dd = np.abs(out[1] - ref[1])[both]
            jump = (du > tst.TOL_U_RIGHT) | (dd > tst.TOL_DEPTH)
            rest = (f"{du[~jump].max():.3g} px, {dd[~jump].max():.3g} m"
                    if (~jump).any() else "-")
            print(f"  {name}: ok flips {int((out[2] != ref[2]).sum())} of "
                  f"{int(ref[2].sum())}, jumps {int(jump.sum())} (u_right "
                  f"up to {du.max():.3g} px), the rest within {rest}")

        print(f"stereo_match, frame {frame}")
        for s in range(seeds):
            gaps(f"reference, images moved by one ulp (seed {s})",
                 tst.jax_match(np.asarray(one_ulp(gl, 2 * s)),
                               np.asarray(one_ulp(gr, 2 * s + 1)),
                               xy, lv, va))
        gaps("port", tst.port_match(gl, gr, xy, lv, va))

    tss = _test_module("test_torch_stereo_system")
    pairs, gt = tss.stereo_frames(tss.N_SYSTEM)
    dyn, dyn_gt = tss.stereo_frames(tss.N_SEMANTIC, dynamic=True)
    gts = {"system": gt, "chunked": gt, "semantic": dyn_gt}

    def report(name, runs):
        print(name + ": " + ", ".join(
            f"{k} ATE {tss.ate(tss.summary(r)[0], gts[k]):.4f} m "
            f"({tss.summary(r)[1]} keyframes)" for k, r in runs.items()))

    def moved(ps, s):
        return [(np.asarray(one_ulp(a, 2000 * s + i)),
                 np.asarray(one_ulp(b, 3000 * s + i)))
                for i, (a, b) in enumerate(ps)]

    report("stereo runs, reference", tss.jax_runs(pairs, dyn))
    for s in range(seeds):
        report(f"  reference, images moved by one ulp (seed {s})",
               tss.jax_runs(moved(pairs, s), moved(dyn, s)))
    report("  port, own features, the reference's draws",
           tss.port_runs(pairs, dyn))


def mode_init(seeds):
    ti = _test_module("test_torch_initializer")

    def gaps(name, a, b):
        g = a["good"] & b["good"]
        rel = (np.abs(a["points"][g] - b["points"][g]).max(-1)
               / np.linalg.norm(b["points"][g], axis=-1))
        print(f"  {name}: ok {bool(a['ok'])}, used_H {bool(a['used_H'])}, "
              f"rh {abs(float(a['rh']) - float(b['rh'])):.2g}, T21 "
              f"{np.abs(a['T21'] - b['T21']).max():.3g}, good flips "
              f"{int((a['good'] != b['good']).sum())}, good points "
              f"{rel.max() if len(rel) else 0.0:.3g} of their distance")

    for name, (p1, p2, valid, seed) in ti.problems().items():
        ref = ti.jax_init(p1, p2, valid, seed)
        print(f"initialize_mono, {name}: reference ok {bool(ref['ok'])}, "
              f"used_H {bool(ref['used_H'])}, rh {float(ref['rh']):.4f}")
        for s in range(seeds):
            gaps(f"reference, matches moved by one ulp (seed {s})",
                 ti.jax_init(np.asarray(one_ulp(p1, 2 * s)),
                             np.asarray(one_ulp(p2, 2 * s + 1)), valid,
                             seed), ref)
        gaps("port, the reference's draws",
             ti.port_init(p1, p2, valid, seed), ref)


def mode_mono(seeds):
    from sgslam_tpu.slam import mono as jmono

    tm = _test_module("test_torch_mono")
    grays, gt = tm.frames()

    def report(name, tracker, feats=None):
        init, poses = tm.run(tracker, grays, feats)
        pts = tracker.map.pt_valid
        n_pts = int(pts.sum()) if torch.is_tensor(pts) else int(
            np.asarray(pts).sum())
        print(f"{name}: initialized at frame {init}, state {tracker.state},"
              f" {tracker.n_kf} keyframes, {n_pts} points, Sim(3)-aligned "
              f"ATE {tm.sim3_ate(poses, gt, init):.4f} m")

    report("MonoTracker, reference", jmono.MonoTracker(tm.JCFG))
    for s in range(seeds):
        moved = [np.asarray(one_ulp(g, 2000 * s + i))
                 for i, g in enumerate(grays)]
        init, poses = tm.run(jmono.MonoTracker(tm.JCFG), moved)
        print(f"  reference, images moved by one ulp (seed {s}): "
              f"initialized at frame {init}, Sim(3)-aligned ATE "
              f"{tm.sim3_ate(poses, gt, init):.4f} m")
    report("  port, own features", tm.port_tracker())
    feats = [convert.features_from_numpy(tm._np_fields(
        jtr.extract_frame_mono(tm.JCFG, jnp.asarray(g)))) for g in grays]
    report("  port, the reference's features", tm.port_tracker(), feats)

    # full width (chip_smoke.py phase 14's configuration): the frame the
    # run initializes at, and each attempt's outcome
    from sgslam_tpu_torch.slam import mono as tmono

    def full(c):
        return c.synthetic_config(640, 480, tracker=c.TrackerConfig(
            max_frames_between_kf=2, depth_threshold_factor=70.0))

    seq = jsyn.SyntheticSequence(full(jcfg).camera, n_frames=30)
    big = [np.asarray(seq.frame(i)[0]) for i in range(30)]

    def init_frame(tracker, frames):
        attempts = []
        module = jmono if isinstance(tracker, jmono.MonoTracker) else tmono
        orig = module.initialize_mono

        def logged(*a, **k):
            out = orig(*a, **k)
            attempts.append("ok" if bool(out["ok"]) else "rejected")
            return out

        module.initialize_mono = logged
        try:
            for i, g in enumerate(frames):
                tracker.process_mono(g)
                if tracker.state == "OK":
                    return i, attempts
        finally:
            module.initialize_mono = orig
        return None, attempts

    def show(name, res, ref=None):
        frame, attempts = res
        flips = ("" if ref is None else f", outcome differs from the "
                 f"unmoved run's on {sum(a != b for a, b in zip(attempts, ref))}"
                 f" of {min(len(attempts), len(ref))} attempts")
        print(f"  {name}: initialized at frame {frame}, attempts "
              f"{' '.join(attempts)}{flips}")

    print("MonoTracker at 640x480 (chip_smoke.py phase 14's 30-frame "
          "sequence), the initialization frame and each initialize_mono "
          "call's outcome:")
    ref = init_frame(jmono.MonoTracker(full(jcfg)), big)
    show("reference", ref)
    for s in range(seeds):
        moved = [np.asarray(one_ulp(g, 2000 * s + i))
                 for i, g in enumerate(big)]
        show(f"reference, images moved by one ulp (seed {s})",
             init_frame(jmono.MonoTracker(full(jcfg)), moved), ref[1])
    show("port, own features, the reference's draws", init_frame(
        tmono.MonoTracker(full(tcfg), draws=tm.ReplayInit(), device="cpu"),
        big), ref[1])


def mode_correction(dump):
    from sgslam_tpu.mapstate import mapstate as jms
    from sgslam_tpu.slam import loop_closing as jlc
    from sgslam_tpu_torch.debug_stress import kf_ate
    from sgslam_tpu_torch.mapstate import mapstate as tms
    from sgslam_tpu_torch.slam import loop_closing as tlc

    with np.load(dump) as z:
        arrays = {k[5:]: z[k] for k in z.files if k.startswith("map__")}
        extra = {k[7:]: z[k] for k in z.files if k.startswith("extra__")}
    nk, npt = int(arrays["next_kf"]), int(arrays["next_pt"])
    used = {k: v[:nk] if k.startswith("kf_") else
            v[:npt] if k.startswith("pt_") else v for k, v in arrays.items()}
    kf_cur, kf_loop = int(extra["kf_cur"]), int(extra["kf_loop"])
    gt = extra["gt"]
    edges = list(zip(extra["edges_i"].tolist(), extra["edges_j"].tolist(),
                     list(extra["edges_s"])))

    def cfg_of(c, gba):
        base = c.synthetic_config(
            width=640, height=480,
            tracker=c.TrackerConfig(max_frames_between_kf=6,
                                    depth_threshold_factor=70.0))
        return dataclasses.replace(
            base, capacity=dataclasses.replace(
                base.capacity, max_keyframes=nk, max_points=npt),
            loop=dataclasses.replace(base.loop, run_global_ba=gba))

    tm = convert.map_from_numpy(used, torch.device("cpu"))
    print(f"{dump}: pair ({kf_cur}, {kf_loop}), {int(used['kf_valid'].sum())}"
          f" keyframes in {nk} slots, {int(used['pt_valid'].sum())} points "
          f"in {npt}; keyframe ATE before {kf_ate(tm, gt):.4f} m", flush=True)
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in used.items()})
    for name, run in (("reference", lambda gba: jlc.LoopCloser(
            cfg_of(jcfg, gba))), ("port (CPU)", lambda gba: tlc.LoopCloser(
                cfg_of(tcfg, gba), device="cpu"))):
        after = []
        for gba in (False, True):
            lc = run(gba)
            lc.loop_edges = list(edges)
            if name == "reference":
                out, _ = lc._correct(jm, kf_cur, kf_loop,
                                     jnp.asarray(extra["S"]),
                                     jms.covisibility(jm))
                out = convert.map_from_numpy(_np_dict(out),
                                             torch.device("cpu"))
            else:
                out, _ = lc._correct(tm, kf_cur, kf_loop,
                                     torch.as_tensor(extra["S"]),
                                     tms.covisibility(tm))
            after.append(kf_ate(out, gt))
        print(f"  {name}: keyframe ATE after the essential graph and the "
              f"fusion {after[0]:.4f} m, after the global BA {after[1]:.4f} "
              f"m", flush=True)


def mode_eval(seeds, name, path):
    import importlib.util
    import json

    spec_ = importlib.util.spec_from_file_location(
        "reference_run_eval", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "run_eval.py"))
    jre = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(jre)
    spec = jre._sequences(False)[name]
    cfg = jre._make_cfg(spec["distort"])
    detector = (jdet.Detector2D(cfg.detector) if spec["kind"] == "dynamic"
                else None)
    seq, frames = jre._render(cfg, spec)
    frames = [tuple(np.asarray(x) for x in f) for f in frames]
    run = jre._run_system if path == "system" else jre._run_chunked
    for label, fr in [("as rendered", frames)] + [
            (f"moved by one ulp (seed {s})", _moved_frames(frames, s))
            for s in range(seeds)]:
        print(f"{name}, {path}, reference, {label}:",
              json.dumps(run(cfg, spec, fr, seq, detector)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["ba", "pass", "tracker", "capacity",
                                     "main", "cull", "loop", "chunk",
                                     "reloc", "stereo", "init", "mono",
                                     "correction", "eval"])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--dump", default=None,
                    help="correction: a file of card_spread.py --dump")
    ap.add_argument("--sequence", default=None, help="eval: the row")
    ap.add_argument("--path", default="system", choices=["system", "chunked"],
                    help="eval: the path")
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.mode == "ba":
        mode_ba(args.seeds)
    elif args.mode == "pass":
        mode_pass(args.seeds)
    elif args.mode == "main":
        mode_main()
    elif args.mode == "cull":
        mode_cull(args.seeds)
    elif args.mode == "loop":
        mode_loop(args.seeds)
    elif args.mode == "chunk":
        mode_chunk(args.seeds)
    elif args.mode == "reloc":
        mode_reloc(args.seeds)
    elif args.mode == "stereo":
        mode_stereo(args.seeds)
    elif args.mode == "init":
        mode_init(args.seeds)
    elif args.mode == "mono":
        mode_mono(args.seeds)
    elif args.mode == "correction":
        mode_correction(args.dump)
    elif args.mode == "eval":
        mode_eval(args.seeds, args.sequence, args.path)
    else:
        mode_sequence(args.seeds, args.mode == "capacity")
    return 0


if __name__ == "__main__":
    sys.exit(main())
