#!/usr/bin/env python3
"""How far the JAX reference moves from itself, beside how far the port
moves from it: the yardstick for the back-end's parity tolerances.

    python tools/parity_spread.py ba|pass|tracker|capacity|main|cull [--seeds 3]

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
            features with the draws replayed.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["ba", "pass", "tracker", "capacity",
                                     "main", "cull"])
    ap.add_argument("--seeds", type=int, default=3)
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
    else:
        mode_sequence(args.seeds, args.mode == "capacity")
    return 0


if __name__ == "__main__":
    sys.exit(main())
