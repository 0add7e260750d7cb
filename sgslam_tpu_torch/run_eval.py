"""EVAL: the hard 640x480 accuracy suite, run through the port.

    python -m sgslam_tpu_torch.run_eval [--out build/eval_torch.json]
        [--cpu] [--quick] [--only NAME]

The port's counterpart of `tools/run_eval.py`: the same seven synthetic
sequences (fast rotation, a TUM1-distorted camera, a closed-room revisit,
walkers, stereo, a 2-lap stress circuit), rendered on the run's device with
exact ground truth, each through the per-frame `System` path and the
chunked real-time path on identical frames, under the same gates:

    static sequences:  ATE RMSE <= 0.03 m
    dynamic sequences: ATE RMSE <= 0.05 m
    stereo sequences:  ATE RMSE <= 0.04 m
    stress sequence:   ATE RMSE <= 0.05 m, and the chunked path loses no frame
    System-vs-chunked parity: |a - b| <= max(0.2 * max(a, b), 0.01 m)

It runs on the GPU; `--cpu` runs it on the CPU. The artifact has the
reference's layout plus a `device` object (the card's name and power limit
as `nvidia-smi` gives them, and the torch version). The default output is
`build/eval_torch.json`; a committed card run is named `EVAL_TORCH_H100.json`,
never `EVAL_r*.json`, which names the reference's artifacts
(tests/test_eval_artifact.py reads the newest of those).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import config, resolve_device
from .io import synthetic

BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build")

STATIC_GATE = 0.03
DYNAMIC_GATE = 0.05
STEREO_GATE = 0.04     # stereo depth = epipolar SAD search (quantized /
                       # noisier than the RGB-D sensor's metric depth)
STRESS_GATE = 0.05     # beyond-reference-class difficulty
PARITY_REL = 0.2
PARITY_ABS = 0.01      # 1 cm absolute floor: at 1-3 cm ATEs, sub-cm
                       # path differences are run-to-run noise
CHUNK = 4
FETCH_EVERY = 6

TUM1_DIST = dict(k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628,
                 k3=1.163314)


def _make_cfg(distort: bool):
    """The default production config at 640x480 with denser keyframes (a
    keyframe at least every 6 frames: the eval trajectories span a room in
    ~5-8 s of frames); with `distort`, the TUM1 radtan coefficients."""
    cfg = config.synthetic_config(
        width=640, height=480,
        tracker=config.TrackerConfig(max_frames_between_kf=6,
                                     depth_threshold_factor=70.0))
    if distort:
        cam = dataclasses.replace(cfg.camera, **TUM1_DIST)
        cfg = dataclasses.replace(cfg, camera=cam)
    return cfg


def _sequences(quick: bool, device="cpu"):
    """The seven sequences: name -> spec (kind, distort, planes, poses
    [n, 7] T_wc, people [n, P, 5] or None, n, and stress for the stress
    row), trajectories on `device`."""
    n1, n2, n3, n4, n5, n6 = (140, 120, 160, 150, 200, 240) if not quick \
        else (48, 40, 54, 50, 66, 80)
    n7 = 120 if not quick else 40
    walk = synthetic.make_walk_trajectory
    circuit = synthetic.make_circuit_trajectory
    walkers = synthetic.walker_tracks
    seqs = {}
    # fast-rotation walk (~2 deg/frame peak yaw = 60 deg/s at 30 FPS)
    seqs["static_640_walk_fastrot"] = dict(
        kind="static", distort=False, planes=synthetic.ROOM,
        poses=walk(n1, yaw_amp=0.35, device=device), people=None, n=n1)
    # TUM1-class radtan distortion end to end (rendered through
    # undistort_points, keypoints undistorted at extraction)
    seqs["static_640_tum1_distortion"] = dict(
        kind="static", distort=True, planes=synthetic.ROOM,
        poses=walk(n2, yaw_amp=0.20, device=device), people=None, n=n2)
    # closed-room circuit with a revisit (sustained ~2.7 deg/frame yaw)
    seqs["static_640_circuit_revisit"] = dict(
        kind="static", distort=False, planes=synthetic.ROOM_CLOSED,
        poses=circuit(n3, loops=1.2, device=device), people=None, n=n3)
    # 3 independent walkers + fast rotation (fr3/walking_* analogue)
    seqs["dynamic_640_3walkers_fastrot"] = dict(
        kind="dynamic", distort=False, planes=synthetic.ROOM,
        poses=walk(n4, yaw_amp=0.35, device=device),
        people=walkers(n4, 3, depth0=1.6, half_h=0.62, device=device),
        n=n4)
    # walkers inside the loop circuit: dynamics + revisit in one sequence
    # (peak occlusion ~60% of the frame)
    seqs["dynamic_640_walkers_circuit"] = dict(
        kind="dynamic", distort=False, planes=synthetic.ROOM_CLOSED,
        poses=circuit(n5, loops=1.15, device=device),
        people=walkers(n5, 2, depth0=1.9, half_h=0.50, device=device),
        n=n5)
    # rectified stereo walk: depth from the epipolar SAD search
    seqs["stereo_640_walk"] = dict(
        kind="stereo", distort=False, planes=synthetic.ROOM,
        poses=walk(n7, yaw_amp=0.25, device=device), people=None, n=n7)
    # stress: 2.15 laps at sustained ~3.2 deg/frame (96 deg/s)
    seqs["static_640_circuit_2laps_stress"] = dict(
        kind="static", distort=False, planes=synthetic.ROOM_CLOSED,
        poses=circuit(n6, loops=2.15, device=device), people=None, n=n6,
        stress=True)
    return seqs


def _render(cfg, spec, device):
    """(SyntheticSequence, frames): (gray, depth) per frame, or (left,
    right) for a stereo sequence, rendered on `device`."""
    seq = synthetic.SyntheticSequence(
        cfg.camera, n_frames=spec["n"], planes=spec["planes"],
        poses=spec["poses"], people=spec["people"], device=device)
    if spec["kind"] == "stereo":
        frames = [seq.frame_stereo(i)[:2] for i in range(spec["n"])]
    else:
        frames = [seq.frame(i) for i in range(spec["n"])]
    return seq, frames


def _coverage_stats(cfg, spec):
    """Per-frame walker image coverage (renderer-exact)."""
    covs = [synthetic.person_coverage(cfg.camera, spec["poses"][i],
                                      spec["people"][i],
                                      planes=spec["planes"])
            for i in range(0, spec["n"], max(spec["n"] // 30, 1))]
    covs = np.asarray(covs)
    return {"mean_person_coverage": round(float(covs.mean()), 3),
            "max_person_coverage": round(float(covs.max()), 3),
            "frames_with_person_pct": round(
                float((covs > 0.02).mean()) * 100.0, 1),
            "frames_over_30pct_coverage_pct": round(
                float((covs >= 0.30).mean()) * 100.0, 1)}


def ate_cw(est_cw, gt_wc) -> float:
    """ATE RMSE (m) of camera-from-world poses [N, 7] against world-from-
    camera ground truth, over the frames both have."""
    from .eval.ate import ate_rmse
    from .geometry import se3

    est_wc = se3.se3_inverse(torch.as_tensor(np.asarray(est_cw))).numpy()
    gt_wc = np.asarray(gt_wc)[:len(est_wc)]
    rmse, _, _ = ate_rmse(est_wc[:len(gt_wc)], gt_wc)
    return float(rmse)


def _ate(traj_cw, seq, n):
    return ate_cw(traj_cw, seq.poses[:n].cpu().numpy())


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_system(cfg, spec, detector, device):
    """The System path's flags: semantic only on dynamic sequences, loop
    closing on, mapping off."""
    from .slam.system import System

    semantic = spec["kind"] == "dynamic"
    return System(cfg, enable_semantic=semantic, enable_loop=True,
                  enable_mapping=False, detector=detector if semantic
                  else None, device=device)


def drive_system(s, spec, frames, on_frame=None):
    """Every frame through `track_stereo` or `track_rgbd` (with the gray
    image as RGB on dynamic sequences); `on_frame(i)` after each."""
    semantic = spec["kind"] == "dynamic"
    for i in range(spec["n"]):
        if spec["kind"] == "stereo":
            s.track_stereo(frames[i][0], frames[i][1])
        else:
            g, d = frames[i]
            s.track_rgbd(g, d, rgb=g[..., None].expand(-1, -1, 3)
                         if semantic else None)
        if on_frame is not None:
            on_frame(i)


def _run_system(cfg, spec, frames, seq, detector, device):
    s = make_system(cfg, spec, detector, device)
    t0 = time.perf_counter()
    drive_system(s, spec, frames)
    _sync(device)
    wall = time.perf_counter() - t0
    return {"ate": _ate(s.tracker.poses_cw(), seq, spec["n"]),
            "state": s.state,
            "keyframes": int(s.tracker.map.kf_valid.sum()),
            "loops_closed": len(s.loop.loops_closed),
            "wall_s": round(wall, 1)}


def make_chunked(cfg, spec, detector, device):
    """The chunked runner for the sequence's kind, with a LoopCloser."""
    from .slam import scan_pipeline
    from .slam.loop_closing import LoopCloser

    kw = dict(chunk=CHUNK, fetch_every=FETCH_EVERY,
              loop=LoopCloser(cfg, device=device), device=device)
    if spec["kind"] == "dynamic":
        return scan_pipeline.ChunkedSemanticTracker(cfg, detector, **kw)
    if spec["kind"] == "stereo":
        return scan_pipeline.ChunkedStereoTracker(cfg, **kw)
    return scan_pipeline.ChunkedTracker(cfg, **kw)


def drive_chunked(ct, frames):
    """Bootstrap frame by frame until the map exists, then whole chunks of
    `ct.chunk` frames, the tail, and `flush`."""
    n, chunk = len(frames), ct.chunk
    i = 0
    while ct._carry is None and i < n:
        ct.bootstrap(*frames[i])
        i += 1
    while i + chunk <= n:
        ct.process_chunk(torch.stack([f[0] for f in frames[i:i + chunk]]),
                         torch.stack([f[1] for f in frames[i:i + chunk]]))
        i += chunk
    if i < n:
        ct.process_tail(torch.stack([f[0] for f in frames[i:]]),
                        torch.stack([f[1] for f in frames[i:]]))
    ct.flush()


def _run_chunked(cfg, spec, frames, seq, detector, device):
    ct = make_chunked(cfg, spec, detector, device)
    t0 = time.perf_counter()
    drive_chunked(ct, frames[:spec["n"]])
    _sync(device)
    wall = time.perf_counter() - t0
    return {"ate": _ate(ct.poses_cw(), seq, spec["n"]),
            "keyframes": ct.n_kf,
            "loops_closed": ct.loops_closed,
            "relocalizations": ct.relocs,
            "lost_frames": int(ct.lost_mask().sum()),
            "wall_s": round(wall, 1)}


def row_verdict(kind: str, stress: bool, system: dict, chunked: dict):
    """A row's gate and verdicts from its two runs: each path under the
    kind's gate, their parity, and on the stress row a lossless chunked
    path."""
    gate = {"static": STATIC_GATE, "dynamic": DYNAMIC_GATE,
            "stereo": STEREO_GATE}[kind]
    if stress:
        gate = STRESS_GATE
    a, b = system["ate"], chunked["ate"]
    out = {"gate_ate_m": gate, "stress": stress, "system_pass": a <= gate,
           "chunked_pass": b <= gate,
           "parity_ok": abs(a - b) <= max(PARITY_REL * max(a, b),
                                          PARITY_ABS)}
    ok = out["system_pass"] and out["chunked_pass"] and out["parity_ok"]
    if stress:
        ok = ok and chunked["lost_frames"] == 0
    out["pass"] = bool(ok)
    return out


def device_info(device) -> dict:
    """The run's device: the card's name and power limit (nvidia-smi), or
    the CPU; and the torch version."""
    dev = torch.device(device)
    info = {"type": dev.type, "torch": torch.__version__}
    if dev.type == "cuda":
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, check=True)
        name, limit = (x.strip() for x in res.stdout.strip().split(","))
        info.update(name=name, power_limit=limit)
    else:
        info.update(name="cpu", power_limit=None)
    return info


def main(argv=None):
    ap = argparse.ArgumentParser(description="the 640x480 accuracy suite")
    ap.add_argument("--out", default=os.path.join(BUILD, "eval_torch.json"))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    ap.add_argument("--quick", action="store_true",
                    help="short sequences (smoke run, gates not meaningful)")
    ap.add_argument("--only", default=None, help="run one sequence by name")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from .models.detector import Detector2D

    results = {"suite": "EVAL_r05", "resolution": "640x480",
               "device": device_info(dev),
               "gates": {"static_ate_m": STATIC_GATE,
                         "dynamic_ate_m": DYNAMIC_GATE,
                         "stereo_ate_m": STEREO_GATE,
                         "parity": f"|a-b| <= max({PARITY_REL}*max(a,b), "
                                   f"{PARITY_ABS} m)"},
               "sequences": {}}
    all_pass = True
    for name, spec in _sequences(args.quick, dev).items():
        if args.only and name != args.only:
            continue
        cfg = _make_cfg(spec["distort"])
        detector = (Detector2D(cfg.detector, device=dev)
                    if spec["kind"] == "dynamic" else None)
        print(f"[{name}] rendering {spec['n']} frames...", file=sys.stderr)
        seq, frames = _render(cfg, spec, dev)
        row = {"kind": spec["kind"], "n_frames": spec["n"],
               "distortion": spec["distort"]}
        if spec["people"] is not None:
            row.update(_coverage_stats(cfg, spec))
        print(f"[{name}] System path...", file=sys.stderr)
        row["system"] = _run_system(cfg, spec, frames, seq, detector, dev)
        print(f"[{name}] chunked path...", file=sys.stderr)
        row["chunked"] = _run_chunked(cfg, spec, frames, seq, detector, dev)
        row.update(row_verdict(spec["kind"], bool(spec.get("stress")),
                               row["system"], row["chunked"]))
        all_pass = all_pass and row["pass"]
        results["sequences"][name] = row
        print(f"[{name}] system ATE {row['system']['ate']:.4f} | chunked "
              f"ATE {row['chunked']['ate']:.4f} | gate {row['gate_ate_m']} "
              f"| pass={row['pass']}", file=sys.stderr)
    results["all_pass"] = all_pass
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"eval": args.out, "all_pass": all_pass}))
    return results


if __name__ == "__main__":
    main()
