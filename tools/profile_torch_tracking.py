#!/usr/bin/env python3
"""Where the time goes in the port's tracking path, keyframe back-end and
semantic system on the GPU.

    python tools/profile_torch_tracking.py [tracking] [--frames 60]
                                           [--window 10] [--passes 3]
    python tools/profile_torch_tracking.py system [--frames 60] [--window 10]
    python tools/profile_torch_tracking.py chunk [--chunks 10]

`system` drives the first `--frames` frames of chip_smoke.py's phase-7
sequence (640x480, three walkers, fast rotation, 150 frames) through
`System(cfg).track_rgbd` (loop closing on) with the detector, the cull, the
back-end and the mapper, then profiles the last
`--window` frames of `track_rgbd` as a whole, and each stage on its own on
those frames: the detector, `extract_frame`, the dynamic cull (against
the previous frame) and the mapper's keyframe insertion (three frames, a
fresh mapper). Output: build/profile_torch_system.json.

`chunk` sets up chip_smoke.py's phase 10 (bench.py's schedule: the
chunked semantic pipeline with a loop closer at 640x480), runs its 12 warm
chunks and a flush, then profiles the next `--chunks` chunks and a flush:
kernels per frame, the device idle share, and the device-to-host copies
per chunk (the host reads listed in `slam/scan_pipeline.py`). Output:
build/profile_torch_chunk.json.

Without a mode:
Tracks the full-width synthetic sequence (640x480, 1000 features, 1024
keypoints, 4096 local points) with `sgslam_tpu_torch` and the back-end off,
then re-runs a window of frames under `torch.profiler` twice: once around
`extract_frame` alone (stateless) and once around `Tracker.process` on
those frames' features. Then it profiles `--passes` back-end passes
(`process_new_keyframe`, after one unprofiled pass) at two widths: on the
tracked map at its newest keyframe, and on `sgslam_tpu/assets/eval_map.npz`
(2176 keypoints, window 16+8). For each it prints the host wall time per
frame or pass (synchronized), the summed device kernel time, the device
idle share, the kernel launches and the heaviest kernels; the same goes to
a JSON file (default build/profile_torch_tracking.json). The
sequence is tracked twice, and the largest difference between the two
trajectories is reported: the run-to-run reproducibility of the GPU path.
It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from sgslam_tpu_torch import bench, config, run_eval  # noqa: E402
from sgslam_tpu_torch.io import checkpoint, synthetic  # noqa: E402
from sgslam_tpu_torch.mapping.semantic_mapper import SemanticMapper  # noqa: E402
from sgslam_tpu_torch.ops import hamming_cuda  # noqa: E402
from sgslam_tpu_torch.semantic.dynamic import SemanticFrontend  # noqa: E402
from sgslam_tpu_torch.slam import tracking  # noqa: E402
from sgslam_tpu_torch.slam.system import System  # noqa: E402
from sgslam_tpu_torch.utils import timing  # noqa: E402


def _kernel_stats(prof):
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        rows.append((evt.key, evt.count, float(us)))
    rows.sort(key=lambda r: -r[2])
    return rows


def _profiled(fn, n_frames):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _kernel_stats(prof)
    busy_ms = sum(r[2] for r in rows) / 1e3
    launches = sum(r[1] for r in rows)
    k1_us = sum(r[2] for r in rows if "hamming_kernel" in r[0])
    dtoh = sum(r[1] for r in rows if "DtoH" in r[0])
    return {
        "dtoh_copies_per_frame": dtoh / n_frames,
        "wall_ms_per_frame": wall_ms / n_frames,
        "device_ms_per_frame": busy_ms / n_frames,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_frame": launches / n_frames,
        "k1_us_per_frame": k1_us / n_frames,
        "top_kernels": [{"name": k[:90], "calls_per_frame": c / n_frames,
                         "us_per_frame": us / n_frames}
                        for k, c, us in rows[:10]],
    }


def _print_stage(name, r, unit="frame"):
    print(f"[profile] {name}: wall {r['wall_ms_per_frame']:.3f} "
          f"ms/{unit}, device {r['device_ms_per_frame']:.3f} ms/{unit}, "
          f"idle {100 * r['device_idle_share']:.1f}%, "
          f"{r['kernel_launches_per_frame']:.0f} kernels/{unit}, K1 "
          f"{r['k1_us_per_frame']:.1f} us/{unit}")
    for k in r["top_kernels"][:5]:
        print(f"    {k['us_per_frame']:9.1f} us/{unit} "
              f"{k['calls_per_frame']:6.1f}x  {k['name']}")


def profile_system(args, dev) -> int:
    cfg = run_eval._make_cfg(False)
    w, h = cfg.camera.width, cfg.camera.height
    _, frames, _ = chip_smoke.eval_sequence(     # the 150-frame walk
        "dynamic_640_3walkers_fastrot", cfg, dev)
    frames = frames[:args.frames]
    rgb = chip_smoke._rgb
    s = System(cfg, device=dev)
    start = args.frames - args.window
    for g, d in frames[:start]:
        s.track_rgbd(g, d, rgb=rgb(g))
    window = frames[start:]
    n = len(window)

    hamming_cuda.hamming_kernel.launches = 0
    kf0 = s.tracker.n_kf
    result = {"whole track_rgbd": _profiled(
        lambda: [s.track_rgbd(g, d, rgb=rgb(g)) for g, d in window], n)}
    k1_per_frame = hamming_cuda.hamming_kernel.launches / n
    keyframes = s.tracker.n_kf - kf0

    result["detector"] = _profiled(
        lambda: [s.detector.detect(rgb(g), w, h) for g, _ in window], n)
    result["extract_frame"] = _profiled(
        lambda: [tracking.extract_frame(cfg, g, d, dev) for g, d in window],
        n)
    feats = [tracking.extract_frame(cfg, g, d, dev) for g, d in window]
    boxes = [s.detector.detect(rgb(g), w, h) for g, _ in window]
    fe = SemanticFrontend(cfg, seed=7, device=dev)

    def run_cull():
        for i in range(1, n):
            fe.push(window[i - 1][0], feats[i - 1], boxes[i - 1][2])
            fe.cull(window[i][0], feats[i], boxes[i][1], True)

    result["cull"] = _profiled(run_cull, n - 1)
    mapper = SemanticMapper(cfg, device=dev)
    result["mapping (keyframe insertion)"] = _profiled(
        lambda: [mapper.insert_keyframe(g, d, s.tracker.Tcw, boxes[i][2],
                                        boxes[i][3])
                 for i, (g, d) in enumerate(window[:3])], 3)
    smi = timing.card(0)
    out = {"device": smi, "torch": torch.__version__, "window_frames": n,
           "frame_range": [start, args.frames],
           "keyframes_in_window": keyframes,
           "k1_launches_per_frame": k1_per_frame, "state": s.state,
           "stages": result}
    path = args.out or "build/profile_torch_system.json"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[profile] system window: frames {start}-{args.frames}, "
          f"{keyframes} keyframes, K1 {k1_per_frame:.2f} launches/frame, "
          f"state {s.state}")
    for name, r in result.items():
        _print_stage(name, r)
    print(json.dumps({"device": smi, "k1_launches_per_frame": k1_per_frame}))
    return 0


def profile_chunk(args, dev) -> int:
    cfg = config.synthetic_config(640, 480)
    warm = bench.WARM_CHUNKS
    _, ct, g, d = bench.setup(dev, cfg, warm + args.chunks)
    for c in range(warm):
        ct.process_chunk(g[c], d[c])
    ct.flush()
    kf0 = ct._next_kf_host
    hamming_cuda.hamming_kernel.launches = 0

    def run():
        for c in range(warm, warm + args.chunks):
            ct.process_chunk(g[c], d[c])
        ct.flush()

    n = args.chunks * bench.CHUNK
    r = _profiled(run, n)
    smi = timing.card(0)
    out = {"device": smi, "torch": torch.__version__, "chunks": args.chunks,
           "frames": n, "keyframes": ct._next_kf_host - kf0,
           "loops_closed": ct.loops_closed,
           "k1_launches_per_frame": hamming_cuda.hamming_kernel.launches / n,
           "dtoh_copies_per_chunk": r["dtoh_copies_per_frame"]
           * bench.CHUNK, "profile": r}
    path = args.out or "build/profile_torch_chunk.json"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[profile] chunked pipeline, {args.chunks} chunks of "
          f"{bench.CHUNK} after {warm} warm chunks: "
          f"{out['keyframes']} keyframes, K1 "
          f"{out['k1_launches_per_frame']:.2f} launches/frame, "
          f"{out['dtoh_copies_per_chunk']:.1f} device-to-host copies/chunk")
    _print_stage("chunked pipeline", r)
    print(json.dumps({"device": smi, "dtoh_copies_per_chunk":
                      out["dtoh_copies_per_chunk"]}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="tracking",
                    choices=["tracking", "system", "chunk"])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--chunks", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_tracking: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.mode == "system":
        return profile_system(args, dev)
    if args.mode == "chunk":
        return profile_chunk(args, dev)
    args.out = args.out or "build/profile_torch_tracking.json"

    cfg = config.synthetic_config(640, 480)
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=args.frames,
                                      device=dev)
    frames = [seq.frame(i) for i in range(args.frames)]
    # a first pass over the whole sequence: the reference trajectory for
    # the run-to-run check below
    first = tracking.Tracker(cfg, local_ba_every=10 ** 9, device=dev)
    for gray, depth in frames:
        first.process(gray, depth)

    tr = tracking.Tracker(cfg, local_ba_every=10 ** 9, device=dev)
    start = args.frames - args.window
    for gray, depth in frames[:start]:
        tr.process(gray, depth)
    window = frames[start:]
    feats = [tracking.extract_frame(cfg, g, d, device=dev) for g, d in window]

    def run_extract():
        for g, d in window:
            tracking.extract_frame(cfg, g, d, device=dev)

    def run_track():
        for f in feats:
            tr.process(None, None, feats=f)

    hamming_cuda.hamming_kernel.launches = 0
    extract = _profiled(run_extract, len(window))
    track = _profiled(run_track, len(window))
    k1_per_frame = hamming_cuda.hamming_kernel.launches / len(window)

    def backend(cfg_b, m, kf):
        tracking.process_new_keyframe(cfg_b, m, kf)   # first-use set-up
        return _profiled(lambda: [tracking.process_new_keyframe(cfg_b, m, kf)
                                  for _ in range(args.passes)], args.passes)

    backend_main = backend(cfg, tr.map, tr.last_kf_id)
    m_eval, _ = checkpoint.load_map(os.path.join(ROOT, chip_smoke.EVAL_MAP),
                                    device=dev)
    backend_eval = backend(chip_smoke.eval_config(), m_eval,
                           int(torch.nonzero(m_eval.kf_valid).max()))
    smi = timing.card(0)
    repeat_diff = float(abs(tr.poses_cw() - first.poses_cw()).max())
    result = {"device": smi, "torch": torch.__version__,
              "repeat_pose_max_abs_diff": repeat_diff,
              "window_frames": len(window), "frame_range": [start,
                                                            args.frames],
              "k1_launches_per_frame": k1_per_frame,
              "extract_frame": extract, "track": track,
              "backend_pass_main_map": backend_main,
              "backend_pass_eval_map": backend_eval,
              "tracker_state": tr.state}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    # the "_per_frame" keys of the back-end entries are per pass
    for name in ("extract_frame", "track", "backend_pass_main_map",
                 "backend_pass_eval_map"):
        _print_stage(name, result[name],
                     "pass" if name.startswith("backend") else "frame")
    print(f"[profile] second pass vs first: poses differ by at most "
          f"{repeat_diff:.3g}")
    print(json.dumps({"device": smi, "k1_launches_per_frame":
                      result["k1_launches_per_frame"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
