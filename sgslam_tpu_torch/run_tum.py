"""Dataset runner CLI: load a TUM RGB-D sequence through the native PNG
prefetcher, run the semantic SLAM system frame by frame (or chunk by
chunk), save TUM-format trajectories, evaluate ATE against ground truth,
and print one JSON summary line.

Port of `sgslam_tpu/run_tum.py` (the reference's rgbd_tum example), with
the same flags and the same summary keys. It runs on the GPU; `--cpu` runs
it on the CPU.

Usage:
  python -m sgslam_tpu_torch.run_tum <seq_dir> [assoc.txt] [--preset tum3] ...
  python -m sgslam_tpu_torch.run_tum --synthetic 300 --seq-dir /tmp/seq ...

`--synthetic N` first renders an N-frame synthetic sequence (on the run's
device) and writes it to disk as 8-bit gray + 16-bit depth PNGs, then runs
the identical dataset path end to end: the hermetic stand-in when no TUM
data is at hand.

The run switches the program's tracer on (`utils/timing.Metrics`) and
prints to standard error each span's count, median and p90 in host ms
between the span's edges (on the GPU a span without a host read in it
times the host's enqueue, not the device's work), then the counters.
`median_track_ms` is the median of the `tracking.step` spans.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _make_synthetic_dataset(seq_dir: str, n_frames: int, preset_cam,
                            dynamic: bool, circuit: bool, device):
    """Render a sequence and persist it in TUM on-disk layout."""
    from .io import native, synthetic

    os.makedirs(os.path.join(seq_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "depth"), exist_ok=True)
    poses = (synthetic.make_circuit_trajectory(n_frames, loops=1.05,
                                               device=device)
             if circuit else None)
    planes = synthetic.ROOM_CLOSED if circuit else synthetic.ROOM
    seq = synthetic.SyntheticSequence(preset_cam, n_frames=n_frames,
                                      dynamic=dynamic, planes=planes,
                                      poses=poses, device=device)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i in range(n_frames):
        gray, depth = seq.frame(i)
        t = seq.timestamps[i]
        g8 = torch.clamp(gray * 255.0, 0, 255).cpu().numpy().astype(np.uint8)
        d16 = torch.clamp(depth * 5000.0, 0, 65535).cpu().numpy().astype(
            np.uint16)
        rp, dp = f"rgb/{t:.6f}.png", f"depth/{t:.6f}.png"
        native.png_write(os.path.join(seq_dir, rp), g8)
        native.png_write(os.path.join(seq_dir, dp), d16)
        rgb_lines.append(f"{t:.6f} {rp}")
        depth_lines.append(f"{t:.6f} {dp}")
        T = seq.gt_pose_wc(i).cpu().numpy()     # (qw qx qy qz tx ty tz)
        gt_lines.append(
            f"{t:.6f} {T[4]:.6f} {T[5]:.6f} {T[6]:.6f} "
            f"{T[1]:.6f} {T[2]:.6f} {T[3]:.6f} {T[0]:.6f}")
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(seq_dir, name), "w") as f:
            f.write("# synthetic sequence\n" + "\n".join(lines) + "\n")
    return seq_dir


def _evaluate_ate(seq_dir: str, timestamps, poses_cw):
    """ATE RMSE vs groundtruth.txt (nearest-timestamp association)."""
    from .eval import ate
    from .geometry import se3
    from .io import tum as tum_io

    gt_path = os.path.join(seq_dir, "groundtruth.txt")
    if not os.path.exists(gt_path):
        return None
    gt_ts, gt_wc = tum_io.load_groundtruth(gt_path)
    ia, ib = ate.associate_by_time(np.asarray(timestamps), gt_ts)
    if len(ia) < 3:
        return None
    est_wc = se3.se3_inverse(
        torch.as_tensor(np.asarray(poses_cw)[ia])).numpy()
    rmse, _, _ = ate.ate_rmse(est_wc, gt_wc[ib])
    return float(rmse)


class AsyncVizExporter:
    """Background visualization writer: frames + keypoints stream through
    the native ByteQueue (GIL-releasing, native/runtime.cc) to a worker
    thread that draws overlays and encodes PNGs, an export stage that never
    blocks tracking (the reference's viewer thread)."""

    def __init__(self, out_dir: str, every: int = 10):
        import pickle
        import threading

        from .io import native

        self.out_dir = out_dir
        self.every = every
        self._pickle = pickle
        os.makedirs(out_dir, exist_ok=True)
        self.q = native.ByteQueue(capacity=4)
        self.dropped = 0
        self.written = 0
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def submit(self, i: int, gray, xy, valid, culled=None):
        from .viz import to_numpy

        if i % self.every:
            return
        msg = self._pickle.dumps(
            (i, to_numpy(gray), to_numpy(xy), to_numpy(valid),
             None if culled is None else to_numpy(culled)))
        if not self.q.try_push(msg):  # full: drop rather than stall tracking
            self.dropped += 1

    def _worker(self):
        from . import viz

        while True:
            msg = self.q.pop()
            if msg is None:
                return
            i, gray, xy, valid, culled = self._pickle.loads(msg)
            viz.save_frame(os.path.join(self.out_dir, f"frame_{i:06d}.png"),
                           gray, xy, valid, culled)
            self.written += 1

    def close(self, map_state=None, trajectory_cw=None):
        self.q.close()
        self._t.join(timeout=30)
        if map_state is not None:
            from . import viz

            viz.save_map_topdown(
                os.path.join(self.out_dir, "map_topdown.png"), map_state,
                trajectory_cw=trajectory_cw)


def _run_chunked(args, cfg, seq, seq_dir: str, n: int, dev):
    """The real-time configuration: the chunked pipeline with loop closing,
    relocalization and semantic mapping at the drain boundary
    (slam/scan_pipeline)."""
    from .io import trajectory as traj_io
    from .slam import scan_pipeline
    from .slam.loop_closing import LoopCloser

    semantic = not args.no_semantic and not args.no_detector
    detector = None
    if semantic:
        from .models.detector import Detector2D

        detector = Detector2D(cfg.detector, device=dev)
    loop = None if args.no_loop else LoopCloser(cfg, device=dev)
    mapper = None
    if not args.no_mapping:
        from .mapping.semantic_mapper import SemanticMapper

        mapper = SemanticMapper(cfg, device=dev)

    for flag in ("viz", "serve"):
        if getattr(args, flag):
            print(f"warning: --{flag} is not supported in --chunked mode; "
                  f"ignored", file=sys.stderr)

    cls = (scan_pipeline.ChunkedSemanticTracker if semantic
           else scan_pipeline.ChunkedTracker)
    kw = dict(chunk=args.chunk, fetch_every=args.fetch_every, loop=loop,
              mapper=mapper, device=dev,
              only_tracking=bool(args.load_map and args.localize_only))
    ct = (cls(cfg, detector, **kw) if semantic else cls(cfg, **kw))
    ct.metrics.start()
    if args.load_map:
        ct.load_checkpoint(args.load_map)
        print(f"restored map: {args.load_map} "
              f"({ct.inner.n_kf} keyframes)", file=sys.stderr)

    t_start = time.perf_counter()
    t_steady = None
    n_at_steady = 0
    buf_g, buf_d = [], []
    n_done = 0
    for i, gray, depth, _ in seq.prefetch():
        if i >= n:
            break
        if ct._carry is None:
            ct.bootstrap(gray, depth)
            n_done += 1
            continue
        buf_g.append(gray)
        buf_d.append(depth)
        if len(buf_g) == args.chunk:
            ct.process_chunk(torch.stack(buf_g), torch.stack(buf_d))
            n_done += args.chunk
            buf_g, buf_d = [], []
            if t_steady is None:
                t_steady = time.perf_counter()   # exclude the first chunk
                n_at_steady = n_done
    if buf_g:   # trailing partial chunk: tracked, not dropped
        ct.process_tail(torch.stack(buf_g), torch.stack(buf_d))
        n_done += len(buf_g)
    ct.flush()
    wall = time.perf_counter() - t_start
    steady = time.perf_counter() - (t_steady or t_start)
    fps = (n_done - n_at_steady) / steady if steady > 0 else 0.0

    os.makedirs(args.out, exist_ok=True)
    if args.save_map:
        ct.save_checkpoint(args.save_map)
        print(f"saved map: {args.save_map}", file=sys.stderr)
    poses = ct.poses_cw()
    ts = [float(seq.timestamps[i]) for i in range(len(poses))]
    traj_path = os.path.join(args.out, "CameraTrajectory.txt")
    traj_io.save_tum(traj_path, ts, poses)
    m = ct.map
    valid = m.kf_valid.cpu().numpy()
    kf_ts = [float(seq.timestamps[min(int(f), n - 1)])
             for f in m.kf_frame_id.cpu().numpy()[valid]]
    traj_io.save_tum(os.path.join(args.out, "KeyFrameTrajectory.txt"),
                     kf_ts, m.kf_pose.cpu().numpy()[valid])
    ate_rmse = _evaluate_ate(seq_dir, ts, poses)
    print(ct.metrics.report(), file=sys.stderr)
    result = {
        "mode": "chunked", "frames": n_done, "fps": round(fps, 2),
        "wall_s": round(wall, 2), "state": "OK"
        if (ct.n_inliers_hist and ct.n_inliers_hist[-1]
            >= cfg.tracker.min_inliers_local_map) else "LOST",
        "keyframes": int(valid.sum()),
        "lost_frames": int(ct.lost_mask().sum()),
        "loops_closed": ct.loops_closed, "relocalizations": ct.relocs,
        "objects": (int(mapper.objects.valid.sum())
                    if mapper is not None else None),
        "ate_rmse_m": (round(ate_rmse, 4)
                       if ate_rmse is not None else None),
        "trajectory": traj_path,
    }
    print(json.dumps(result))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Run the SLAM system over a TUM RGB-D sequence")
    ap.add_argument("seq_dir", nargs="?", default=None)
    ap.add_argument("assoc", nargs="?", default=None,
                    help="association file (rgb<->depth); auto if omitted")
    ap.add_argument("--preset", default="tum3",
                    choices=["tum1", "tum2", "tum3", "bonn", "openloris",
                             "astra_pro", "synthetic"])
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="generate an N-frame synthetic dataset first")
    ap.add_argument("--seq-dir", dest="seq_dir_opt", default=None)
    ap.add_argument("--dynamic", action="store_true",
                    help="synthetic: include a walking person")
    ap.add_argument("--circuit", action="store_true",
                    help="synthetic: closed-room loop circuit")
    ap.add_argument("--no-semantic", action="store_true")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--no-mapping", action="store_true")
    ap.add_argument("--no-detector", action="store_true")
    ap.add_argument("--chunked", action="store_true",
                    help="run the chunked real-time path "
                         "(slam/scan_pipeline) instead of per-frame System")
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--fetch-every", type=int, default=6)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--viz", default=None, metavar="DIR",
                    help="async keypoint-overlay PNG export directory")
    ap.add_argument("--viz-every", type=int, default=10)
    ap.add_argument("--serve", type=int, default=0, metavar="PORT",
                    help="start the live HTTP viewer on PORT "
                         "(sgslam_tpu_torch.viewer; browse to /)")
    ap.add_argument("--save-map", default=None, metavar="PATH",
                    help="save the final map + keyframe database")
    ap.add_argument("--load-map", default=None, metavar="PATH",
                    help="restore a saved map before tracking starts")
    ap.add_argument("--localize-only", action="store_true",
                    help="with --load-map: freeze the map and only track")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)
    if args.localize_only and not args.load_map:
        ap.error("--localize-only requires --load-map (there is no map to "
                 "localize against)")

    from . import config as config_mod
    from . import resolve_device
    from .io.tum import TumSequence
    from .slam.system import System

    dev = resolve_device("cpu" if args.cpu else "cuda")
    seq_dir = args.seq_dir or args.seq_dir_opt
    if args.synthetic:
        if seq_dir is None:
            seq_dir = os.path.join(args.out, "synthetic_seq")
        preset = config_mod.synthetic_config()
        if not os.path.exists(os.path.join(seq_dir, "rgb.txt")):
            print(f"rendering {args.synthetic} synthetic frames "
                  f"-> {seq_dir}", file=sys.stderr)
            _make_synthetic_dataset(seq_dir, args.synthetic, preset.camera,
                                    args.dynamic, args.circuit, dev)
        cfg = preset
    else:
        if seq_dir is None:
            ap.error("seq_dir required (or --synthetic N)")
        cfg = getattr(config_mod, f"{args.preset}_config")() \
            if args.preset != "synthetic" else config_mod.synthetic_config()

    seq = TumSequence(seq_dir, args.assoc,
                      depth_factor=cfg.depth_map_factor
                      if not args.synthetic else 5000.0, device=dev)
    n = len(seq) if not args.max_frames else min(len(seq), args.max_frames)
    print(f"sequence: {seq_dir} ({n} frames) on {dev}", file=sys.stderr)

    if args.chunked:
        return _run_chunked(args, cfg, seq, seq_dir, n, dev)

    system = System(cfg,
                    enable_semantic=not args.no_semantic,
                    enable_loop=not args.no_loop,
                    enable_mapping=not args.no_mapping, device=dev)
    if args.no_detector:
        system.detector = None
    system.metrics.start()
    if args.load_map:
        system.load_checkpoint(args.load_map,
                               localization_only=args.localize_only)
        print(f"restored map: {args.load_map} "
              f"({system.tracker.n_kf} keyframes)", file=sys.stderr)

    viz_exp = (AsyncVizExporter(args.viz, args.viz_every)
               if args.viz else None)
    live = None
    if args.serve:
        from .viewer import LiveViewer

        live = LiveViewer(port=args.serve).start()
        print(f"live viewer: http://127.0.0.1:{live.port}/",
              file=sys.stderr)
    t_start = time.perf_counter()
    t_first = None
    for i, gray, depth, rgb in seq.prefetch():
        if i >= n:
            break
        rgb_in = None
        if system.detector is not None:
            rgb_in = (gray[..., None].expand(-1, -1, 3) if rgb.ndim == 2
                      else rgb.to(torch.float32) / 255.0)
        system.track_rgbd(gray, depth, rgb=rgb_in,
                          timestamp=float(seq.timestamps[i]))
        if viz_exp is not None and system.last_feats is not None:
            f = system.last_feats
            viz_exp.submit(i, gray, f.xy_raw, f.valid)
        if live is not None and system.last_feats is not None:
            f = system.last_feats
            live.publish_frame(gray, f.xy_raw, f.valid)
            if i % 30 == 0:
                live.publish_map(system.tracker.map)
                if system.mapper is not None:
                    live.publish_occupancy(system.mapper.occupancy_2d())
            live.publish_stats(frame=i, state=system.state,
                               keyframes=system.tracker.n_kf)
        if t_first is None:
            t_first = time.perf_counter()   # exclude the first frame
    system.shutdown()
    if live is not None:
        live.publish_map(system.tracker.map)
        live.stop()
    if viz_exp is not None:
        viz_exp.close(system.tracker.map,
                      trajectory_cw=system.tracker.poses_cw())
        print(f"viz: {viz_exp.written} overlays written "
              f"({viz_exp.dropped} dropped) -> {args.viz}", file=sys.stderr)
    wall = time.perf_counter() - t_start
    steady = time.perf_counter() - (t_first or t_start)
    fps = (n - 1) / steady if n > 1 and steady > 0 else 0.0

    os.makedirs(args.out, exist_ok=True)
    if args.save_map:
        system.save_checkpoint(args.save_map)
        print(f"saved map: {args.save_map}", file=sys.stderr)
    traj_path = os.path.join(args.out, "CameraTrajectory.txt")
    kf_path = os.path.join(args.out, "KeyFrameTrajectory.txt")
    system.save_trajectory_tum(traj_path)
    system.save_keyframe_trajectory_tum(kf_path)

    ate_rmse = _evaluate_ate(seq_dir, system.timestamps,
                             system.tracker.poses_cw())
    print(system.metrics.report(), file=sys.stderr)
    track = system.metrics.span_stats().get("tracking.step", (0, 0.0))
    result = {
        "frames": n,
        "fps": round(fps, 2),
        "wall_s": round(wall, 2),
        "median_track_ms": round(track[1], 2),
        "state": system.state,
        "keyframes": int(system.tracker.map.kf_valid.sum()),
        "loops_closed": (len(system.loop.loops_closed)
                         if system.loop else 0),
        "ate_rmse_m": (round(ate_rmse, 4)
                       if ate_rmse is not None else None),
        "trajectory": traj_path,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
