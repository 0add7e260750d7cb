"""Build a tracked map at production scale and save it.

    python -m sgslam_tpu_torch.build_eval_map [--out PATH] [--frames N]
        [--cpu]

The port's counterpart of `tools/build_eval_map.py`: the chunked tracker
(`ChunkedTracker(chunk=4, fetch_every=6)`) runs over 1000 frames of a close
11x16 m hall at 640x480, just under one lap of a wavy circuit past a ring of
36 textured props, at 2048 features and 2176 keypoints per frame, 288
keyframe slots, 32768 points, a 16+8 window and 4096 local points, with a
keyframe at least every 2 frames. The map must pass the reference's scale
gate (>= 128 keyframes, >= 8000 live points, >= 50000 observations: the
steady state of the maintenance pipeline at 2048 features, which culling
and fusion keep from growing with sequence length) and is written with
`io/checkpoint.save_map`, whose layout the JAX package's `load_map` reads.

It runs on the GPU; `--cpu` runs it on the CPU. The default output is
`build/eval_map_torch.npz`; it never writes the packaged
`sgslam_tpu/assets/eval_map.npz`.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import config, resolve_device
from .io import synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "sgslam_tpu", "assets", "eval_map.npz")
CHUNK = 4
MIN_KF, MIN_PT, MIN_OBS = 128, 8000, 50000


def scene(n: int):
    """(cfg, planes, poses [n, 7] T_wc, props [36, 7]) of the n-frame
    build: the hall, the circuit of radius 3 +- 0.25 m with a 0.2 m height
    wave, and the prop ring drawn from `default_rng(3)`."""
    cfg = config.synthetic_config(
        width=640, height=480,
        orb=config.OrbConfig(n_features=2048, max_keypoints=2176),
        tracker=config.TrackerConfig(max_frames_between_kf=2,
                                     depth_threshold_factor=150.0),
        capacity=config.MapCapacity(max_keyframes=288, max_points=32768,
                                    local_window=16, local_points=4096))
    hall = (
        synthetic.Plane(0.0, 0.0, -1.0, -8.0, 1.0),
        synthetic.Plane(0.0, 0.0, 1.0, -8.0, 4.0),
        synthetic.Plane(1.0, 0.0, 0.0, -6.0, 3.0),
        synthetic.Plane(-1.0, 0.0, 0.0, -6.0, 5.0),
        synthetic.Plane(0.0, -1.0, 0.0, -1.0, 2.0),
        synthetic.Plane(0.0, 1.0, 0.0, -1.5, 6.0),
    )
    base = synthetic.make_circuit_trajectory(n, radius=1.0,
                                             loops=0.95).numpy()
    s = np.linspace(0.0, 1.0, n, dtype=np.float32)
    radius = 3.0 + 0.25 * np.sin(2 * np.pi * s)
    height = 0.2 * np.sin(2 * np.pi * s * 1.1)
    t = base[:, 4:7] * radius[:, None]
    t[:, 1] += height
    poses = torch.from_numpy(np.concatenate([base[:, :4], t], axis=1))
    rng = np.random.default_rng(3)
    Q = 36
    ang = np.linspace(0, 2 * np.pi, Q, endpoint=False)
    ring_r = rng.uniform(4.4, 5.6, Q)
    props = np.stack([
        ring_r * np.sin(ang),                       # cx
        rng.uniform(-0.6, 1.1, Q),                  # cy
        ring_r * np.cos(ang) - 2.0,                 # cz (hall is z-offset)
        rng.uniform(0.22, 0.45, Q),                 # half_w
        rng.uniform(0.25, 0.5, Q),                  # half_h
        rng.integers(1, 10, Q).astype(np.float64),  # cls (texture family)
        rng.uniform(3.0, 40.0, Q),                  # seed
    ], axis=1).astype(np.float32)
    return cfg, hall, poses, props


def build(n: int, device="cuda"):
    """Track the n-frame scene (bootstrap, then whole chunks of 4; a last
    partial chunk is dropped, as in the reference). Returns (map, counts)."""
    from .slam import scan_pipeline

    dev = resolve_device(device)
    cfg, hall, poses, props = scene(n)
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=n, planes=hall,
                                      poses=poses, props=props, device=dev)
    ct = scan_pipeline.ChunkedTracker(cfg, chunk=CHUNK, fetch_every=6,
                                      device=dev)
    i = 0
    while ct._carry is None and i < n:
        ct.bootstrap(*seq.frame(i))
        i += 1
    while i + CHUNK <= n:
        frames = [seq.frame(j) for j in range(i, i + CHUNK)]
        ct.process_chunk(torch.stack([f[0] for f in frames]),
                         torch.stack([f[1] for f in frames]))
        i += CHUNK
    ct.flush()
    m = ct.map
    kf_valid = m.kf_valid.cpu()
    counts = {"keyframes": int(kf_valid.sum()),
              "points": int(m.pt_valid.sum()),
              "observations": int(((m.kf_obs_point.cpu() >= 0)
                                   & kf_valid[:, None]).sum()),
              "lost_frames": int(ct.lost_mask().sum())}
    return m, counts


def main(argv=None):
    from .io import checkpoint as ckpt

    ap = argparse.ArgumentParser(description="build the production-scale "
                                 "tracked map")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "eval_map_torch.npz"))
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.abspath(ASSET):
        raise SystemExit(f"refusing to overwrite the reference's {ASSET}")
    dev = resolve_device("cpu" if args.cpu else "cuda")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    m, c = build(args.frames, dev)
    wall = time.perf_counter() - t0
    print(f"tracked map: {c['keyframes']} keyframes, {c['points']} points, "
          f"{c['observations']} observations, lost {c['lost_frames']} "
          f"frames, {args.frames} frames in {wall:.1f} s on {dev}")
    if not (c["keyframes"] >= MIN_KF and c["points"] >= MIN_PT
            and c["observations"] >= MIN_OBS):
        raise SystemExit(f"the map fails the scale gate (>= {MIN_KF} "
                         f"keyframes, >= {MIN_PT} points, >= {MIN_OBS} "
                         f"observations): {c}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    ckpt.save_map(args.out, m, {})
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    return c


if __name__ == "__main__":
    main()
