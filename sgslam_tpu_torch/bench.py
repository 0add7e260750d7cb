"""The port's benchmark: steady-state throughput of the full
semantic pipeline on the card.

    python -m sgslam_tpu_torch.bench [--cpu]

Port of the repository's `bench.py`. It prints ONE JSON line with that
script's four keys, {"metric", "value", "unit", "vs_baseline"}, where the
baseline is 30 frames/s (the reference's real-time envelope, BASELINE.md).
The card's name and power limit (nvidia-smi) go to stderr before it.

The measured step is the whole per-frame semantic SLAM pipeline at TUM
geometry (640x480, 1000 ORB features) on a dynamic scene, four frames per
chunk through `ChunkedSemanticTracker(cfg, Detector2D, chunk=4,
fetch_every=6, loop=LoopCloser(cfg))`: SSD person detection, pyramid ORB
extraction, ORB flow + F-RANSAC + epipolar dynamic-feature rejection,
local-map association, the two motion-only BAs, the keyframe decision and,
on keyframes, insertion, culling, triangulation, fusion, windowed local BA,
keyframe culling and the keyframe database with loop detection. Results
are drained every 6 chunks.

Method, as bench.py's: 6 bootstrap frames of the walking-person scene
(rendered on the card), then `WARM_CHUNKS` chunks and a flush untimed;
the timed region is one continuous pass over the next `TIMED_CHUNKS`
chunks including every drain and the final flush, ended by a synchronize.
Tracking must keep at least 30 inliers on every frame (bench.py's assert).

It runs on the card; `--cpu` runs it on the CPU, and stderr then says
"cpu". Without a card and without `--cpu` it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import config
from .utils import timing

CHUNK = 4
FETCH_EVERY = 6
WARM_CHUNKS = 2 * FETCH_EVERY        # two full drain windows + flush
TIMED_CHUNKS = 24
N_BOOT = 6
MIN_INLIERS = 30
BASELINE_FPS = 30.0
METRIC = "full_semantic_pipeline_fps_640x480_1000feat"


def make_config():
    """bench.py's configuration: the synthetic room at 640x480."""
    return config.synthetic_config(width=640, height=480)


def setup(device, cfg, n_chunks: int):
    """The scene rendered on `device` (N_BOOT + n_chunks * CHUNK frames),
    the chunks stacked once, and the chunked semantic tracker with a loop
    closer, bootstrapped on the first N_BOOT frames. Returns (sequence,
    tracker, grays [n_chunks, CHUNK, H, W], depths)."""
    from .io import synthetic
    from .models.detector import Detector2D
    from .slam import scan_pipeline
    from .slam.loop_closing import LoopCloser

    H, W = cfg.camera.height, cfg.camera.width
    n_frames = N_BOOT + n_chunks * CHUNK
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=n_frames,
                                      dynamic=True, device=device)
    frames = [seq.frame(i) for i in range(n_frames)]
    g = torch.stack([f[0] for f in frames[N_BOOT:]]).reshape(
        n_chunks, CHUNK, H, W)
    d = torch.stack([f[1] for f in frames[N_BOOT:]]).reshape(
        n_chunks, CHUNK, H, W)
    timing.sync(device)
    ct = scan_pipeline.ChunkedSemanticTracker(
        cfg, Detector2D(cfg.detector, device=device), chunk=CHUNK,
        fetch_every=FETCH_EVERY, loop=LoopCloser(cfg, device=device),
        device=device)
    for i in range(N_BOOT):
        ct.bootstrap(*frames[i])
    if ct.inner.state != "OK":
        raise AssertionError("bench: the tracker failed to initialize")
    return seq, ct, g, d


def run(device, cfg=None, warm: int = WARM_CHUNKS,
        timed: int = TIMED_CHUNKS, before_timed=None):
    """bench.py's schedule on `device`. `before_timed(tracker)`, if given,
    is called just before the timed region starts. Returns (frames/s,
    tracker, info): info has the sequence (`seq`), the timed seconds and
    frames, and the tracker's keyframe and loop counts at the start of the
    timed region (`kf0`, `loops0`)."""
    cfg = cfg or make_config()
    seq, ct, g, d = setup(device, cfg, warm + timed)
    for c in range(warm):
        ct.process_chunk(g[c], d[c])
    ct.flush()
    if before_timed is not None:
        before_timed(ct)
    kf0, loops0 = ct._next_kf_host, ct.loops_closed
    timing.sync(device)
    t0 = time.perf_counter()
    for c in range(warm, warm + timed):
        ct.process_chunk(g[c], d[c])
    ct.flush()
    timing.sync(device)
    dt = time.perf_counter() - t0
    fps = timed * CHUNK / dt
    if min(ct.n_inliers_hist) < MIN_INLIERS:
        raise AssertionError(f"bench: tracking lost during the run: "
                             f"{min(ct.n_inliers_hist)} inliers")
    return fps, ct, {"seq": seq, "seconds": dt, "frames": timed * CHUNK,
                     "kf0": kf0, "loops0": loops0}


def result(fps: float) -> dict:
    """bench.py's JSON line."""
    return {"metric": METRIC, "value": round(fps, 2), "unit": "frames/s",
            "vs_baseline": round(fps / BASELINE_FPS, 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    a = ap.parse_args(argv)
    dev = timing.measurement_device(a.cpu, "bench")
    print(f"bench: {timing.card(dev)}", file=sys.stderr, flush=True)
    fps, _, _ = run(dev, make_config(), WARM_CHUNKS, TIMED_CHUNKS)
    print(json.dumps(result(fps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
