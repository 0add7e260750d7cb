"""Steady-state sweep of the chunked semantic pipeline on the card.

    python -m sgslam_tpu_torch.bench_sweep [--chunks 4,8] [--depths 0,1]
        [--frames 110] [--stages] [--cpu]

Port of `tools/bench_sweep.py`. For each (chunk, depth) it runs the
walking-person scene at 640x480 (rendered on the card) through
`ChunkedSemanticTracker(chunk=chunk, fetch_every=depth + 1)`: 6 bootstrap
frames, two untimed chunks, then the rest of the sequence timed by the
host clock to the final flush and a synchronize; one JSON line per
configuration with frames/s and the least inlier count. `--stages` times
instead, per chunk size, ORB extraction of one chunk's frames, the
detector over the chunk (`detect_batch`, what the chunk's detector stage
runs) and one whole chunk function call on the bootstrapped map (map and
carry fed back), each 10 times after one untimed call, as the median per
call (CUDA events on the card, the host clock on the CPU; the reference
took the mean of 10 calls back to back).

The reference's `SGSLAM_HAMMING` switch is not ported: the port's
searches have one formulation on the card, the fused search K1s
(`csrc/hamming_search.cu`), and each row says so (`"hamming": "k1s"`;
`"plain"` on the CPU). Every line carries the card's name and power
limit. Without a card and without `--cpu` it exits non-zero and prints no
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

N_BOOT = 6
STAGE_RUNS = 10
CHUNKS, DEPTHS, FRAMES = "4,8", "0,1", 110      # the tool's defaults


def make_config():
    return config.synthetic_config(width=640, height=480)


def _chunks(frames, chunk):
    """(grays, depths) [n_chunks, chunk, H, W] of the frames."""
    n_chunks = len(frames) // chunk
    fr = frames[:n_chunks * chunk]
    H, W = fr[0][0].shape
    return (torch.stack([f[0] for f in fr]).reshape(n_chunks, chunk, H, W),
            torch.stack([f[1] for f in fr]).reshape(n_chunks, chunk, H, W))


def run_config(cfg, detector, frames, chunk: int, depth: int, device,
               n_boot: int = N_BOOT):
    """(frames/s, min inliers) of the steady-state chunk loop."""
    from .slam import scan_pipeline

    ct = scan_pipeline.ChunkedSemanticTracker(
        cfg, detector, chunk=chunk, fetch_every=depth + 1, device=device)
    for i in range(n_boot):
        ct.bootstrap(*frames[i])
    if ct.inner.state != "OK":
        raise AssertionError("bench_sweep: the tracker failed to initialize")
    g, d = _chunks(frames[n_boot:], chunk)
    if g.shape[0] < 3:
        raise ValueError(f"bench_sweep: {len(frames)} frames leave fewer "
                         f"than 3 chunks of {chunk} after {n_boot} "
                         "bootstrap frames")
    ct.process_chunk(g[0], d[0])
    ct.process_chunk(g[1], d[1])
    timing.sync(device)
    t0 = time.perf_counter()
    n_steps = 0
    for c in range(2, g.shape[0]):
        ct.process_chunk(g[c], d[c])
        n_steps += chunk
    ct.flush()
    timing.sync(device)
    return n_steps / (time.perf_counter() - t0), min(ct.n_inliers_hist)


def stage_timings(cfg, detector, frames, chunk: int, device) -> dict:
    """ms per chunk of extraction, the detector and one chunk call."""
    from .slam import scan_pipeline, tracking

    g, d = _chunks(frames[:chunk], chunk)
    g, d = g[0], d[0]
    W, H = cfg.camera.width, cfg.camera.height
    out = {"extract_batch_ms": timing.event_ms(
        lambda: [tracking.extract_frame(cfg, g[j], d[j], device)
                 for j in range(chunk)], STAGE_RUNS, 1, device)}
    if detector is not None:
        out["detector_batch_ms"] = timing.event_ms(
            lambda: detector.detect_batch(g, W, H), STAGE_RUNS, 1, device)
    ct = scan_pipeline.ChunkedSemanticTracker(cfg, detector, chunk=chunk,
                                              device=device)
    for i in range(N_BOOT):
        ct.bootstrap(*frames[i])

    def one_chunk():
        r = ct._fn(ct._map, ct._carry, g, d)
        ct._map, ct._carry = r[0], r[1]

    out["chunk_total_ms"] = timing.event_ms(one_chunk, STAGE_RUNS, 1,
                                            device)
    out["per_frame_ms"] = out["chunk_total_ms"] / chunk
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", default=CHUNKS)
    ap.add_argument("--depths", default=DEPTHS)
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    a = ap.parse_args(argv)
    dev = timing.measurement_device(a.cpu, "bench_sweep")

    from .io import synthetic
    from .models.detector import Detector2D

    label = timing.card(dev)
    cfg = make_config()
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=a.frames,
                                      dynamic=True, device=dev)
    frames = [seq.frame(i) for i in range(a.frames)]
    detector = Detector2D(cfg.detector, device=dev)
    chunks = [int(c) for c in a.chunks.split(",")]
    if a.stages:
        for chunk in chunks:
            st = stage_timings(cfg, detector, frames, chunk, dev)
            print(json.dumps({"chunk": chunk, **st, "device": label}),
                  flush=True)
        return 0
    for chunk in chunks:
        for depth in [int(x) for x in a.depths.split(",")]:
            fps, min_inl = run_config(cfg, detector, frames, chunk, depth,
                                      dev)
            print(json.dumps({
                "chunk": chunk, "depth": depth, "fps": fps,
                "min_inliers": int(min_inl),
                "hamming": "k1s" if dev.type == "cuda" else "plain",
                "device": label}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
