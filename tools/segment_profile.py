#!/usr/bin/env python3
"""One segment sum (`sgslam_tpu_torch/ops/segment.py`) split into its
device operations, on the card, at the main path's three timed shapes (the
BA's twice: late and early in a run).

    python tools/segment_profile.py [--root DIR] [--shapes NAME,...]

The inputs are made from a numpy seed, so that two processes (two
checkouts, `--root`) get the same ones:

  ba    local BA's `_point_block_sums` on phase 10's window: values
        [24576, 30] (C = 24 keyframe slots x N = 1024 observation slots,
        rounded to bf16 as the BA rounds them), index c * 4096 + point with
        10% of the rows kept (phase 10 kept about 2500 rows per call) and 2%
        of the kept points repeated within a slot -> 98304 rows;
  ba_early  the same window early in a run, as in phase 4's first local
        BA: only the first 3 of the 24 slots hold observations, 80% of
        their rows kept, so that the kept rows reach only the first 12288
        output rows;
  scan  `occupancy.insert_scan`'s miss sum, taken from the port's own
        `insert_scan` on a synthetic cloud: 32768 endpoints, 70% valid, at
        0.5-4 m in a 60 x 45 degree frustum from near the centre of the
        128^3 grid of 0.06 m voxels that `SemanticMapper` builds: values
        [4194304] onto init -> 2097152 rows;
  gba   the global BA's `_point_block_sums` at C = 512, P = 32768: values
        [524288, 30], 64 keyframes with 60% of their 1024 observations kept
        -> 16777216 rows.

For each shape it runs chip_smoke.py's own check and timing of the
segment sum (`check_segment_sum`, `time_segment_sum`): the kernel held to
its plain version on the CPU to the bit and to a second launch, one
wrapper call timed by CUDA-graph replay beside its bound, its plain
version and `index_add_`, and the device operations of one eager call
(`torch.profiler` with CUDA activity) with their device time per call. It
prints the card's name and power limit first. With `--root` it profiles
the segment sum of another checkout (for example the parent commit
unpacked under build/) with this checkout's chip_smoke.py: run one process
per checkout, in turns, in one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np


def _ba_inputs(rng, n_slots, n_obs, n_points, cams, kept):
    slot = np.full((n_slots, n_obs), -1, np.int64)
    for c in range(cams):
        pt = rng.permutation(n_points)[:n_obs]
        dup = rng.random(n_obs) < 0.02
        pt[dup] = pt[rng.integers(0, n_obs, int(dup.sum()))]
        keep = rng.random(n_obs) < kept
        slot[c] = np.where(keep, c * n_points + pt, -1)
    values = rng.normal(size=(n_slots * n_obs, 30)).astype(np.float32)
    return values, slot.reshape(-1), n_slots * n_points


def make_inputs(name, dev):
    """(values, index, n, init) of shape `name`, on `dev`."""
    import torch

    rng = np.random.default_rng(
        {"ba": 1, "scan": 2, "gba": 3, "ba_early": 4}[name])
    if name in ("ba", "ba_early", "gba"):
        if name == "ba":
            v, i, n = _ba_inputs(rng, 24, 1024, 4096, 24, 0.1)
        elif name == "ba_early":
            v, i, n = _ba_inputs(rng, 24, 1024, 4096, 3, 0.8)
        else:
            v, i, n = _ba_inputs(rng, 512, 1024, 32768, 64, 0.6)
        v = torch.from_numpy(v).to(dev).to(torch.bfloat16).to(torch.float32)
        return v, torch.from_numpy(i).to(dev), n, None
    from sgslam_tpu_torch.mapping import occupancy

    dim, voxel = 128, 0.06
    half = dim * voxel / 2.0
    grid = occupancy.empty_grid(dim, voxel, origin=(-half,) * 3, device=dev)
    grid.logodds.copy_(torch.from_numpy(rng.normal(
        scale=0.5, size=(dim,) * 3).astype(np.float32)))
    m = 32768
    az = np.radians(rng.uniform(-30, 30, m))
    el = np.radians(rng.uniform(-22.5, 22.5, m))
    d = np.stack([np.cos(el) * np.sin(az), np.sin(el),
                  np.cos(el) * np.cos(az)], 1)
    sensor = np.array([0.1, -0.2, 0.05], np.float32)
    pts = (sensor + d * rng.uniform(0.5, 4.0, (m, 1))).astype(np.float32)
    valid = rng.random(m) < 0.7
    got = []
    original = occupancy.segment_sum

    def record(values, index, n, init=None):
        got.append((values.clone(), index.clone(), n, init.clone()))
        return original(values, index, n, init)

    occupancy.segment_sum = record
    try:
        occupancy.insert_scan(grid, torch.from_numpy(sensor).to(dev),
                              torch.from_numpy(pts).to(dev),
                              torch.from_numpy(valid).to(dev))
    finally:
        occupancy.segment_sum = original
    return got[0]


def profile_shape(name, dev, cs, segment):
    v, i, n, init = make_inputs(name, dev)
    cs.check_segment_sum(segment.segment_kernel, v, i, n, init, name)
    cs.time_segment_sum(dev, segment.segment_kernel, v, i, n, init, name)


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--shapes", default="ba,ba_early,scan,gba")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    os.chdir(root)

    import torch

    from sgslam_tpu_torch.ops import segment

    # this checkout's chip_smoke.py, whatever --root: sys.path points the
    # port's package at --root, so it is loaded from its file
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("segment_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"[segment] {root} on {cs._smi('name,power.limit')}, "
          f"torch {torch.__version__}")
    segment.segment_kernel.load(verbose=True)
    for name in a.shapes.split(","):
        profile_shape(name, dev, cs, segment)
    return 0


if __name__ == "__main__":
    sys.exit(main())
