"""Shard scaling of the distributed BA step.

    python -m sgslam_tpu_torch.bench_dist_ba [--devices 8] [--points 16384]
        [--cams 32] [--obs-per 6] [--iters 5] [--cpu]

Port of `tools/bench_dist_ba.py`. One synthetic problem (the tum3 camera,
32 cameras, 16384 points each seen by 6 cameras, exact stereo projections,
numpy seed 0 in the tool's order; `parallel.multihost.build_problem`),
started 0.02 m off in every point coordinate, is cut into 1, 2, 4 and 8
point shards ('kf' = 1, 'pt' = n) and solved with `iters` distributed LM
steps (`parallel.dist_ba.make_distributed_ba_step`, damping 1e-3) in n
spawned processes (`parallel.multihost.spawn`). Each layout runs once
untimed, then three times from start points moved by 1e-4 x rep (as the
reference moves them), and reports the mean wall time of a run, ended by
a synchronize on every rank, on rank 0's host clock.

On the card the ranks are NCCL processes, one card each, so the layouts
stop at the card count (NCCL refuses two ranks on one card; 1 on a
one-card machine). With `--cpu` they are gloo processes on the CPU, the
reference's virtual CPU mesh: their wall times are CPU times and say so.
Each layout prints one JSON line with `pt_shards`, `wall_s` and
`speedup_vs_1shard`, the device label (the card's name and power limit,
or "cpu (gloo)") and, on the card, rank 0's segment-sum launches. Without a
card and without `--cpu` it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .utils import timing

LAYOUTS = (1, 2, 4, 8)
START_OFFSET_M = 0.02
REP_STEP_M = 1e-4
LAM0 = 1e-3
REPS = 3


def problem(points: int, cams: int, obs_per: int, device="cpu"):
    """The tool's problem: (cam, poses, start points, obs_cam, obs_pt,
    obs_uvr, opt_mask, obs_w), the points already moved to the start."""
    from .parallel import multihost

    cam, poses, pts, obs_cam, obs_pt, uvr, opt_mask = \
        multihost.build_problem(points, cams, obs_per, device)
    obs_w = torch.ones(obs_cam.shape[0], device=torch.device(device))
    return (cam, poses, pts + START_OFFSET_M, obs_cam, obs_pt, uvr,
            opt_mask, obs_w)


def _worker(rank, world, dev, points, cams, obs_per, iters, reps, out_dir):
    """One rank of a 1 x world layout: the untimed run (its result saved
    per rank), then `reps` timed runs; rank 0 writes the mean wall time."""
    import torch.distributed as dist

    from .ops import segment
    from .parallel import dist_ba

    cam, poses, pts, obs_cam, obs_pt, uvr, opt_mask, obs_w = problem(
        points, cams, obs_per, dev)
    mesh = dist_ba.make_mesh(1, world, device=dev)
    sh = dist_ba.make_shardings(mesh)
    per = points // world
    x0 = sh["pt"](pts)
    a = dict(opt=sh["replicated"](opt_mask), oc=sh["pt"](obs_cam),
             op=sh["pt"](obs_pt % per), ou=sh["pt"](uvr),
             ow=sh["pt"](obs_w))
    step = dist_ba.make_distributed_ba_step(cam, mesh, cams)

    def run(eps):
        p, x = poses, x0 + eps
        lam = torch.tensor(LAM0, dtype=torch.float32, device=dev)
        for _ in range(iters):
            p, x, lam = step(p, a["opt"], x, a["oc"], a["op"], a["ou"],
                             a["ow"], lam)
        timing.sync(dev)
        return p, x, lam

    p, x, lam = run(0.0)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), poses=p.cpu().numpy(),
             points=x.cpu().numpy(), lam=lam.cpu().numpy())
    seg0 = segment.segment_kernel.launches
    dist.barrier()
    t0 = time.perf_counter()
    for i in range(reps):
        run(REP_STEP_M * (i + 1))
    dist.barrier()
    wall = (time.perf_counter() - t0) / reps
    if rank == 0:
        with open(os.path.join(out_dir, "wall.json"), "w") as f:
            json.dump({"wall_s": wall, "segment_sum_launches":
                       segment.segment_kernel.launches - seg0}, f)


def run_layout(n_pt: int, points: int, cams: int, obs_per: int,
               iters: int, device, out_dir: str, reps: int = REPS,
               timeout: float = 900.0) -> dict:
    """One 1 x n_pt layout in n_pt spawned processes; the untimed run's
    result is left in `out_dir` (rank{r}.npz). Returns rank 0's wall time
    and segment-sum launches."""
    # the worker by its package name: `python -m` runs this file as
    # __main__, which the spawned processes cannot import by that name
    from sgslam_tpu_torch import bench_dist_ba
    from sgslam_tpu_torch.parallel import multihost

    if points % n_pt:
        raise ValueError(f"{points} points do not divide into {n_pt} shards")
    multihost.spawn(bench_dist_ba._worker, n_pt,
                    (points, cams, obs_per, iters, reps, out_dir),
                    device=str(device), timeout=timeout)
    with open(os.path.join(out_dir, "wall.json")) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="the most ranks a layout may take")
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--cams", type=int, default=32)
    ap.add_argument("--obs-per", type=int, default=6)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (default: NCCL, one card "
                         "per rank)")
    a = ap.parse_args(argv)
    dev = timing.measurement_device(a.cpu, "bench_dist_ba")
    ranks = a.devices if a.cpu else min(a.devices,
                                        torch.cuda.device_count())
    label = "cpu (gloo)" if a.cpu else timing.card(dev) + " (nccl)"
    base = None
    for n_pt in [n for n in LAYOUTS if n <= ranks]:
        with tempfile.TemporaryDirectory() as tmp:
            r = run_layout(n_pt, a.points, a.cams, a.obs_per, a.iters,
                           "cpu" if a.cpu else "cuda", tmp)
        base = base or r["wall_s"]
        print(json.dumps({
            "pt_shards": n_pt, "points": a.points, "cams": a.cams,
            "obs": a.points * a.obs_per, "iters": a.iters,
            "wall_s": r["wall_s"], "speedup_vs_1shard": base / r["wall_s"],
            "device": label,
            "segment_sum_launches": None if a.cpu
            else r["segment_sum_launches"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
