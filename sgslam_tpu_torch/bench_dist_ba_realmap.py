"""Distributed global BA on a real tracked map across grid shapes.

    python -m sgslam_tpu_torch.bench_dist_ba_realmap [--devices 8]
        [--iters 4] [--map P] [--out MULTICHIP_SCALE_TORCH_H100.json] [--cpu]

Port of `tools/bench_dist_ba_realmap.py`. It loads the tracked map
(`sgslam_tpu/assets/eval_map.npz` by default: 140 valid keyframes, about
9.5k live points and 55.7k observations), moves every point by 0.01 m
times a standard normal draw, and for each ('kf' x 'pt') grid of (1,1),
(1,2), (2,2), (2,4) and (1,8) within the ranks available solves it with
`parallel.map_partition.distributed_global_ba` in spawned processes
(`parallel.multihost.spawn`): one untimed call of 1 LM iteration, then one
timed call of `--iters` iterations (partitioning included, ended by a
synchronize, rank 0's host clock). Each layout records the reprojection
cost after it (`map_reprojection_cost`), which must be below the cost
before, or the run fails.

The reference draws its noise with `jax.random.normal(PRNGKey(3))`, which
the port cannot make; the port's is numpy's `default_rng(3)` (as
`parallel.dryrun.point_noise`), and `solve` takes the noise as an argument
so that a test can hand it JAX's draw. On the card the ranks are NCCL
processes, one card each (layouts beyond the card count are left out);
`--cpu` runs gloo ranks on the CPU, and their wall times are CPU times.

Output: the JSON file (`--out`) with the map's size, the device label (the
card's name and power limit, or "cpu (gloo)"), the cost before and a row
per layout, and one JSON line naming it. Without a card and without
`--cpu` it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import torch

from . import config
from .utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1, 1), (1, 2), (2, 2), (2, 4), (1, 8))
NOISE_SEED = 3


def make_config():
    return config.synthetic_config(width=640, height=480)


def noisy(m, noise=None):
    """The map with every point moved by `noise` ([max_pt, 3]; by default
    `dryrun.point_noise` with seed NOISE_SEED, 0.01 m x a normal draw)."""
    from .parallel import dryrun

    if noise is None:
        noise = dryrun.point_noise(tuple(m.pt_pos.shape), NOISE_SEED)
    return dataclasses.replace(m, pt_pos=m.pt_pos + torch.as_tensor(
        noise).to(m.pt_pos.device))


def solve(cfg, m_noisy, mesh, iters: int):
    """On an existing grid: one untimed LM iteration, then `iters` timed.
    Returns (optimized map, wall seconds, cost after)."""
    import torch.distributed as dist

    from .parallel import map_partition

    map_partition.distributed_global_ba(cfg, m_noisy, mesh, iters=1)
    timing.sync(mesh.device)
    dist.barrier()
    t0 = time.perf_counter()
    m_opt = map_partition.distributed_global_ba(cfg, m_noisy, mesh,
                                                iters=iters)
    timing.sync(mesh.device)
    wall = time.perf_counter() - t0
    return m_opt, wall, map_partition.map_reprojection_cost(cfg, m_opt)


def _worker(rank, world, dev, map_path, n_kf, iters, out):
    from .io import checkpoint
    from .ops import segment
    from .parallel import dist_ba

    from sgslam_tpu_torch import bench_dist_ba_realmap as mod

    m, _ = checkpoint.load_map(map_path, device=dev)
    mesh = dist_ba.make_mesh(n_kf, world // n_kf, device=dev)
    seg0 = segment.segment_kernel.launches
    _, wall, cost = mod.solve(mod.make_config(), mod.noisy(m), mesh, iters)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"wall_s": wall, "cost_after": cost,
                       "segment_sum_launches":
                       segment.segment_kernel.launches - seg0}, f)


def run(device, map_path: str, shapes, iters: int, ranks: int,
        timeout: float = 900.0) -> dict:
    """Every shape of `shapes` within `ranks`, in spawned processes on
    `device` ("cuda": NCCL; "cpu": gloo)."""
    from sgslam_tpu_torch import bench_dist_ba_realmap as mod

    from .io import checkpoint
    from .parallel import map_partition, multihost

    dev = torch.device("cpu" if device == "cpu" else "cuda")
    m, _ = checkpoint.load_map(map_path, device=dev)
    obs = m.kf_obs_point
    cost0 = map_partition.map_reprojection_cost(make_config(), noisy(m))
    res = {"map": {"keyframes": int(m.kf_valid.sum()),
                   "points": int(m.pt_valid.sum()),
                   "observations": int(((obs >= 0)
                                        & m.kf_valid[:, None]).sum()),
                   "source": os.path.relpath(os.path.abspath(map_path),
                                             ROOT)},
           "device": ("cpu (gloo)" if dev.type == "cpu"
                      else timing.card(dev) + " (nccl)"),
           "torch": torch.__version__,
           "noise": f"0.01 m x numpy default_rng({NOISE_SEED}) standard "
                    "normal (the reference: jax.random.normal(PRNGKey(3)))",
           "iters": iters, "cost_before": cost0, "layouts": []}
    del m, obs
    for nk, npt in shapes:
        if nk * npt > ranks:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "rank0.json")
            multihost.spawn(mod._worker, nk * npt,
                            (os.path.abspath(map_path), nk, iters, out),
                            device=device, timeout=timeout)
            with open(out) as f:
                r = json.load(f)
        row = {"mesh": f"kf={nk} x pt={npt}", "devices": nk * npt,
               "wall_s": r["wall_s"], "s_per_iter": r["wall_s"] / iters,
               "cost_after": r["cost_after"],
               "converged": r["cost_after"] < cost0,
               "segment_sum_launches": (r["segment_sum_launches"]
                                        if dev.type == "cuda" else None)}
        res["layouts"].append(row)
        print(row, file=sys.stderr, flush=True)
        if not row["converged"]:
            raise AssertionError(f"distributed GBA diverged on "
                                 f"{row['mesh']}: {cost0} -> "
                                 f"{row['cost_after']}")
    return res


def main(argv=None) -> int:
    from .parallel import dryrun

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="the most ranks a layout may take")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--map", default=dryrun.EVAL_MAP)
    ap.add_argument("--out", default="MULTICHIP_SCALE_TORCH_H100.json")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (default: NCCL, one card "
                         "per rank)")
    a = ap.parse_args(argv)
    dev = timing.measurement_device(a.cpu, "bench_dist_ba_realmap")
    ranks = a.devices if a.cpu else min(a.devices,
                                        torch.cuda.device_count())
    res = run(dev.type, a.map, SHAPES, a.iters, ranks)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({"out": a.out, "device": res["device"],
                      "layouts": len(res["layouts"]),
                      "all_converged": all(r["converged"]
                                           for r in res["layouts"])}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
