"""Multi-process bootstrap for the distributed back end.

Port of `sgslam_tpu/parallel/multihost.py` on `torch.distributed`. The
reference joins JAX's distributed runtime and assembles global sharded
arrays; here every process joins one process group (`init_process`), the
('kf', 'pt') grid is made of its sub-groups (`dist_ba.make_mesh`), and each
rank holds only its own slab (`global_shard`), which the collectives of
`dist_ba` combine.

`spawn` runs a function in N fresh processes (the `spawn` start method,
one intra-op thread each, a `file://` rendezvous in a temporary directory,
so that concurrent runs never share a port) and joins them within a
deadline, so that a hung collective fails instead of waiting forever.

    python -m sgslam_tpu_torch.parallel.multihost --procs N [--device cpu]

is the counterpart of `tools/multihost_demo.py`: the same synthetic problem
through one process and through N processes ('kf' = 1, 'pt' = N), on the
card under NCCL (one card per process) or with `--device cpu` under gloo,
and one JSON line with the wall times.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device


def init_process(init_method: str, world_size: int, rank: int,
                 backend: str | None = None, device="cuda") -> torch.device:
    """Join the default process group (a second call is a no-op) and return
    the device this rank computes on: card `rank % device_count` for
    `device="cuda"` (NCCL by default), the CPU for `device="cpu"` (gloo)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=init_method, world_size=world_size, rank=rank)
    return dev


def global_shard(mesh, pspec, local_data) -> torch.Tensor:
    """This rank's part of a sharded array, on the mesh's device. The port
    holds no global array: under `pspec="pt"` the local slab is the rank's
    share, and `dist_ba`'s collectives combine the slabs; replicated data
    (`pspec=None`) is the whole array on every rank."""
    return torch.as_tensor(local_data).to(mesh.device)


def _entry(fn, rank, world_size, init_method, device, args):
    torch.set_num_threads(1)
    dev = init_process(init_method, world_size, rank, device=device)
    try:
        fn(rank, world_size, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, args=(), device="cuda",
          timeout: float = 300.0):
    """Run `fn(rank, world_size, device, *args)` in `world_size` spawned
    processes joined in one process group. `fn` must be importable by
    name. Raises TimeoutError if a process is still running after
    `timeout` seconds (all are then terminated) and RuntimeError if one
    failed."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_entry, args=(fn, r, world_size, init,
                                                  str(device), tuple(args)))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.terminate()
            for p in hung:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
    if hung:
        raise TimeoutError(f"{len(hung)} of {world_size} processes still "
                           f"ran after {timeout} s")
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"a spawned process failed: exit codes {codes}")


# ---------------------------------------------------------------------------
# The demo: tools/multihost_demo.py's problem through 1 and N processes
# ---------------------------------------------------------------------------

def build_problem(points: int, cams: int, obs_per: int, device="cpu"):
    """tools/multihost_demo.py's synthetic problem (numpy seed 0): C poses,
    P points, each seen by `obs_per` cameras, exact stereo projections."""
    from ..config import tum3_config
    from ..geometry import camera as cam_mod
    from ..geometry import se3

    cam = tum3_config().camera
    rng = np.random.default_rng(0)
    xi = (0.02 * rng.standard_normal((cams, 6))).astype(np.float32)
    poses = se3.se3_exp(torch.from_numpy(xi))
    pts = torch.from_numpy(rng.uniform([-3, -2, 1.5], [3, 2, 8],
                                       size=(points, 3)).astype(np.float32))
    obs_pt = np.repeat(np.arange(points), obs_per)
    obs_cam = (obs_pt * 7919 + np.tile(np.arange(obs_per), points)) % cams
    uvr = cam_mod.project_stereo(cam, se3.se3_apply(
        poses[torch.from_numpy(obs_cam)], pts[torch.from_numpy(obs_pt)]))
    opt_mask = torch.tensor([False] + [True] * (cams - 1))
    dev = torch.device(device)
    return (cam, poses.to(dev), pts.to(dev),
            torch.from_numpy(obs_cam.astype(np.int32)).to(dev),
            torch.from_numpy(obs_pt.astype(np.int32)).to(dev), uvr.to(dev),
            opt_mask.to(dev))


def _demo_worker(rank, world_size, dev, points, cams, obs_per, iters, out):
    from . import dist_ba

    cam, poses, pts, obs_cam, obs_pt, uvr, opt_mask = build_problem(
        points, cams, obs_per, dev)
    mesh = dist_ba.make_mesh(1, world_size, device=dev)
    per_p = points // world_size
    per_o = per_p * obs_per
    lo_p, lo_o = rank * per_p, rank * per_o
    x = global_shard(mesh, "pt", pts[lo_p:lo_p + per_p])
    o_cam = global_shard(mesh, "pt", obs_cam[lo_o:lo_o + per_o])
    o_pt = global_shard(mesh, "pt", obs_pt[lo_o:lo_o + per_o] % per_p)
    o_uvr = global_shard(mesh, "pt", uvr[lo_o:lo_o + per_o])
    o_w = torch.ones(per_o, device=dev)
    step = dist_ba.make_distributed_ba_step(cam, mesh, cams)
    p, lam = poses, torch.tensor(1e-4, device=dev)
    p, x, lam = step(p, opt_mask, x, o_cam, o_pt, o_uvr, o_w, lam)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        p, x, lam = step(p, opt_mask, x, o_cam, o_pt, o_uvr, o_w, lam)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"wall_s": wall, "device": str(dev)}, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="distributed GN steps through "
                                 "1 and N processes")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--cams", type=int, default=32)
    ap.add_argument("--obs-per", type=int, default=6)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    if a.points % a.procs:
        raise SystemExit("--points must divide by --procs")
    cards = torch.cuda.device_count()
    if a.device != "cpu" and a.procs > cards:
        raise SystemExit(f"--procs {a.procs} needs as many GPUs, and this "
                         f"machine has {cards}: NCCL refuses two ranks on "
                         "one card (--device cpu runs the ranks on gloo)")
    # the worker by its package name: `python -m` runs this file as
    # __main__, which the spawned processes cannot import by that name
    from sgslam_tpu_torch.parallel import multihost

    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        for n in sorted({1, a.procs}):
            out = os.path.join(tmp, f"{n}.json")
            multihost.spawn(multihost._demo_worker, n,
                            (a.points, a.cams, a.obs_per, a.iters, out),
                            device=a.device, timeout=a.timeout)
            with open(out) as f:
                walls[n] = json.load(f)
    print(json.dumps({
        "metric": "distributed_gba_multiprocess",
        "device": walls[1]["device"], "points": a.points,
        "obs": a.points * a.obs_per, "iters": a.iters, "procs": a.procs,
        "wall_1proc_s": walls[1]["wall_s"],
        f"wall_{a.procs}proc_s": walls[a.procs]["wall_s"],
        "speedup": walls[1]["wall_s"] / walls[a.procs]["wall_s"],
        "note": "one intra-op thread per process; collectives cross process "
                "boundaries (gloo on the CPU, NCCL on cards)"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
