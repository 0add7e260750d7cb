"""The multi-chip contract on the port: partition a real map, perturb its
points, and let the distributed global BA pull it back together.

Port of `__graft_entry__.dryrun_multichip` and `_synthetic_mapstate`. The
map is the tracked `sgslam_tpu/assets/eval_map.npz` (640x480, 2176
keypoints; 140 valid keyframes, about 9.5k live points and 55.7k
observations), or, where that file is missing, a small synthetic map. The
points move by 0.01 m times a seeded numpy normal draw (`point_noise`), so
that a test can hand the same noise to the reference. The reference's
`iters=2` rejects its first steps on the eval map and leaves the cost where
it was; the port's default budget is 8 LM iterations, by which the
reference's own solver has cut the cost from 3.36e6 to about 9.5e4.

    python -m sgslam_tpu_torch.parallel.dryrun [--procs N] [--device cpu]

runs it through N spawned processes (one card each under NCCL, or gloo on
the CPU) and prints rank 0's report as one JSON line; `dryrun(mesh, ...)`
runs it on a grid that already exists (chip_smoke.py phase 16 makes one of
world size 1 on NCCL).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .. import config
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..io import checkpoint
from ..mapstate import mapstate as ms
from . import dist_ba, map_partition, multihost

EVAL_MAP = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "sgslam_tpu", "assets", "eval_map.npz")
NOISE_M = 0.01
ITERS = 8


def synthetic_mapstate(cfg, n_kf: int = 6, n_pt: int = 512, seed: int = 0,
                       device="cpu") -> ms.MapState:
    """A geometrically consistent MapState built from arrays: random points
    (numpy seed), a camera arc and exact projections wired into the
    observation tables (`__graft_entry__._synthetic_mapstate`)."""
    cam = cfg.camera
    rng = np.random.default_rng(seed)
    m = ms.empty_map(cfg.capacity, cfg.orb.max_keypoints, device="cpu")
    pts = rng.uniform([-2, -1.5, 2.5], [2, 1.5, 6],
                      size=(n_pt, 3)).astype(np.float32)
    xi = (0.06 * np.arange(n_kf)[:, None]
          * np.array([[1, 0.3, 0.2, 0.04, 0.08, 0.02]])).astype(np.float32)
    poses = se3.se3_exp(torch.from_numpy(xi))

    K, N = m.max_kf, cfg.orb.max_keypoints
    obs = np.full((K, N), -1, np.int32)
    xy = np.zeros((K, N, 2), np.float32)
    uvr = np.full((K, N), -1.0, np.float32)
    fvalid = np.zeros((K, N), bool)
    for k in range(n_kf):
        uv = cam_mod.project_stereo(
            cam, se3.se3_apply(poses[k][None], torch.from_numpy(pts))).numpy()
        ok = ((uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
              & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))
        sel = np.nonzero(ok)[0][:N]
        obs[k, :len(sel)] = sel
        xy[k, :len(sel)] = uv[sel, :2]
        uvr[k, :len(sel)] = uv[sel, 2]
        fvalid[k, :len(sel)] = True
    kf_pose = m.kf_pose.clone()
    kf_pose[:n_kf] = poses
    kf_valid = m.kf_valid.clone()
    kf_valid[:n_kf] = True
    pt_pos = m.pt_pos.clone()
    pt_pos[:n_pt] = torch.from_numpy(pts)
    pt_valid = m.pt_valid.clone()
    pt_valid[:n_pt] = True
    m = dataclasses.replace(
        m, kf_pose=kf_pose, kf_valid=kf_valid,
        kf_obs_point=torch.from_numpy(obs), kf_feat_xy=torch.from_numpy(xy),
        kf_feat_uvr=torch.from_numpy(uvr),
        kf_feat_valid=torch.from_numpy(fvalid), pt_pos=pt_pos,
        pt_valid=pt_valid, next_kf=torch.tensor(n_kf, dtype=torch.int32),
        next_pt=torch.tensor(n_pt, dtype=torch.int32))
    return m.to(device)


def small_config():
    """The synthetic map's configuration (the reference's fallback)."""
    return config.tum3_config(
        capacity=config.MapCapacity(max_keyframes=16, max_points=1024),
        orb=config.OrbConfig(max_keypoints=256))


def load_problem(device, use_asset: bool = True, path: str = EVAL_MAP):
    """(cfg, map, label): the tracked map at `path` (by default the eval
    map) where it exists, else the synthetic map C=6, P=384."""
    if use_asset and os.path.exists(path):
        m, _ = checkpoint.load_map(path, device=device)
        cfg = config.synthetic_config(width=640, height=480)
        label = (f"real tracked map C={int(m.kf_valid.sum())}, "
                 f"P={int(m.pt_valid.sum())}")
        return cfg, m, label
    cfg = small_config()
    return (cfg, synthetic_mapstate(cfg, n_kf=6, n_pt=384, device=device),
            "synthetic map C=6, P=384")


def point_noise(shape, seed: int = 1) -> np.ndarray:
    """The perturbation: NOISE_M x a standard normal draw of numpy's
    default_rng(seed), as float32."""
    return (NOISE_M * np.random.default_rng(seed).standard_normal(
        shape)).astype(np.float32)


def dryrun(mesh: dist_ba.Mesh, cfg=None, m=None, label: str = "",
           iters: int = ITERS, seed: int = 1) -> dict:
    """Perturb the map's points, run the distributed global BA for `iters`
    LM iterations on this rank's part of the grid, and report: the
    reprojection cost before and after, ms per iteration (CUDA events on
    the card), peak device memory and the bytes handed to collectives."""
    if m is None:
        cfg, m, label = load_problem(mesh.device)
    m = m.to(mesh.device)
    noise = torch.from_numpy(point_noise(tuple(m.pt_pos.shape), seed))
    m_noisy = dataclasses.replace(m, pt_pos=m.pt_pos + noise.to(mesh.device))
    cost0 = map_partition.map_reprojection_cost(cfg, m_noisy)
    cuda = mesh.device.type == "cuda"
    marks = []

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    if cuda:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        base = torch.cuda.memory_allocated(mesh.device)
    t0 = time.perf_counter()
    mark()
    m_opt = map_partition.distributed_global_ba(cfg, m_noisy, mesh,
                                                iters=iters, on_step=mark)
    if cuda:
        torch.cuda.synchronize(mesh.device)
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        peak = (torch.cuda.max_memory_allocated(mesh.device) - base) / 2 ** 30
    else:
        step_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
        peak = None
    wall = time.perf_counter() - t0
    cost1 = map_partition.map_reprojection_cost(cfg, m_opt)
    part = map_partition.partition_map(cfg, m, mesh.n_pt)
    C = part.poses.shape[0]
    C_pad = -(-C // mesh.n_kf) * mesh.n_kf
    finite = bool(torch.isfinite(m_opt.kf_pose).all()
                  and torch.isfinite(m_opt.pt_pos).all())
    return {
        "ok": finite and cost1 < cost0, "label": label,
        "mesh": mesh.shape, "iters": iters, "cost0": cost0, "cost1": cost1,
        "C": C, "P": int((part.pt_ids >= 0).sum()),
        "obs": int((part.obs_w > 0).sum()),
        "ms_per_iter": float(np.median(step_ms)), "step_ms": step_ms,
        "wall_s": wall, "peak_gib": peak,
        "collective_bytes_per_iter": dist_ba.collective_bytes(
            C_pad, mesh.n_kf, mesh.n_pt),
        "gather_points_bytes": (part.points.nbytes if mesh.n_pt > 1 else 0),
        "device": str(mesh.device), "poses": m_opt.kf_pose,
        "points": m_opt.pt_pos}


def grid_shape(n_devices: int):
    """The reference's split: 'kf' = 2 when the count is even, else 1."""
    n_kf = 2 if n_devices % 2 == 0 else 1
    return n_kf, n_devices // n_kf


def _worker(rank, world_size, dev, use_asset, iters, seed, out, path):
    n_kf, n_pt = grid_shape(world_size)
    mesh = dist_ba.make_mesh(n_kf, n_pt, device=dev)
    cfg, m, label = load_problem(dev, use_asset, path)
    report = dryrun(mesh, cfg, m, label, iters=iters, seed=seed)
    if rank == 0:
        report.pop("poses")
        report.pop("points")
        with open(out, "w") as f:
            json.dump(report, f)


def dryrun_multichip(n_devices: int = 1, device="cuda", iters: int = ITERS,
                     seed: int = 1, use_asset: bool = True,
                     timeout: float = 900.0, path: str = EVAL_MAP) -> dict:
    """`dryrun` through `n_devices` spawned processes on a (kf, pt) grid;
    raises AssertionError unless the cost fell and the result is finite."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "report.json")
        multihost.spawn(_worker, n_devices,
                        (use_asset, iters, seed, out, path), device=device,
                        timeout=timeout)
        with open(out) as f:
            report = json.load(f)
    if not report["ok"]:
        raise AssertionError(f"dryrun: cost {report['cost0']} -> "
                             f"{report['cost1']}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the distributed global BA on "
                                 "a perturbed map")
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--synthetic", action="store_true",
                    help="the small synthetic map instead of eval_map.npz")
    ap.add_argument("--map", default=EVAL_MAP,
                    help="the tracked map to perturb (default: the shipped "
                         "eval_map.npz; e.g. build_eval_map's output)")
    a = ap.parse_args(argv)
    from sgslam_tpu_torch.parallel import dryrun as mod

    report = mod.dryrun_multichip(a.procs, a.device, a.iters, a.seed,
                                  not a.synthetic, path=a.map)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
