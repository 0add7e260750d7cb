"""MapState -> distributed-BA layout: partition a tracked map into the
point-sharded observation slabs that `parallel.dist_ba` consumes, run the
distributed global bundle adjustment over a ('kf' x 'pt') process grid,
and write the result back.

Port of `sgslam_tpu/parallel/map_partition.py`. Partitioning runs on the
host in numpy, line for line the reference's, so the integer tables (slabs,
shard-local indices, padding) are the same for the same map. Every rank
partitions the whole map and keeps its 'pt' slab; at the end the slabs'
points are gathered over 'pt' (one list `all_gather`, P_pad * 12 bytes),
so that every rank writes the whole result back into its map.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..config import SlamConfig
from ..geometry import se3
from ..mapstate.mapstate import MapState
from . import dist_ba


def _np(t):
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class PartitionedBA:
    """Host-side container of the sharded global-BA problem."""

    poses: np.ndarray        # [C,7] replicated
    opt_mask: np.ndarray     # [C]
    kf_ids: np.ndarray       # [C] map keyframe slot per camera index
    points: np.ndarray       # [P_pad,3] shard-major (slab s = points of shard s)
    pt_ids: np.ndarray       # [P_pad] map point id (-1 = padding)
    obs_cam: np.ndarray      # [O_pad] i32
    obs_pt: np.ndarray       # [O_pad] i32 SHARD-LOCAL point index
    obs_uvr: np.ndarray      # [O_pad,3]
    obs_w: np.ndarray        # [O_pad] (0 = padding)
    n_pt_shards: int
    pts_per_shard: int
    obs_per_shard: int


def partition_map(cfg: SlamConfig, m: MapState,
                  n_pt_shards: int) -> PartitionedBA:
    """Carve the map into `n_pt_shards` point slabs with their observations.

    Points are dealt to shards in contiguous slabs of the live-point list,
    and every observation lands on the shard that owns its point, so the
    per-shard Schur reduction touches only shard-local state.
    """
    kf_valid = _np(m.kf_valid)
    kf_slots = np.nonzero(kf_valid)[0]
    C = len(kf_slots)

    pt_valid = _np(m.pt_valid)
    obs = _np(m.kf_obs_point)[kf_slots]               # [C,N]
    has = obs >= 0
    has &= np.where(has, pt_valid[np.where(has, obs, 0)], False)

    # keep only points actually observed by a live keyframe
    observed = np.zeros(m.max_pt, bool)
    observed[obs[has]] = True
    pt_list = np.nonzero(pt_valid & observed)[0]
    P = len(pt_list)
    pts_per = -(-P // n_pt_shards)
    P_pad = pts_per * n_pt_shards
    pt_ids = np.full(P_pad, -1, np.int64)
    pt_ids[:P] = pt_list
    shard_of_pt = np.full(m.max_pt, -1, np.int64)
    local_of_pt = np.full(m.max_pt, -1, np.int64)
    shard_of_pt[pt_list] = np.arange(P) // pts_per
    local_of_pt[pt_list] = np.arange(P) % pts_per

    cam_idx, feat_idx = np.nonzero(has)
    pid = obs[cam_idx, feat_idx]
    uv = _np(m.kf_feat_xy)[kf_slots][cam_idx, feat_idx]
    ur = _np(m.kf_feat_uvr)[kf_slots][cam_idx, feat_idx]
    lv = _np(m.kf_feat_level)[kf_slots][cam_idx, feat_idx]
    w = (1.0 / cfg.orb.scale_factor ** 2) ** lv.astype(np.float64)

    sh = shard_of_pt[pid]
    counts = np.bincount(sh, minlength=n_pt_shards)
    obs_per = int(-(-counts.max() // 8) * 8) if len(counts) else 8
    O_pad = obs_per * n_pt_shards
    obs_cam = np.zeros(O_pad, np.int32)
    obs_pt = np.zeros(O_pad, np.int32)
    obs_uvr = np.zeros((O_pad, 3), np.float32)
    obs_uvr[:, 2] = -1.0
    obs_w = np.zeros(O_pad, np.float32)
    for s in range(n_pt_shards):
        sel = sh == s
        n = int(sel.sum())
        base = s * obs_per
        obs_cam[base:base + n] = cam_idx[sel]
        obs_pt[base:base + n] = local_of_pt[pid[sel]]
        obs_uvr[base:base + n, :2] = uv[sel]
        obs_uvr[base:base + n, 2] = ur[sel]
        obs_w[base:base + n] = w[sel]

    points = np.zeros((P_pad, 3), np.float32)
    points[:P] = _np(m.pt_pos)[pt_list]
    poses = _np(m.kf_pose)[kf_slots]
    opt_mask = np.ones(C, bool)
    opt_mask[0] = False                # gauge: fix the first keyframe
    return PartitionedBA(
        poses=poses, opt_mask=opt_mask, kf_ids=kf_slots,
        points=points, pt_ids=pt_ids,
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uvr=obs_uvr, obs_w=obs_w,
        n_pt_shards=n_pt_shards, pts_per_shard=pts_per,
        obs_per_shard=obs_per)


def map_reprojection_cost(cfg: SlamConfig, m: MapState) -> float:
    """Total (non-robust) reprojection chi2 of every live observation, in
    float32 on the map's device: the objective global BA minimizes."""
    part = partition_map(cfg, m, 1)
    dev = m.device
    T = torch.from_numpy(part.poses).to(dev)[
        torch.from_numpy(part.obs_cam).to(dev, torch.int64)]
    pw = torch.from_numpy(part.points).to(dev)[
        torch.from_numpy(part.obs_pt).to(dev, torch.int64)]
    pc = se3.se3_apply(T, pw)
    z = torch.clamp(pc[:, 2], min=1e-6)
    u = cfg.camera.fx * pc[:, 0] / z + cfg.camera.cx
    v = cfg.camera.fy * pc[:, 1] / z + cfg.camera.cy
    uvr = torch.from_numpy(part.obs_uvr).to(dev)
    r2 = (u - uvr[:, 0]) ** 2 + (v - uvr[:, 1]) ** 2
    return float(torch.sum(r2 * torch.from_numpy(part.obs_w).to(dev)))


def writeback(m: MapState, part: PartitionedBA, new_poses,
              new_points) -> MapState:
    """Write the optimized poses / points back into a copy of the map;
    padding rows (pt_ids == -1) are dropped (the reference's mode="drop")."""
    dev = m.device
    kf_pose = m.kf_pose.clone()
    kf_pose[torch.from_numpy(part.kf_ids).to(dev)] = torch.as_tensor(
        new_poses).to(dev, torch.float32)
    ok = torch.from_numpy(part.pt_ids >= 0).to(dev)
    pt_pos = m.pt_pos.clone()
    pt_pos[torch.from_numpy(part.pt_ids).to(dev)[ok]] = torch.as_tensor(
        new_points).to(dev, torch.float32)[ok]
    return dataclasses.replace(m, kf_pose=kf_pose, pt_pos=pt_pos)


def distributed_global_ba(cfg: SlamConfig, m: MapState, mesh: dist_ba.Mesh,
                          iters: int = 10, on_step=None) -> MapState:
    """Optimizer::GlobalBundleAdjustemnt over the ('kf', 'pt') grid. Every
    rank of the grid calls it with the same map and gets the whole result.
    `on_step()`, if given, is called after each LM step (for timing)."""
    n_pt = mesh.n_pt
    part = partition_map(cfg, m, n_pt)
    sh = dist_ba.make_shardings(mesh)
    # pad the camera dimension to a multiple of the 'kf' size so every rank
    # owns the same number of Schur rows (the row slice must never clamp);
    # padded cameras have no observations and opt_mask False
    C = part.poses.shape[0]
    kf_size = mesh.n_kf
    C_pad = -(-C // kf_size) * kf_size
    poses_np = np.concatenate(
        [part.poses,
         np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32),
                 (C_pad - C, 1))])
    opt_np = np.concatenate([part.opt_mask, np.zeros(C_pad - C, bool)])
    step = dist_ba.make_distributed_ba_step(cfg.camera, mesh, C_pad)
    poses = sh["replicated"](poses_np)
    opt_mask = sh["replicated"](opt_np)
    points = sh["pt"](part.points)
    obs_cam = sh["pt"](part.obs_cam)
    obs_pt = sh["pt"](part.obs_pt)
    obs_uvr = sh["pt"](part.obs_uvr)
    obs_w = sh["pt"](part.obs_w)
    lam = torch.tensor(1e-3, dtype=torch.float32, device=mesh.device)
    for _ in range(iters):
        poses, points, lam = step(poses, opt_mask, points, obs_cam, obs_pt,
                                  obs_uvr, obs_w, lam)
        if on_step is not None:
            on_step()
    if n_pt > 1:
        slabs = [torch.empty_like(points) for _ in range(n_pt)]
        dist.all_gather(slabs, points.contiguous(), group=mesh.pt_group)
        points = torch.cat(slabs)
    return writeback(m, part, poses[:C], points)
