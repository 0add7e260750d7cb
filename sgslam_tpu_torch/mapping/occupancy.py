"""Log-odds voxel occupancy mapping with batched ray carving.

Port of `sgslam_tpu/mapping/occupancy.py`: a dense [D,D,D] log-odds grid
(the octree of octomap_server), updated by a fixed-step walk along every
ray of a scan. The two scatter-adds are segment sums in a fixed order
(`ops.segment.segment_sum`), the same on every launch; grids match the
reference's within f32 rounding.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.segment import segment_sum

# log(0.7/0.3), log(0.4/0.6), clamps log(0.12/0.88), log(0.97/0.03)
HIT_LOGODDS = 0.8473
MISS_LOGODDS = -0.4055
CLAMP_MIN = -1.9924
CLAMP_MAX = 3.4761
OCC_THRESH = 0.0


@dataclasses.dataclass
class OccupancyGrid:
    logodds: torch.Tensor     # [D,D,D] float32
    origin: torch.Tensor      # [3] world coords of voxel (0,0,0) corner
    voxel_size: torch.Tensor  # [] f32


def empty_grid(dim: int, voxel_size: float, origin=(-5.0, -5.0, -5.0),
               device="cpu"):
    return OccupancyGrid(
        logodds=torch.zeros((dim, dim, dim), device=device),
        origin=torch.tensor(origin, dtype=torch.float32, device=device),
        voxel_size=torch.tensor(voxel_size, dtype=torch.float32,
                                device=device))


def world_to_voxel(grid: OccupancyGrid, pts):
    return torch.floor((pts - grid.origin) / grid.voxel_size).to(torch.int32)


def _flat_index(ijk, inb, D: int):
    flat = (ijk[..., 0] * D + ijk[..., 1]) * D + ijk[..., 2]
    return torch.where(inb, flat, -1)


def insert_scan(grid: OccupancyGrid, sensor_origin, points, valid,
                *, max_steps: int = 128):
    """Carve free space along each ray and mark endpoints occupied.

    sensor_origin [3] world; points [N,3] world endpoints; valid [N].
    `max_steps` samples per ray at 0.9 voxel spacing (a supercover
    approximation of octomap's DDA)."""
    D = grid.logodds.shape[0]
    dev = points.device
    vec = points - sensor_origin[None]
    dist = torch.linalg.vector_norm(vec, dim=-1)
    step_len = 0.9 * grid.voxel_size
    n_steps = torch.clamp((dist / step_len).to(torch.int32), max=max_steps)

    steps = torch.arange(max_steps, device=dev)
    t = (steps.to(torch.float32)[None, :] * step_len
         / torch.clamp(dist, min=1e-6)[:, None])             # [N,S] in [0,1]
    free_mask = (steps[None, :] < n_steps[:, None]) & valid[:, None]
    sample = sensor_origin[None, None] + t[..., None] * vec[:, None, :]
    ijk = world_to_voxel(grid, sample)                       # [N,S,3]
    inb = torch.all((ijk >= 0) & (ijk < D), -1) & free_mask
    flat = _flat_index(ijk, inb, D)

    lo = segment_sum(torch.full((flat.numel(),), MISS_LOGODDS, device=dev),
                     flat.reshape(-1), D ** 3, grid.logodds.reshape(-1))

    # endpoint hits (also cancel the miss the endpoint may have received)
    e_ijk = world_to_voxel(grid, points)
    e_inb = torch.all((e_ijk >= 0) & (e_ijk < D), -1) & valid
    e_flat = _flat_index(e_ijk, e_inb, D)
    lo = segment_sum(torch.full((e_flat.numel(),),
                                HIT_LOGODDS - MISS_LOGODDS, device=dev),
                     e_flat, D ** 3, lo)

    new = torch.clamp(lo.reshape(D, D, D), CLAMP_MIN, CLAMP_MAX)
    return dataclasses.replace(grid, logodds=new)


def occupied_mask(grid: OccupancyGrid):
    return grid.logodds > OCC_THRESH


def project_2d(grid: OccupancyGrid, z_min: float = -0.5, z_max: float = 1.5):
    """Down-projected 2-D occupancy map: a ground cell is occupied if any
    voxel in the height band is (world y is height)."""
    D = grid.logodds.shape[0]
    ys = grid.origin[1] + (torch.arange(D, device=grid.logodds.device)
                           + 0.5) * grid.voxel_size
    band = (ys >= z_min) & (ys <= z_max)
    occ = occupied_mask(grid) & band[None, :, None]
    return torch.any(occ, dim=1)                              # [Dx, Dz]
