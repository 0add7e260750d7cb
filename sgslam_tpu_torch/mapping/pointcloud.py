"""Dense point-cloud generation and filtering over a spatial hash grid.

Port of `sgslam_tpu/mapping/pointcloud.py`: depth back-projection with
dynamic-box skipping, voxel-grid downsampling and a density outlier filter
as scatter/gather programs.

`voxel_ids` hashes with int32 products that wrap, as the reference's do:
torch int32 tensors times Python ints stay int32 and wrap, `abs` of
INT_MIN stays negative, and `%` is a floor modulo like `jnp.remainder`,
so the ids are the reference's to the bit. The cell of a point is
`floor(p * (1 / size))` with the reciprocal rounded to f32: the reference
divides, but XLA compiles a division by its constant (static) cell size
into that product, which lands on the other side of a cell boundary for
about one point in 10**5. The scatter-adds are segment sums in a fixed
order (`ops.segment.segment_sum`), the same on every launch; the reference's
scatters sum in XLA's order, so the centroids match within f32 rounding,
not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import se3
from ..geometry.camera import Camera
from ..ops.segment import segment_sum
from ..semantic.dynamic import Boxes, in_any_box

# deterministic spatial hash primes (Teschner et al.)
_PX, _PY, _PZ = 73856093, 19349663, 83492791


def pixel_grid(h: int, w: int, device):
    """[h*w, 2] float32 (u, v) of every pixel, row-major."""
    uu = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(
        h, w)
    vv = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(
        h, w)
    return torch.stack([uu, vv], -1).reshape(-1, 2)


def backproject_depth(cam: Camera, depth, gray, T_wc, dynamic_boxes: Boxes,
                      depth_min: float = 0.5, depth_max: float = 5.0):
    """Depth image -> world-frame cloud, skipping dynamic boxes.

    Returns (points [H*W, 3], intensity [H*W], valid [H*W])."""
    h, w = depth.shape
    uv = pixel_grid(h, w, depth.device)
    z = depth.reshape(-1)
    x = (uv[:, 0] - cam.cx) * z / cam.fx
    y = (uv[:, 1] - cam.cy) * z / cam.fy
    pw = se3.se3_apply(T_wc[None], torch.stack([x, y, z], -1))
    dyn = in_any_box(uv, dynamic_boxes, torch.ones_like(dynamic_boxes.valid))
    valid = (z > depth_min) & (z < depth_max) & ~dyn
    return pw, gray.reshape(-1), valid


def _hash(ijk, table_size: int):
    hsh = (ijk[..., 0] * _PX) ^ (ijk[..., 1] * _PY) ^ (ijk[..., 2] * _PZ)
    return torch.abs(hsh) % table_size


def voxel_cells(points, size: float):
    """int32 cell indices of points on a grid of `size`, as the jitted
    reference computes them (a product with the f32 reciprocal)."""
    inv = float(np.float32(1.0) / np.float32(size))
    return torch.floor(points * inv).to(torch.int32)


def voxel_ids(points, voxel_size: float, table_size: int):
    """Hash points into a fixed-size voxel table. Returns (ids, ijk)."""
    ijk = voxel_cells(points, voxel_size)
    return _hash(ijk, table_size), ijk


def voxel_downsample(points, intensity, valid, *, voxel_size: float = 0.01,
                     table_size: int = 1 << 15):
    """Centroid-per-voxel downsample by scatter-mean into a hash table
    (pcl::VoxelGrid contract). Returns fixed-capacity (points [T,3],
    intensity [T], valid [T])."""
    ids, _ = voxel_ids(points, voxel_size, table_size)
    ids = torch.where(valid, ids, -1)
    sums = segment_sum(torch.cat([valid[:, None].to(torch.float32), points,
                                  intensity[:, None]], 1), ids, table_size)
    cnt, psum, isum = sums[:, 0], sums[:, 1:4], sums[:, 4]
    c = torch.clamp(cnt, min=1.0)
    return psum / c[:, None], isum / c, cnt > 0


def density_outlier_filter(points, valid, *, voxel_size: float = 0.05,
                           table_size: int = 1 << 15,
                           min_neighbors: int = 4):
    """A point survives when its 3x3x3 voxel neighbourhood at `voxel_size`
    holds at least `min_neighbors` points (replaces
    pcl::StatisticalOutlierRemoval)."""
    ids, ijk = voxel_ids(points, voxel_size, table_size)
    cnt = segment_sum(valid.to(torch.float32), torch.where(valid, ids, -1),
                      table_size)
    neigh = torch.zeros_like(points[..., 0])
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                d = torch.tensor([dx, dy, dz], dtype=torch.int32,
                                 device=points.device)
                neigh = neigh + cnt[_hash(ijk + d, table_size)]
    return valid & (neigh >= min_neighbors)
