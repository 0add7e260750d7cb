"""2-D detection -> 3-D semantic object extraction (cloud clustering).

Port of `sgslam_tpu/semantic/detector3d.py` (Detector3D contract): cloud
points from the central 60% of a box within the depth range, Euclidean
clusters as connected components of a voxel-hash graph (label propagation
by per-voxel minimum, a fixed 16 rounds), and the cluster that maximizes
IoU(box, projected ROI) * (npts / 10) / centre-deviation^2, unless the
second best comes within 0.7 of it.

The per-voxel minimum is `scatter_reduce_("amin")`, exact in any order.
`jnp.unique(size=16)` keeps the 16 smallest labels (not the largest
clusters); the port computes that fixed-size unique on the device from a
sort, without a host read.
"""

from __future__ import annotations

import torch

from ..geometry import se3
from ..mapping.pointcloud import _hash, voxel_cells

_NEIGH = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
          for dz in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0)]
BIG = 2 ** 30


def cluster_labels(points, valid, *, tol: float = 0.02,
                   table_size: int = 1 << 14, iters: int = 16):
    """Connected-component labels [N] int32 over a voxel graph at
    tolerance `tol`, after `iters` label-propagation rounds."""
    dev = points.device
    ijk = voxel_cells(points, tol)
    vox = torch.where(valid, _hash(ijk, table_size), table_size).to(
        torch.int64)
    n = points.shape[0]
    labels = torch.where(valid, torch.arange(n, dtype=torch.int32,
                                             device=dev), BIG)
    d = torch.tensor(_NEIGH, dtype=torch.int32, device=dev)     # [26,3]
    neigh_vox = torch.where(valid[None], _hash(ijk[None] + d[:, None],
                                               table_size),
                            table_size).to(torch.int64)         # [26,N]
    for _ in range(iters):
        vmin = torch.full((table_size + 1,), BIG, dtype=torch.int32,
                          device=dev).scatter_reduce_(0, vox, labels, "amin")
        new = torch.minimum(labels, vmin[vox])
        new = torch.minimum(new, vmin[neigh_vox].amin(0))
        labels = torch.where(valid, new, BIG)
    return labels


def _unique_smallest(labels, size: int, fill_value: int = BIG):
    """`jnp.unique(labels, size=size, fill_value=..., return_counts=True)`
    with fixed shapes: the `size` smallest distinct values and their
    counts."""
    s, _ = torch.sort(labels)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(first.to(torch.int64), 0) - 1
    slot = torch.where(rank < size, rank, size)
    uniq = torch.full((size + 1,), fill_value, dtype=labels.dtype,
                      device=labels.device)
    uniq.scatter_(0, torch.where(first, slot, size), s)
    counts = torch.zeros(size + 1, dtype=torch.int32, device=labels.device)
    counts.scatter_add_(0, slot, torch.ones_like(s))
    return uniq[:size], counts[:size]


def extract_object(cam, points_w, uv, valid, box_xyxy, T_cw,
                   *, depth_min: float = 0.5, depth_max: float = 5.0,
                   min_pts: int = 20, max_clusters: int = 16):
    """Best-cluster semantic object for one 2-D box.

    points_w [N,3] world cloud of the keyframe; uv [N,2] their pixel
    coords; box_xyxy [4]. Returns (centroid [3], size [3], ok)."""
    x1, y1, x2, y2 = box_xyxy.unbind()
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    w6, h6 = 0.3 * (x2 - x1), 0.3 * (y2 - y1)  # central 60%
    pc = se3.se3_apply(T_cw[None], points_w)
    sel = (valid
           & (uv[:, 0] > cx - w6) & (uv[:, 0] < cx + w6)
           & (uv[:, 1] > cy - h6) & (uv[:, 1] < cy + h6)
           & (pc[:, 2] > depth_min) & (pc[:, 2] < depth_max))

    labels = cluster_labels(points_w, sel)
    uniq, counts = _unique_smallest(labels, max_clusters)
    cl_valid = (uniq < BIG) & (counts >= min_pts)

    # all candidate clusters at once: [K, N] membership
    m = (labels[None, :] == uniq[:, None]) & sel[None, :]
    w = m.to(torch.float32)
    npts = w.sum(1)
    inf = torch.inf
    ux1 = torch.where(m, uv[None, :, 0], inf).amin(1)
    vy1 = torch.where(m, uv[None, :, 1], inf).amin(1)
    ux2 = torch.where(m, uv[None, :, 0], -inf).amax(1)
    vy2 = torch.where(m, uv[None, :, 1], -inf).amax(1)
    ix1, iy1 = torch.maximum(ux1, x1), torch.maximum(vy1, y1)
    ix2, iy2 = torch.minimum(ux2, x2), torch.minimum(vy2, y2)
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    a_roi = torch.clamp(ux2 - ux1, min=0) * torch.clamp(vy2 - vy1, min=0)
    a_box = (x2 - x1) * (y2 - y1)
    iou = inter / torch.clamp(a_roi + a_box - inter, min=1e-6)
    dev = ((ux1 + ux2) / 2 - cx) ** 2 + ((vy1 + vy2) / 2 - cy) ** 2 + 1.0
    scores = torch.where(cl_valid, iou * (npts / 10.0) / dev, -inf)
    best = torch.argmax(scores).reshape(1)   # [1]: no host read
    s_sorted = torch.sort(scores, descending=True).values
    ambiguous = (s_sorted[1] > 0.7 * s_sorted[0]) & torch.isfinite(
        s_sorted[1])
    ok = torch.isfinite(scores.index_select(0, best)[0]) & ~ambiguous

    mb = m.index_select(0, best)[0]
    wb = mb.to(torch.float32)
    centroid = (wb @ points_w) / torch.clamp(wb.sum(), min=1.0)
    mins = torch.where(mb[:, None], points_w, inf).amin(0)
    maxs = torch.where(mb[:, None], points_w, -inf).amax(0)
    size = torch.where(torch.isfinite(mins) & torch.isfinite(maxs),
                       maxs - mins, 0.0)
    return centroid, size, ok
