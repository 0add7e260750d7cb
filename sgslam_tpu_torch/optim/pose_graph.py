"""Sim(3) pose-graph (essential-graph) optimization, batched Gauss-Newton.

Port of `sgslam_tpu/optim/pose_graph.py`. Per-edge residuals are
r = sim3_log(S_meas * S_j * S_i^-1). The reference differentiates it with
`jax.jacfwd` at a zero left perturbation of S_i and S_j. Here the same
function is differenced centrally in float64, which matches jacfwd to f32
rounding: torch's forward-mode AD (`torch.func.jvp`, `forward_ad`) was
0.2-0.4 s per call on the CPU, ~30 s for a 40-iteration solve, and
`jacfwd` under `vmap` gave NaN tangents for some edges of a batch that it
differentiated cleanly alone.

The normal equations are one dense [7K, 7K] system, as in the reference: the
block scatter `H.at[edge_i, :, edge_j, :].add(...)` becomes one segment sum
(`ops.segment.segment_sum`, in a fixed order, so that it repeats on the
card) at the flat index (7*i + r) * 7K + 7*j + c. Fixed and
unused keyframes get a 1e8 penalty on their diagonal, and the system is
solved by LU (`geometry.linalg.solve`) at the full keyframe capacity (3584 rows
for 512 slots). LU on the card and LAPACK's on the CPU round differently, so
results agree to f32 tolerance, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import linalg, se3
from ..ops.segment import segment_sum


def edge_residual(S_i, S_j, S_meas_ij):
    """r [..., 7] = sim3_log(S_meas_ij * S_j * S_i^-1); zero when consistent.
    Convention: S_i = world -> frame i; S_meas_ij ~ S_i * S_j^-1."""
    return se3.sim3_log(
        se3.sim3_compose(S_meas_ij,
                         se3.sim3_compose(S_j, se3.sim3_inverse(S_i))))


def _perturbed_residual(xi_i, xi_j, S_i, S_j, S_meas):
    Si = se3.sim3_compose(se3.sim3_exp(xi_i), S_i)
    Sj = se3.sim3_compose(se3.sim3_exp(xi_j), S_j)
    return edge_residual(Si, Sj, S_meas)


def edge_jacobians(S_i, S_j, S_meas, h: float = 1e-6):
    """([E,7,7], [E,7,7]): d r / d xi_i and d r / d xi_j at xi = 0, by
    central differences of the residual evaluated in float64 (step h): all
    28 perturbed residuals in one batched call. Against `jax.jacfwd` of the
    same function in f32 they agree to 2.4e-7 (test_torch_loop_components)."""
    E = S_i.shape[0]
    f64 = torch.float64
    steps = torch.eye(7, dtype=f64, device=S_i.device) * h
    steps = torch.cat([steps, -steps])[:, None, :].expand(14, E, 7)
    zero = torch.zeros_like(steps)
    S = [x.to(f64)[None].expand((28,) + x.shape) for x in (S_i, S_j, S_meas)]
    r = _perturbed_residual(torch.cat([steps, zero]), torch.cat([zero, steps]),
                            *S)                                   # [28, E, 7]
    return tuple(((r[k:k + 7] - r[k + 7:k + 14]) / (2 * h))
                 .permute(1, 2, 0).to(S_i.dtype) for k in (0, 14))


def _block_index(a, b):
    """Flat row and column indices of the 7x7 blocks (a[e], b[e]) of a
    [7K, 7K] matrix: rows 7*a + r, columns 7*b + c."""
    r = torch.arange(7, device=a.device)
    rows = (7 * a.to(torch.int64))[:, None, None] + r[None, :, None]
    cols = (7 * b.to(torch.int64))[:, None, None] + r[None, None, :]
    return rows.expand(-1, 7, 7), cols.expand(-1, 7, 7)


def optimize_pose_graph(poses, pose_valid, fixed_mask, edge_i, edge_j,
                        edge_meas, edge_weight, *, iters: int = 20,
                        fix_scale: bool = True, damping: float = 1e-6):
    """GN over Sim3 poses [K,8] (world -> keyframe). fixed_mask [K] bool
    pins anchors; edges i/j [E] with weight 0 are padding; edge_meas [E,8].
    Returns the optimized poses [K,8]. No host read."""
    K = poses.shape[0]
    dev = poses.device
    n = 7 * K
    ei = edge_i.to(torch.int64)
    ej = edge_j.to(torch.int64)
    w = edge_weight
    free = pose_valid & ~fixed_mask
    fixpen = torch.where(free, 0.0, 1e8).to(poses.dtype)
    diag = fixpen.repeat_interleave(7) + damping
    rows, cols = zip(_block_index(ei, ei), _block_index(ej, ej),
                     _block_index(ei, ej), _block_index(ej, ei))
    # padding edges (weight 0) add nothing: their entries are dropped
    used = (w > 0).repeat(4)[:, None, None]
    flat = torch.where(used, torch.cat(rows) * n + torch.cat(cols),
                       -1).reshape(-1)
    b_rows = torch.cat([7 * ei[:, None] + torch.arange(7, device=dev),
                        7 * ej[:, None] + torch.arange(7, device=dev)])
    b_rows = torch.where((w > 0).repeat(2)[:, None], b_rows, -1).reshape(-1)
    scale_w = torch.ones(7, dtype=poses.dtype, device=dev)
    scale_w[6] = 100.0

    for _ in range(iters):
        S_i, S_j = poses[ei], poses[ej]
        r = edge_residual(S_i, S_j, edge_meas)                    # [E,7]
        Ji, Jj = edge_jacobians(S_i, S_j, edge_meas)
        if fix_scale:
            # pin the scale dof hard: heavy weight on the sigma residual
            r = r * scale_w
            Ji = Ji * scale_w[:, None]
            Jj = Jj * scale_w[:, None]
        blocks = torch.cat([
            torch.einsum("eri,erj,e->eij", Ji, Ji, w),
            torch.einsum("eri,erj,e->eij", Jj, Jj, w),
            torch.einsum("eri,erj,e->eij", Ji, Jj, w),
            torch.einsum("eri,erj,e->eij", Jj, Ji, w)])
        H = segment_sum(blocks.reshape(-1), flat, n * n).reshape(n, n)
        H = H + torch.diag(diag)
        b = segment_sum(torch.cat([
            torch.einsum("eri,er,e->ei", Ji, r, w),
            torch.einsum("eri,er,e->ei", Jj, r, w)]).reshape(-1), b_rows, n)
        dx = linalg.solve(H, -b).reshape(K, 7)
        dx = torch.where(free[:, None], dx, 0.0)
        poses = se3.sim3_compose(se3.sim3_exp(dx), poses)
        if fix_scale:
            poses = torch.cat([poses[:, :7], torch.where(
                pose_valid[:, None], 1.0, poses[:, 7:])], 1)
    return poses


def build_essential_edges(cov, kf_pose_sim3, spanning_parent,
                          loop_i, loop_j, loop_meas,
                          min_covis_weight: float = 100.0,
                          max_edges: int = 2048, device="cpu"):
    """Assemble the essential graph's edge lists on the host: spanning-tree
    edges, strong covisibility edges (weight >= `min_covis_weight`), then
    the loop edges with their Sim3 measurements; tree and covisibility
    measurements come from the current poses. cov [K,K] and kf_pose_sim3
    [K,8] are numpy. Returns (edge_i, edge_j, edge_meas, edge_w) padded to
    `max_edges`, as tensors on `device`."""
    K = cov.shape[0]
    ei, ej, ew = [], [], []
    for k in range(K):
        p = int(spanning_parent[k])
        if p >= 0:
            ei.append(k)
            ej.append(p)
            ew.append(1.0)
    ii, jj = np.where(np.triu(np.asarray(cov), 1) >= min_covis_weight)
    ei += [int(a) for a in ii]
    ej += [int(b) for b in jj]
    ew += [1.0] * len(ii)
    poses = torch.as_tensor(np.array(kf_pose_sim3, np.float32))
    meas = se3.sim3_compose(poses[ei], se3.sim3_inverse(poses[ej])).numpy()
    li = [int(a) for a in np.asarray(loop_i).tolist()]
    lj = [int(b) for b in np.asarray(loop_j).tolist()]
    meas = np.concatenate([meas.reshape(-1, 8),
                           np.asarray(loop_meas, np.float32).reshape(-1, 8)])
    ei += li
    ej += lj
    ew += [2.0] * len(li)

    E = len(ei)
    pad = max_edges - E
    assert pad >= 0, f"too many edges: {E} > {max_edges}"
    ident = se3.sim3_identity().numpy()
    edge_meas = np.concatenate([meas, np.tile(ident[None], (pad, 1))], 0)
    return (torch.tensor(ei + [0] * pad, dtype=torch.int32, device=device),
            torch.tensor(ej + [0] * pad, dtype=torch.int32, device=device),
            torch.as_tensor(edge_meas, dtype=torch.float32, device=device),
            torch.tensor(ew + [0.0] * pad, dtype=torch.float32, device=device))
