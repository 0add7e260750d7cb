"""Batched RANSAC PnP for relocalization.

Port of `sgslam_tpu/optim/pnp.py`: a 6-point DLT minimal solver (linear
P-matrix from the SVD null vector, rotation orthogonalized with a
determinant fix), all hypotheses as one batched SVD, then the Huber-robust
pose optimization on the best hypothesis's inliers.

SVD null vectors and singular vectors have no fixed sign, and LAPACK,
cuSOLVER and XLA need not pick the same one; compare poses, not the raw
factors. The sample ranks are an argument (the reference's
`randint(key, (iters, 6), ...)` draws), by default drawn from a
`torch.Generator` without a host read.
"""

from __future__ import annotations

import torch

from ..geometry import linalg, se3
from ..geometry.camera import Camera, project
from ..geometry.epipolar import draw_ranks
from .pose_opt import pose_optimization


def dlt_pose(pw, uv, cam: Camera):
    """Linear 6+ point pose: pw [..., M, 3] world, uv [..., M, 2] pixels ->
    Tcw [..., 7]."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    Xh = torch.cat([pw, torch.ones_like(pw[..., :1])], -1)        # [..., M, 4]
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -x[..., None] * Xh], -1)
    r2 = torch.cat([zeros, Xh, -y[..., None] * Xh], -1)
    A = torch.cat([r1, r2], -2)                             # [..., 2M, 12]
    _, _, Vt = linalg.svd(A, full_matrices=True)
    P = Vt[..., -1, :].reshape(*Vt.shape[:-2], 3, 4)
    U, S, Vt2 = linalg.svd(P[..., :3])
    d = torch.linalg.det(U @ Vt2)
    D = torch.ones(d.shape + (3,), dtype=d.dtype, device=d.device)
    D = torch.cat([D[..., :2], d[..., None]], -1)
    R = U @ torch.diag_embed(D) @ Vt2
    scale = torch.sum(S, -1) / 3.0 * torch.sign(d)
    scale = torch.where(torch.abs(scale) < 1e-9, 1e-9, scale)
    t = P[..., 3] / scale[..., None]
    # cheirality: flip so that the points land in front of the camera
    pc = pw @ R.transpose(-1, -2) + t[..., None, :]
    zmean = torch.mean(pc[..., 2], -1)
    flip = (zmean < 0)[..., None]
    R = torch.where(flip[..., None], -R, R)
    t = torch.where(flip, -t, t)
    return se3.se3_make(se3.mat_to_quat(R), t)


def ransac_pnp(cam: Camera, pw, uv, valid, generator=None, *, samples=None,
               iters: int = 256, thresh_px: float = 3.0):
    """Batched hypothesize-and-verify PnP. pw [N,3] world points, uv [N,2]
    observed pixels, valid [N]. `samples` [iters, 6] are ranks into the
    valid-first order; else drawn from `generator`.
    Returns (Tcw [7], inlier_mask [N], n_inliers), all on the device."""
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    if samples is None:
        if generator is None:
            raise ValueError("ransac_pnp needs a generator or samples")
        samples = draw_ranks(valid.sum(), iters, 6, generator)
    idx = order[samples.to(device=order.device, dtype=torch.int64)]
    Ts = dlt_pose(pw[idx], uv[idx], cam)                          # [iters, 7]

    pc = se3.se3_apply(Ts[:, None, :], pw)                  # [iters, N, 3]
    err = torch.sum((project(cam, pc) - uv) ** 2, -1)
    inl = (err < thresh_px ** 2) & (pc[..., 2] > 0.05) & valid
    counts = torch.sum(inl.to(torch.int32), 1)
    best = torch.argmax(counts).reshape(1)       # first maximum, no host read
    T0 = Ts.index_select(0, best)[0]
    obs = torch.cat([uv, -torch.ones_like(uv[:, :1])], 1)         # mono
    return pose_optimization(cam, T0, pw, obs, torch.ones_like(uv[:, 0]),
                             inl.index_select(0, best)[0], rounds=2, iters=8)
