"""Closed-form Horn absolute orientation and batched RANSAC Sim(3).

Port of `sgslam_tpu/optim/sim3.py` (`horn_alignment`, `optimize_sim3`,
`ransac_sim3`). Every RANSAC hypothesis is one row of a batched 4x4 `eigh`.

`eigh` may return either sign of an eigenvector (LAPACK and cuSOLVER need
not agree with XLA); Horn's quaternion is made w >= 0 afterwards, so the
sign never reaches the result. The RANSAC sample ranks are an argument
(`samples`, the reference's `randint(key, (iters, 3), ...)` draws); by
default they come from a `torch.Generator` without a host read.
"""

from __future__ import annotations

import torch

from ..geometry import linalg, se3
from ..geometry.camera import Camera, project
from ..geometry.epipolar import draw_ranks


def horn_alignment(src, dst, w, fix_scale: bool = True):
    """Weighted closed-form S with dst ~= s R src + t.

    src, dst: [N,3]; w: [..., N] non-negative weights (0 = ignore); a batch
    of weight rows gives a batch of alignments. Returns Sim3 [..., 8].
    """
    wsum = torch.clamp(torch.sum(w, -1), min=1e-9)[..., None]      # [..., 1]
    mu_s = torch.einsum("ni,...n->...i", src, w) / wsum
    mu_d = torch.einsum("ni,...n->...i", dst, w) / wsum
    xs = src - mu_s[..., None, :]                            # [..., N, 3]
    xd = dst - mu_d[..., None, :]
    M = torch.einsum("...ni,...nj,...n->...ij", xd, xs, w)   # [..., 3, 3]

    # Horn's 4x4 N matrix (max-eigenvector = rotation quaternion)
    S = [[M[..., i, j] for j in range(3)] for i in range(3)]
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = S
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    _, evecs = linalg.eigh(N)
    q = evecs[..., :, -1]                                          # max eigval
    # Horn's N yields the src<-dst rotation in this (w, x, y, z) convention:
    # conjugate to get dst = R src
    q = se3.quat_conj(q)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    q = se3.quat_normalize(q)

    if fix_scale:
        s = torch.ones(q.shape[:-1], dtype=q.dtype, device=q.device)
    else:
        rot = se3.quat_rotate(q[..., None, :], xs)
        num = torch.sum(w[..., None] * xd * rot, (-2, -1))
        den = torch.sum(w[..., None] * xs * xs, (-2, -1))
        s = num / torch.clamp(den, min=1e-9)
    t = mu_d - s[..., None] * se3.quat_rotate(q, mu_s)
    return torch.cat([q, t, s[..., None]], -1)


def _two_way_chi2(cam: Camera, S12, pts1, pts2, uv1, uv2):
    """Squared reprojection errors of frame-2 points into image 1 through
    S12 and of frame-1 points into image 2 through S12^-1 ([..., N] each)."""
    p2_in_1 = se3.sim3_apply(S12[..., None, :], pts2)
    e1 = torch.sum((project(cam, p2_in_1) - uv1) ** 2, -1)
    p1_in_2 = se3.sim3_apply(se3.sim3_inverse(S12)[..., None, :], pts1)
    e2 = torch.sum((project(cam, p1_in_2) - uv2) ** 2, -1)
    return e1, e2


def optimize_sim3(cam: Camera, S12_0, pts1, pts2, uv1, uv2, valid, *,
                  rounds: int = 2, iters: int = 5, fix_scale: bool = True,
                  chi2: float = 9.21):
    """Inlier-gated Gauss-Newton refinement of a Sim3 with two-way
    reprojection edges (Optimizer::OptimizeSim3), Huber-robust, chi2 gating
    between rounds; the scale is optimized when `fix_scale` is False.
    Left-multiplicative twist: S' = exp(delta) * S12.
    Returns (S12 [8], inlier_mask [N], n_inliers)."""
    fx, fy = cam.fx, cam.fy
    dev = pts1.device
    eye3 = torch.eye(3, dtype=pts1.dtype, device=dev)
    eye7 = torch.eye(7, dtype=pts1.dtype, device=dev)

    def jproj(p):
        z = torch.clamp(p[:, 2], min=1e-6)
        zero = torch.zeros_like(z)
        return torch.stack([
            torch.stack([fx / z, zero, -fx * p[:, 0] / z ** 2], -1),
            torch.stack([zero, fy / z, -fy * p[:, 1] / z ** 2], -1)], -2)

    def residuals(S12):
        q = se3.sim3_apply(S12[None], pts2)
        r1 = project(cam, q) - uv1
        Jq = torch.cat([eye3.expand(q.shape[0], 3, 3), -se3.hat(q),
                        q[:, :, None]], 2)                         # [N,3,7]
        J1 = torch.einsum("nij,njk->nik", jproj(q), Jq)
        p = se3.sim3_apply(se3.sim3_inverse(S12)[None], pts1)
        r2 = project(cam, p) - uv2
        Ju = torch.cat([eye3.expand(pts1.shape[0], 3, 3), -se3.hat(pts1),
                        pts1[:, :, None]], 2)
        Rt = se3.quat_to_mat(se3.quat_conj(S12[:4]))
        inv_s = 1.0 / torch.clamp(S12[7], min=1e-9)
        Jq2 = -inv_s * torch.einsum("ij,njk->nik", Rt, Ju)
        J2 = torch.einsum("nij,njk->nik", jproj(p), Jq2)
        return torch.cat([r1, r2], 1), torch.cat([J1, J2], 1)

    S12, inlier = S12_0, valid
    for _ in range(rounds):
        inl_f = inlier.to(torch.float32)
        for _ in range(iters):
            r, J = residuals(S12)
            e = torch.sum(r * r, -1)
            hw = torch.where(e <= chi2, 1.0,
                             torch.sqrt(chi2 / torch.clamp(e, min=1e-12)))
            w = hw * inl_f
            H = torch.einsum("nri,nrj,n->ij", J, J, w)
            b = torch.einsum("nri,nr,n->i", J, r, w)
            if fix_scale:          # freeze the sigma column (6-dof update)
                H = torch.cat([H[:6], torch.zeros_like(H[6:])], 0)
                H = torch.cat([H[:, :6], eye7[:, 6:]], 1)
                b = torch.cat([b[:6], torch.zeros_like(b[6:])])
            H = H + 1e-5 * eye7
            delta = linalg.solve(H, -b)
            S12 = se3.sim3_compose(se3.sim3_exp(delta), S12)
        e1, e2 = _two_way_chi2(cam, S12, pts1, pts2, uv1, uv2)
        inlier = valid & (e1 < chi2) & (e2 < chi2)
    return S12, inlier, torch.sum(inlier.to(torch.int32))


def ransac_sim3(cam: Camera, pts1, pts2, uv1, uv2, valid, generator=None, *,
                samples=None, iters: int = 128, fix_scale: bool = True,
                chi2: float = 9.21):
    """RANSAC Sim3 mapping frame-2 coordinates into frame 1 (Sim3Solver).

    pts1/pts2: [N,3] camera-frame 3-D of matched features; uv1/uv2: [N,2]
    pixels for the two-way reprojection inlier test. `samples` [iters, 3]
    are ranks into the valid-first order (the reference's `randint`); else
    they are drawn from `generator`. Returns (S12 [8], inlier_mask [N],
    n_inliers), all on the device.
    """
    n = pts1.shape[0]
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    if samples is None:
        if generator is None:
            raise ValueError("ransac_sim3 needs a generator or samples")
        samples = draw_ranks(valid.sum(), iters, 3, generator)
    idx = order[samples.to(device=order.device, dtype=torch.int64)]
    w = torch.zeros((idx.shape[0], n), dtype=pts1.dtype, device=pts1.device)
    w.scatter_(1, idx, 1.0)
    Ss = horn_alignment(pts2, pts1, w, fix_scale)                 # [iters, 8]

    def inliers_of(S):
        e1, e2 = _two_way_chi2(cam, S, pts1, pts2, uv1, uv2)
        return (e1 < chi2) & (e2 < chi2) & valid

    inl = inliers_of(Ss)                                           # [iters, N]
    counts = torch.sum(inl.to(torch.int32), 1)
    best = torch.argmax(counts).reshape(1)       # first maximum, no host read
    S = horn_alignment(pts2, pts1,
                       inl.index_select(0, best)[0].to(pts1.dtype), fix_scale)
    inl_f = inliers_of(S)
    return S, inl_f, torch.sum(inl_f.to(torch.int32))
