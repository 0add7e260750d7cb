"""Motion-only bundle adjustment: one camera pose vs fixed 3-D points.

Port of `sgslam_tpu/optim/pose_opt.py` (Optimizer::PoseOptimization's
contract): Gauss-Newton on the (u, v, u_right) pseudo-stereo residual, or
the 2-D mono residual where u_right < 0, with Huber weights in the first two
rounds and chi2 gating between rounds.

On CUDA tensors a call is one launch of `csrc/pose_opt.cu`
(`ops/pose_opt_cuda.py`), which runs every round and iteration on the card.
On CPU tensors the plain body below runs: the fixed-count loops are Python
loops, the guarded step's accept test is a `torch.where`, and the 6x6 solve
is `geometry.linalg.solve` in float32, which checks no error flag. Neither
reads anything back to the host. The tracer counts `pose_opt.calls` and,
of those, `pose_opt.kernel`.
"""

from __future__ import annotations

import torch

from ..geometry import linalg, se3
from ..geometry.camera import Camera
from ..ops.pose_opt_cuda import pose_opt_kernel
from ..utils import timing

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _residual_jac(cam: Camera, Tcw, pw, obs, inv_sigma2, stereo_mask):
    """Residuals r [N,3], Jacobians J [N,3,6] wrt left-mult twist on Tcw.

    Third residual row is the pseudo-stereo u_right term, zeroed for mono.
    Twist convention (v, w): Tcw' = exp([v, w]) * Tcw.
    """
    pc = se3.se3_apply(Tcw[None], pw)                   # [N,3]
    x, y = pc[..., 0], pc[..., 1]
    z = torch.clamp(pc[..., 2], min=1e-6)
    invz = 1.0 / z
    u = cam.fx * x * invz + cam.cx
    v = cam.fy * y * invz + cam.cy
    ur = u - cam.bf * invz

    r = torch.stack([u - obs[..., 0], v - obs[..., 1],
                     torch.where(stereo_mask, ur - obs[..., 2], 0.0)], dim=-1)

    # d(pc)/d(twist) = [ I | -hat(pc) ]   (left-multiplicative perturbation)
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    dpc = torch.stack([
        torch.stack([ones, zeros, zeros, zeros, pc[..., 2], -pc[..., 1]], -1),
        torch.stack([zeros, ones, zeros, -pc[..., 2], zeros, pc[..., 0]], -1),
        torch.stack([zeros, zeros, ones, pc[..., 1], -pc[..., 0], zeros], -1),
    ], dim=-2)                                            # [N,3,6]

    fx, fy, bf = cam.fx, cam.fy, cam.bf
    du = torch.stack([fx * invz, zeros, -fx * x * invz * invz], -1)  # [N,3]
    dv = torch.stack([zeros, fy * invz, -fy * y * invz * invz], -1)
    dur = du + torch.stack([zeros, zeros, bf * invz * invz], -1)
    Jproj = torch.stack([du, dv,
                         torch.where(stereo_mask[..., None], dur, 0.0)],
                        dim=-2)
    J = torch.einsum("nij,njk->nik", Jproj, dpc)           # [N,3,6]
    return r, J, inv_sigma2[..., None]


def _huber_weight(chi2, delta2):
    """Huber IRLS weight as a function of the chi2 value."""
    return torch.where(chi2 <= delta2, 1.0,
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def pose_optimization(cam: Camera, Tcw0, pw, obs, inv_sigma2, valid,
                      *, rounds: int = 4, iters: int = 10,
                      guarded: bool = True):
    """Optimize one pose. Returns (Tcw, inlier_mask, n_inliers).

    pw: [N,3] world points; obs: [N,3] (u, v, u_right<0 for mono);
    inv_sigma2: [N] per-observation information (1/1.2^(2 level));
    valid: [N] bool initial correspondence mask.

    guarded=True rejects steps that do not reduce the robust cost at the
    proposed pose; guarded=False trusts the damped GN step (half the
    residual evaluations), for callers that gate on the inlier count.

    CPU tensors take the plain body (`pose_optimization_reference`); CUDA
    tensors launch the kernel.
    """
    tr = timing.active()
    tr.count("pose_opt.calls")
    if pw.device.type == "cpu":
        return pose_optimization_reference(cam, Tcw0, pw, obs, inv_sigma2,
                                           valid, rounds=rounds, iters=iters,
                                           guarded=guarded)
    out = pose_opt_kernel(cam, Tcw0, pw, obs, inv_sigma2, valid,
                          rounds=rounds, iters=iters, guarded=guarded,
                          chi2_mono=CHI2_MONO, chi2_stereo=CHI2_STEREO)
    tr.count("pose_opt.kernel")
    return out


def pose_optimization_reference(cam: Camera, Tcw0, pw, obs, inv_sigma2,
                                valid, *, rounds: int = 4, iters: int = 10,
                                guarded: bool = True):
    """The plain body of `pose_optimization`, as torch ops on any device
    (on a card, about 200 launches an iteration)."""
    stereo_mask = obs[..., 2] >= 0
    delta2 = torch.where(stereo_mask, CHI2_STEREO, CHI2_MONO)
    eye6 = 1e-5 * torch.eye(6, dtype=pw.dtype, device=pw.device)

    def chi2_at(Tcw):
        r, _, _ = _residual_jac(cam, Tcw, pw, obs, inv_sigma2, stereo_mask)
        return torch.sum(r * r, dim=-1) * inv_sigma2

    Tcw, inlier = Tcw0, valid
    for round_i in range(rounds):
        use_huber = round_i < 2  # reference drops robust kernel at round 3
        inl_f = inlier.to(torch.float32)
        for _ in range(iters):
            r, J, _ = _residual_jac(cam, Tcw, pw, obs, inv_sigma2,
                                    stereo_mask)
            chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
            hw = _huber_weight(chi2, delta2) if use_huber else 1.0
            wn = inv_sigma2 * hw * inl_f                        # [N]
            H = torch.einsum("nri,nrj,n->ij", J, J, wn) + eye6  # [6,6]
            b = torch.einsum("nri,nr,n->i", J, r, wn)
            dx = linalg.solve(H, -b)
            Tnew = se3.se3_compose(se3.se3_exp(dx), Tcw)
            if not guarded:
                Tcw = Tnew
                continue
            c_old = torch.sum(chi2 * hw * inl_f)
            chi2n = chi2_at(Tnew)
            hwn = _huber_weight(chi2n, delta2) if use_huber else 1.0
            c_new = torch.sum(chi2n * hwn * inl_f)
            Tcw = torch.where(c_new < c_old, Tnew, Tcw)
        inlier = valid & (chi2_at(Tcw) <= delta2)
    return Tcw, inlier, torch.sum(inlier.to(torch.int32))
