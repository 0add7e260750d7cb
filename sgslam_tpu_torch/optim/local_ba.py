"""Windowed bundle adjustment with batched Schur-complement reduction.

Port of `sgslam_tpu/optim/local_ba.py` (`BAProblem`, `inv3x3`,
`_residual_jac`, `_huber`, `bundle_adjust`): two-phase robust LM over a
camera-major [C, N] observation layout, point blocks eliminated by a Schur
complement and one [6C, 6C] solve per iteration.

What differs from the reference, and why:
  * the point-block sums (H_pp, b_p and the camera-point coupling A) are
    a segment sum (`ops.segment.segment_sum`, in a fixed order) over
    `c * P + obs_pt` into a [C * P, 30] buffer. The
    reference contracts a bf16 one-hot [C, N, P] with the [C, N, 30]
    per-observation blocks on the TPU's matrix unit; at window 16+8, 2176
    features and 4096 points that one-hot alone is 428 MB, where the
    scatter reads each observation once;
  * the per-observation blocks are still rounded to bf16 before the sum
    (see `_point_block_sums`), so that the port computes the reference's
    function and not a more exact one;
  * each phase's `lax.while_loop` is a Python loop that reads the exit flag
    on the host after every iteration (at most iters1 + iters2 reads per
    call). The exit rule is the reference's, unchanged. With tol=0 (the
    global BA) the flag is not read: it stays on the device and freezes the
    state once set, so the whole budget runs without a host read.

On the active tracer (`utils/timing.active()`) each LM iteration is a
`backend.lm_iter` span; `ba.calls` counts the calls and `ba.lm_iters` the
iterations each phase ran.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import linalg, se3
from ..geometry.camera import Camera
from ..ops.segment import segment_sum
from ..utils import timing

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
LAM_MAX = 1e2


@dataclasses.dataclass
class BAProblem:
    """Fixed-capacity BA problem, camera-major observation layout."""

    poses: torch.Tensor       # [C,7] Tcw
    opt_mask: torch.Tensor    # [C] bool — pose is optimized
    points: torch.Tensor      # [P,3]
    obs_pt: torch.Tensor      # [C,N] i32 local point index (invalid -> any)
    obs_uvr: torch.Tensor     # [C,N,3] (u, v, u_right<0 for mono)
    obs_w: torch.Tensor       # [C,N] f32 inv_sigma2 * validity (0 disables)


def inv3x3(M):
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack([torch.stack([A, B, C], -1),
                       torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return adj * inv_det[..., None, None]


def _residual_jac(cam: Camera, poses, points, prob: BAProblem):
    """Per-observation residuals/Jacobians on the [C, N] layout.

    Returns r [C,N,3], Jc [C,N,3,6], Jp [C,N,3,3].
    """
    T = poses[:, None, :]                         # [C,1,7]
    pw = points[prob.obs_pt.to(torch.int64)]      # [C,N,3]
    pc = se3.se3_apply(T, pw)
    x, y = pc[..., 0], pc[..., 1]
    z = torch.clamp(pc[..., 2], min=1e-6)
    invz = 1.0 / z
    u = cam.fx * x * invz + cam.cx
    v = cam.fy * y * invz + cam.cy
    ur = u - cam.bf * invz
    stereo = prob.obs_uvr[..., 2] >= 0
    r = torch.stack([u - prob.obs_uvr[..., 0], v - prob.obs_uvr[..., 1],
                     torch.where(stereo, ur - prob.obs_uvr[..., 2], 0.0)], -1)

    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    du = torch.stack([cam.fx * invz, zeros, -cam.fx * x * invz * invz], -1)
    dv = torch.stack([zeros, cam.fy * invz, -cam.fy * y * invz * invz], -1)
    dur = du + torch.stack([zeros, zeros, cam.bf * invz * invz], -1)
    Jproj = torch.stack([du, dv, torch.where(stereo[..., None], dur, 0.0)], -2)

    dpc = torch.stack([
        torch.stack([ones, zeros, zeros, zeros, pc[..., 2], -pc[..., 1]], -1),
        torch.stack([zeros, ones, zeros, -pc[..., 2], zeros, pc[..., 0]], -1),
        torch.stack([zeros, zeros, ones, pc[..., 1], -pc[..., 0], zeros], -1),
    ], -2)                                        # [C,N,3,6]
    Jc = torch.einsum("cnij,cnjk->cnik", Jproj, dpc)
    R = se3.quat_to_mat(poses[:, None, :4])       # [C,1,3,3]
    Jp = torch.einsum("cnij,cnjk->cnik", Jproj, R.expand(Jproj.shape[:2]
                                                         + (3, 3)))
    return r, Jc, Jp


def _huber(chi2, delta2):
    return torch.where(chi2 <= delta2, 1.0,
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def _point_block_sums(prob: BAProblem, rhs_all, n_points: int):
    """[C, P, 30] sums over each camera's observations of every point, of
    the per-observation blocks rhs_all [C, N, 30].

    The reference feeds rhs_all to the TPU's matrix unit in bf16 and
    accumulates in f32. The rounding is kept: swapping it for f32 on the
    eval map's 16+8 window moves poses by up to 2.7 mm and one badly
    constrained point by 3.7 m, a different result rather than the same
    one made faster. Rows with obs_w == 0 are dropped, as the reference's
    one-hot zeroes them. The sum runs in a fixed order, so it repeats on
    the card.
    """
    C, N, K = rhs_all.shape
    rhs = rhs_all.to(torch.bfloat16).to(torch.float32)
    cam = torch.arange(C, device=rhs.device, dtype=torch.int64)[:, None]
    slot = torch.where(prob.obs_w > 0,
                       cam * n_points + prob.obs_pt.to(torch.int64), -1)
    out = segment_sum(rhs.reshape(C * N, K), slot.reshape(-1), C * n_points)
    return out.reshape(C, n_points, K)


def bundle_adjust(cam: Camera, prob: BAProblem, *, iters1: int = 5,
                  iters2: int = 10, damping: float = 1e-3,
                  tol: float = 3e-5):
    """Two-phase robust BA. Returns (poses, points, obs_inlier_mask [C,N]).

    iters1/iters2 are budgets: each phase stops once an accepted LM step
    improves the cost by less than `tol` (relative), or a step is rejected
    with the damping already at its ceiling. tol=0.0 runs the full budget.
    """
    C, N = prob.obs_pt.shape
    P = prob.points.shape[0]
    dev = prob.points.device
    delta2 = torch.where(prob.obs_uvr[..., 2] >= 0, CHI2_STEREO, CHI2_MONO)
    cam_opt = prob.opt_mask[:, None]
    eye_c = torch.eye(C, dtype=torch.float32, device=dev)

    def rho(chi2, use_huber):
        if not use_huber:
            return chi2
        return torch.where(chi2 <= delta2, chi2,
                           2.0 * torch.sqrt(delta2 * torch.clamp(chi2,
                                                                 min=1e-12))
                           - delta2)

    def gn_iter(state, use_huber):
        """One LM step; returns (state', improved, rel, stuck)."""
        poses, points, obs_mask, lam = state
        r, Jc, Jp = _residual_jac(cam, poses, points, prob)
        chi2 = torch.sum(r * r, -1) * prob.obs_w
        cost_old = torch.sum(rho(chi2, use_huber) * obs_mask)
        hw = _huber(chi2, delta2) if use_huber else 1.0
        w = prob.obs_w * hw * obs_mask                     # [C,N]
        Jc_m = torch.where(cam_opt[..., None, None], Jc, 0.0)

        # camera blocks: plain row reductions
        Hcc = torch.einsum("cnri,cnrj,cn->cij", Jc_m, Jc_m, w)   # [C,6,6]
        bc = torch.einsum("cnri,cnr,cn->ci", Jc_m, r, w)

        # point blocks: Hpp (9 cols), bp (3) and the coupling A (18)
        JpJp = torch.einsum("cnri,cnrj,cn->cnij", Jp, Jp, w)     # [C,N,3,3]
        Jpr = torch.einsum("cnri,cnr,cn->cni", Jp, r, w)
        JcJp = torch.einsum("cnri,cnrj,cn->cnij", Jc_m, Jp, w)   # [C,N,6,3]
        rhs_all = torch.cat([JpJp.reshape(C, N, 9), Jpr,
                             JcJp.reshape(C, N, 18)], -1)        # [C,N,30]
        out = _point_block_sums(prob, rhs_all, P)                # [C,P,30]
        Hpp = torch.sum(out[..., :9], dim=0).reshape(P, 3, 3)
        bp = torch.sum(out[..., 9:12], dim=0)                    # [P,3]
        A = out[..., 12:30].reshape(C, P, 6, 3)

        # LM with relative (diagonal-proportional) damping
        dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        Hpp_d = (Hpp + lam * torch.diag_embed(dpp)
                 + 1e-6 * torch.eye(3, device=dev))
        Hpp_inv = inv3x3(Hpp_d)
        M = torch.einsum("cpis,pst->cpit", A, Hpp_inv)          # [C,P,6,3]
        S = -torch.einsum("cpit,dpjt->cidj", M, A)
        # the reference's S.at[arange(C), :, arange(C), :].add(Hcc): Hcc[c]
        # on the block diagonal S[c, :, c, :]
        S = S + eye_c[:, None, :, None] * Hcc[:, :, None, :]
        rhs = bc - torch.einsum("cpit,pt->ci", M, bp)

        Sd = S.reshape(C * 6, C * 6)
        diag_s = torch.diagonal(Sd)
        Sd = Sd + torch.diag(lam * diag_s + 1e-4)
        dc = linalg.solve(Sd, -rhs.reshape(-1)).reshape(C, 6)
        dc = torch.where(cam_opt, dc, 0.0)
        dp = -torch.einsum("pst,pt->ps", Hpp_inv,
                           bp + torch.einsum("cpis,ci->ps", A, dc))

        new_poses = se3.se3_compose(se3.se3_exp(dc), poses)
        new_poses = torch.where(cam_opt, new_poses, poses)
        new_points = points + dp

        # accept only improving steps
        rr, _, _ = _residual_jac(cam, new_poses, new_points, prob)
        c2 = torch.sum(rr * rr, -1) * prob.obs_w
        cost_new = torch.sum(rho(c2, use_huber) * obs_mask)

        # adaptive LM: shrink damping on accepted steps, grow on rejects
        improved = cost_new < cost_old
        poses = torch.where(improved, new_poses, poses)
        points = torch.where(improved, new_points, points)
        lam_next = torch.where(improved, torch.clamp(lam * 0.5, min=1e-5),
                               torch.clamp(lam * 4.0, max=LAM_MAX))
        rel = (cost_old - cost_new) / torch.clamp(cost_old, min=1e-9)
        # "stuck": rejected with the damping already at its ceiling
        stuck = ~improved & (lam >= LAM_MAX)
        return (poses, points, obs_mask, lam_next), improved, rel, stuck

    tr = timing.active()
    tr.count("ba.calls")

    def phase(state, iters, use_huber):
        if tol > 0:
            for _ in range(iters):
                tr.count("ba.lm_iters")
                with tr.span("backend.lm_iter"):
                    state, improved, rel, stuck = gn_iter(state, use_huber)
                    exit_now = bool((improved & (rel < tol)) | stuck)
                if exit_now:
                    break
            return state
        # tol=0 (global BA) runs its whole budget: the exit flag stays on
        # the device and freezes the state once set, as the reference's
        # while_loop would have stopped there
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(iters):
            tr.count("ba.lm_iters")
            with tr.span("backend.lm_iter"):
                new, improved, rel, stuck = gn_iter(state, use_huber)
                state = tuple(torch.where(done, a, b)
                              for a, b in zip(state, new))
                done = done | (improved & (rel < tol)) | stuck
        return state

    obs_valid = prob.obs_w > 0
    lam0 = torch.tensor(damping, dtype=torch.float32, device=dev)
    state = (prob.poses, prob.points, obs_valid.to(torch.float32), lam0)
    poses, points, _, lam = phase(state, iters1, True)

    # outlier gating between phases (Optimizer.cc:659-676)
    r, _, _ = _residual_jac(cam, poses, points, prob)
    chi2 = torch.sum(r * r, -1) * prob.obs_w
    inlier = obs_valid & (chi2 <= delta2)
    poses, points, _, _ = phase(
        (poses, points, inlier.to(torch.float32), lam), iters2, False)
    r, _, _ = _residual_jac(cam, poses, points, prob)
    chi2 = torch.sum(r * r, -1) * prob.obs_w
    inlier = inlier & (chi2 <= delta2)
    return poses, points, inlier
