"""Frame tracking against the map: `sgslam_tpu_torch/slam/tracking.py`
(`track_step`), `mapstate/local_map.py` (local-point selection) and
`optim/pose_opt.py` (motion-only BA). `m` is the program's map as the
call received it; only its tensors are read.

Frozen copy of the files named above as of commit 1275b16, with
their imports pointed at this folder. It imports nothing of the
program.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from . import linalg, search, se3
from .camera import in_image, project
from .orb import topk_stable


NO_POINT = -1


# Cephes' logf polynomial, its coefficients rounded to f32
_LOG_P = [float(v) for v in torch.tensor(
    [7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
     1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
     3.3333331174e-1], dtype=torch.float32)]


@dataclasses.dataclass
class LocalPoints:
    """Fixed-capacity set of candidate map points for frame association."""

    ids: torch.Tensor        # [L] i32 global point ids
    pos: torch.Tensor        # [L,3]
    desc: torch.Tensor       # [L,8] i32
    proj_uv: torch.Tensor    # [L,2] predicted pixel coords
    pred_level: torch.Tensor  # [L] i32
    radius: torch.Tensor     # [L] f32 search radius factor (px at level 0)
    valid: torch.Tensor      # [L] bool

    def to(self, device) -> "LocalPoints":
        return LocalPoints(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})


def _fma(a, b, c):
    """f32 a * b + c with one rounding (the product is exact in f64)."""
    return (a.double() * b + c).float()


def _log_f32(x):
    """Natural log of f32 x > 0 as XLA's CPU backend computes it: Cephes'
    range reduction and degree-8 polynomial, with fused multiply-adds.

    The predicted level ceil(log(ratio) / log(1.2)) below sits exactly on an
    integer whenever the predicted pose is the one that created the point
    (ratio = 1.2**level), so which way its log rounds decides the level.
    `torch.log` is nearly correctly rounded and this polynomial is not: with
    `torch.log`, 35 of 256 levels flipped on the first tracked frame of the
    30-frame parity fixture and the trajectories drifted up to 10 mm apart;
    with this one they agree to 1e-6 m (tests/test_torch_tracking.py).
    """
    x = torch.clamp(x.to(torch.float32), min=1.17549435e-38)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    # mantissa in [0.5, 1)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < 0.707106781186547524
    e = e - small.to(torch.float32)
    m = (m - 1.0) + torch.where(small, m, 0.0)
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, m3, y1), m3, y2) * m3
    y = y + (-2.12194440e-4) * e
    m = m - m2 * 0.5
    return (m + y) + 0.693359375 * e


def _level_of_ratio(ratio, scale_factor: float):
    """The reference's predicted level, clip(ceil(log(ratio) /
    log(scale_factor)), 0, 7), with its log as `_log_f32` computes it."""
    return torch.clamp(torch.ceil(_log_f32(ratio) / math.log(scale_factor))
                       .to(torch.int32), 0, 7)


@functools.lru_cache(maxsize=None)
def _level_thresholds(scale_factor: float, device) -> torch.Tensor:
    """[7] f32: entry k is the least f32 ratio whose `_level_of_ratio` is
    above k, so that the level is the number of thresholds at or below the
    ratio. Found once per scale factor by a bisection over f32 bit patterns
    on the CPU; a per-frame `bucketize` against them replaces the ~30
    elementwise launches of `_log_f32` (tests/test_torch_mapstate.py holds
    the two equal around every threshold)."""
    k = torch.arange(7, dtype=torch.int32)
    lo = torch.full((7,), 0x358637BD, dtype=torch.int32)   # 1e-6: level 0
    hi = torch.full((7,), 0x447A0000, dtype=torch.int32)   # 1000: level 7
    while bool((hi - lo > 1).any()):
        mid = lo + (hi - lo) // 2
        above = _level_of_ratio(mid.view(torch.float32), scale_factor) > k
        hi = torch.where(above, mid, hi)
        lo = torch.where(above, lo, mid)
    return hi.view(torch.float32).to(device)


def _pred_level(ratio, scale_factor: float):
    """[L] i32 predicted pyramid level of f32 distance ratios: the number of
    `_level_thresholds` at or below each (clamped) ratio, one launch."""
    return torch.bucketize(
        torch.clamp(ratio, min=1e-6),
        _level_thresholds(float(scale_factor), ratio.device), out_int32=True,
        right=True)


def select_local_points(cam: Camera, m: MapState, Tcw,
                        scale_factor: float = 1.2,
                        capacity: int = 4096) -> LocalPoints:
    """Frustum-cull all map points against the predicted pose and keep the
    best `capacity` (by found-count) as association candidates.

    The priority 1e6 + found is tied for most points, so the top-k is a
    stable sort: ties go to the lower point id, as with `lax.top_k`.
    """
    pc = se3.se3_apply(Tcw[None], m.pt_pos)
    z = pc[..., 2]
    uv = project(cam, pc)
    Twc = se3.se3_inverse(Tcw)
    dvec = m.pt_pos - Twc[None, 4:7]
    dist = torch.linalg.vector_norm(dvec, dim=-1)
    view_cos = torch.sum(dvec * m.pt_normal, dim=-1) / torch.clamp(dist,
                                                                   min=1e-6)

    ok = (m.pt_valid & (z > 0.1) & in_image(cam, uv)
          & (dist >= 0.8 * m.pt_min_dist) & (dist <= 1.3 * m.pt_max_dist)
          & (view_cos > 0.5))

    # predicted pyramid level (MapPoint::PredictScale)
    ratio = torch.clamp(m.pt_max_dist, min=1e-6) / torch.clamp(dist, min=1e-6)
    pred_level = _pred_level(ratio, scale_factor)
    # search radius by viewing angle (ORBmatcher::RadiusByViewingCos,
    # ORBmatcher.cc:131): 2.5 if cos > 0.998 else 4.0
    radius = torch.where(view_cos > 0.998, 2.5, 4.0)

    prio = torch.where(ok, 1e6 + m.pt_found.to(torch.float32), -torch.inf)
    top_p, top_i = topk_stable(prio, capacity)
    sel_ok = torch.isfinite(top_p)
    return LocalPoints(
        ids=torch.where(sel_ok, top_i, NO_POINT).to(torch.int32),
        pos=m.pt_pos[top_i],
        desc=m.pt_desc[top_i],
        proj_uv=uv[top_i],
        pred_level=pred_level[top_i],
        radius=radius[top_i],
        valid=sel_ok,
    )


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
    """
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


def _pose_inputs(cfg: SlamConfig, feats: orb.Features, idx):
    obs = torch.stack([feats.xy[idx, 0], feats.xy[idx, 1],
                       feats.u_right[idx]], -1)
    lv = feats.level[idx].to(torch.float32)
    inv_s2 = (1.0 / cfg.orb.scale_factor ** 2) ** lv
    return obs, inv_s2


def track_step(cfg, m, feats, Tcw_pred, fallback: str = "host"):
    """Track one frame against the map. Returns
    (Tcw, matched_pids [N], n_inliers, n_close_tracked, n_close_untracked,
    wants_fallback), all tensors on `device`; wants_fallback says that the
    stage-1 count called for the brute-force fallback below.

    Stage 1 = TrackWithMotionModel contract: wide projective search
    (radius 15 px) at the predicted pose + motion-only BA.
    Stage 2 = TrackLocalMap contract: re-project at the refined pose,
    tight search (radius by viewing angle), second BA, inlier counts.

    `fallback` says how the reference's `lax.cond` on the stage-1 count
    runs: "host" takes the brute-force fallback when a host read of the
    count asks for it; "device" always computes it and selects on the
    device (no host read, one more K1 launch and pose optimization);
    "skip" leaves it out, for a caller that checks wants_fallback later and
    redoes the frame with "device" where it was wanted (the chunked
    pipeline). The last two read nothing back.
    """
    dev = Tcw_pred.device
    t = cfg.tracker
    local = select_local_points(cfg.camera, m, Tcw_pred,
                                   scale_factor=cfg.orb.scale_factor,
                                   capacity=cfg.capacity.local_points)

    def associate_and_optimize(Tcw_in, radius_mult, max_dist, rounds, iters):
        pc = se3.se3_apply(Tcw_in[None], local.pos)
        idx, ok, dist = search.search_by_projection(
            project(cfg.camera, pc), local.radius * radius_mult,
            local.pred_level, local.desc, local.valid & (pc[..., 2] > 0.1),
            feats.xy, feats.level, feats.desc, feats.valid,
            level_window=1, max_dist=max_dist,
            scale_factor=cfg.orb.scale_factor)
        ok = search.resolve_duplicate_targets(idx, ok, dist, feats.capacity)
        obs, inv_s2 = _pose_inputs(cfg, feats, idx)
        Tcw, inl, n = pose_optimization(
            cfg.camera, Tcw_in, local.pos, obs, inv_s2, ok,
            rounds=rounds, iters=iters, guarded=False)
        return Tcw, idx, ok & inl, n

    # Stage 1: wide search at predicted pose (motion-model contract);
    # th_high=100 like SearchByProjection last-frame
    Tcw1, _, _, n1 = associate_and_optimize(
        Tcw_pred, t.search_radius_motion / 4.0, 100,
        t.pose_opt_rounds_stage1, t.pose_opt_iters_stage1)

    # Fallback when the windowed search fails (large/unmodeled motion):
    # descriptor-only brute force vs the local points, the contract of
    # TrackReferenceKeyFrame's SearchByBoW path (Tracking.cc:796-860).
    def brute_force():
        idx, ok, dist = search.match_by_descriptor(
            local.desc, local.valid, feats.desc, feats.valid, cfg.matcher,
            max_dist=cfg.matcher.th_low, mutual=True)
        ok = search.resolve_duplicate_targets(idx, ok, dist, feats.capacity)
        obs, inv_s2 = _pose_inputs(cfg, feats, idx)
        return pose_optimization(
            cfg.camera, Tcw_pred, local.pos, obs, inv_s2, ok)[0]

    wants_fallback = n1 < t.min_matches_motion
    if fallback == "device":
        Tcw1 = torch.where(wants_fallback, brute_force(), Tcw1)
    elif fallback == "host" and bool(wants_fallback):
        Tcw1 = brute_force()

    # Stage 2: tight local-map association at refined pose
    Tcw2, idx2, ok2, n2 = associate_and_optimize(
        Tcw1, 1.0, 100, t.pose_opt_rounds_stage2, t.pose_opt_iters_stage2)

    # per-feature matched point ids (invert point->feature matches); the
    # spare slot collects the unmatched local points
    cap = feats.capacity
    slot = torch.where(ok2, idx2, cap)
    matched = torch.full((cap + 1,), NO_POINT, dtype=torch.int32, device=dev)
    matched[slot] = local.ids
    matched = matched[:cap]

    # close-point bookkeeping for the KF decision (Tracking.cc:1040-1113)
    close = (feats.depth > 0) & (feats.depth < cfg.close_depth_threshold)
    tracked_close = torch.sum((matched >= 0) & close)
    untracked_close = torch.sum((matched < 0) & close & feats.valid)
    return Tcw2, matched, n2, tracked_close, untracked_close, wants_fallback
