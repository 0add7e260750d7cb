"""Local-map queries: frustum culling, scale prediction, local point
selection, and BA-window assembly.

Port of `sgslam_tpu/mapstate/local_map.py`. Every top-k here is a stable
sort (`topk_stable`), so ties go to the lower index as with `lax.top_k`:
covisibility weights, slot numbers and observation counts are tied often.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..geometry import se3
from ..geometry.camera import Camera, in_image, project
from ..ops.orb import topk_stable
from ..optim.local_ba import BAProblem
from .mapstate import NO_POINT, MapState, _set_rows


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


# Cephes' logf polynomial, its coefficients rounded to f32
_LOG_P = [float(v) for v in torch.tensor(
    [7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
     1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
     3.3333331174e-1], dtype=torch.float32)]


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


def _gauge_fix(ids, ok, opt_mask):
    """If no fixed keyframe exists (early map), fix the oldest in-window
    keyframe."""
    any_fixed = torch.any(ok & ~opt_mask)
    oldest_pos = torch.argmin(torch.where(ok, ids, 10 ** 9))
    first_fixed = opt_mask & (torch.arange(ids.shape[0], device=ids.device)
                              != oldest_pos)
    return torch.where(any_fixed, opt_mask, first_fixed)


def ba_window(m: MapState, center_kf, cov, window: int = 8, n_fixed: int = 8):
    """Select the local-BA keyframe window around `center_kf`: the center
    and its top (window-1) covisible keyframes are optimized, the next
    `n_fixed` covisible keyframes are fixed anchors (Optimizer.cc:456-504).
    Returns (kf_ids [W+F] i32, opt_mask [W+F]); invalid slots get id -1.
    """
    w_center = cov[center_kf].clone()             # [K]
    w_center[center_kf] = torch.inf               # center always first
    top_w, top_i = topk_stable(w_center, window + n_fixed)
    ok = top_w > 0
    ids = torch.where(ok, top_i, -1).to(torch.int32)
    opt_mask = (torch.arange(window + n_fixed, device=ids.device)
                < window) & ok
    return ids, _gauge_fix(ids, ok, opt_mask)


def ba_window_temporal(m: MapState, center_kf, window: int = 8,
                       n_fixed: int = 4):
    """Temporal local-BA window: the most recent `window` valid keyframes
    at or before `center_kf` optimized, the `n_fixed` before them fixed.
    Culled slots (kf_valid False) are skipped."""
    W = window + n_fixed
    slot = torch.arange(m.max_kf, dtype=torch.int32, device=m.device)
    prio = torch.where(m.kf_valid & (slot <= center_kf), slot, -1)
    top = topk_stable(prio, W)[0]           # descending recency
    ok = top >= 0
    ids = torch.where(ok, top, -1).to(torch.int32)
    opt_mask = (torch.arange(W, device=m.device) < window) & ok
    return ids, _gauge_fix(ids, ok, opt_mask)


def build_ba_problem(cam: Camera, m: MapState, kf_ids, opt_mask,
                     max_points: int = 4096,
                     scale_factor: float = 1.2) -> tuple[BAProblem,
                                                          torch.Tensor]:
    """Assemble the fixed-capacity BAProblem for a keyframe window.

    Observations = every (window KF, feature) pair whose observation points
    at a selected local point; up to `max_points` points, those with the
    most in-window observations first. Returns (problem, point_ids [PL]).
    """
    dev = m.device
    P = m.max_pt
    kf_ok = kf_ids >= 0
    kf_safe = torch.where(kf_ok, kf_ids, 0).to(torch.int64)

    obs_pt_global = torch.where(kf_ok[:, None], m.kf_obs_point[kf_safe],
                                NO_POINT)                    # [W,N]
    obs_slot = torch.where(obs_pt_global >= 0, obs_pt_global,
                           P).to(torch.int64)
    counts = torch.zeros(P + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, obs_slot.reshape(-1),
                      torch.ones_like(obs_slot, dtype=torch.int32).reshape(-1))
    counts = counts[:P] * m.pt_valid.to(torch.int32)
    top_c, pt_ids = topk_stable(counts, max_points)
    pt_ok = top_c > 0
    # global pid -> local index, slot P for "no point". The reference also
    # writes the unselected entries into slot P (different values at one
    # index); that slot is read only for observations masked out below, so
    # here those writes are dropped.
    local_of = _set_rows(
        torch.full((P + 1,), -1, dtype=torch.int32, device=dev),
        torch.where(pt_ok, pt_ids, P + 1),
        torch.arange(max_points, dtype=torch.int32, device=dev))

    obs_local = local_of[obs_slot]
    obs_valid = (obs_local >= 0) & kf_ok[:, None] & (obs_pt_global >= 0)

    uv = m.kf_feat_xy[kf_safe]                                # [W,N,2]
    ur = m.kf_feat_uvr[kf_safe]                               # [W,N]
    lv = m.kf_feat_level[kf_safe].to(torch.float32)
    inv_sigma2 = (1.0 / scale_factor ** 2) ** lv

    prob = BAProblem(
        poses=m.kf_pose[kf_safe],
        opt_mask=opt_mask & kf_ok,
        points=m.pt_pos[pt_ids],
        obs_pt=torch.where(obs_valid, obs_local, 0).to(torch.int32),
        obs_uvr=torch.cat([uv, ur[..., None]], -1),
        obs_w=inv_sigma2 * obs_valid.to(torch.float32),
    )
    return prob, torch.where(pt_ok, pt_ids, NO_POINT).to(torch.int32)


def writeback_ba(m: MapState, kf_ids, opt_mask, new_poses,
                 pt_ids, new_points) -> MapState:
    """Write optimized poses/points back into the map (a new MapState).
    Window keyframe ids and point ids are distinct, so no two writes meet."""
    kf_slot = torch.where((kf_ids >= 0) & opt_mask, kf_ids, m.max_kf)
    pt_slot = torch.where(pt_ids >= 0, pt_ids, m.max_pt)
    return dataclasses.replace(
        m, kf_pose=_set_rows(m.kf_pose, kf_slot.to(torch.int64), new_poses),
        pt_pos=_set_rows(m.pt_pos, pt_slot.to(torch.int64), new_points))
