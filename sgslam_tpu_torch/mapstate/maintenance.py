"""Map maintenance: point culling, keyframe culling, duplicate fusion,
epipolar triangulation of new points, and slot compaction.

Port of `sgslam_tpu/mapstate/maintenance.py` (LocalMapping's
MapPointCulling, KeyFrameCulling, SearchInNeighbors + Fuse and
CreateNewMapPoints, as masked passes over the fixed-capacity map). Each
function returns a new `MapState` and leaves its argument as it was.

Scatters whose indices repeat: the reference's JAX scatters leave the
order of repeated writes unspecified (the CPU backend applies them in
order, so the last one wins). Where repeated writes can carry different
values, the port applies one deterministic rule, named where it is used:
only `fuse_duplicates`' loser -> winner remap has such writes. Everywhere
else the repeated indices carry one value or fall into a spare slot that
is dropped.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MatcherConfig
from ..geometry import se3
from ..geometry.camera import Camera, project
from ..matching import search
from ..ops.orb import topk_stable
from .mapstate import NO_POINT, MapState, _set_rows


def _obs_count(m: MapState):
    """[P + 1] keyframe observations per point (slot P stays 0)."""
    obs = m.kf_obs_point.reshape(-1)
    slot = torch.where(obs >= 0, obs, m.max_pt).to(torch.int64)
    count = torch.zeros(m.max_pt + 1, dtype=torch.int32, device=m.device)
    return count.index_add_(0, slot, (obs >= 0).to(torch.int32))


def cull_map_points(m: MapState) -> MapState:
    """MapPointCulling contract: drop points whose found/visible ratio is
    below 0.25, or that stay nearly unobserved after creation."""
    obs_count = _obs_count(m)[:m.max_pt]
    ratio = (m.pt_found.to(torch.float32)
             / torch.clamp(m.pt_visible.to(torch.float32), min=1.0))
    seen_enough = torch.where(m.pt_visible >= 4, ratio >= 0.25, True)
    # points created >= 2 KFs ago need >= 2 keyframe observations
    age = m.next_kf - m.pt_first_kf
    obs_ok = torch.where(age >= 3, obs_count >= 2, True)
    return dataclasses.replace(m, pt_valid=m.pt_valid & seen_enough & obs_ok)


def cull_keyframes(m: MapState, protect_last: int = 2,
                   max_culls: int = 3) -> MapState:
    """KeyFrameCulling contract (LocalMapping.cc:632-696): a keyframe is
    redundant if >= 90% of its observed points are seen by >= 3 other
    keyframes. Up to `max_culls` keyframes per call, the lowest slot first,
    with observation counts recomputed after each cull."""
    ids = torch.arange(m.max_kf, device=m.device)
    # never cull KF 0 or the newest `protect_last`
    protected = (ids == 0) | (ids >= m.next_kf - protect_last)
    for _ in range(max_culls):
        obs = m.kf_obs_point
        has = obs >= 0
        cnt = _obs_count(m)[torch.where(has, obs, 0).to(torch.int64)]
        redundant_obs = has & (cnt >= 4)                 # >= 3 others + self
        n_obs = torch.sum(has, dim=1)
        n_red = torch.sum(redundant_obs, dim=1)
        redundant = (n_red.to(torch.float32)
                     >= 0.9 * torch.clamp(n_obs.to(torch.float32), min=1.0))
        cullable = m.kf_valid & redundant & ~protected
        cull = (ids == torch.argmax(cullable.to(torch.int32))) & cullable
        m = dataclasses.replace(
            m, kf_valid=m.kf_valid & ~cull,
            kf_obs_point=torch.where(cull[:, None], NO_POINT, obs))
    return m


def prev_valid_kf(m: MapState, kf_id):
    """Largest valid keyframe slot strictly before `kf_id` (-1 if none)."""
    slot = torch.arange(m.max_kf, dtype=torch.int32, device=m.device)
    return torch.max(torch.where(m.kf_valid & (slot < kf_id), slot, -1))


def fuse_duplicates(cam: Camera, m: MapState, kf_id,
                    scale_factor: float = 1.2,
                    max_candidates: int = 4096,
                    radius: float = 3.0) -> MapState:
    """Fuse contract (ORBmatcher::Fuse via LocalMapping::SearchInNeighbors):
    project map points into KF `kf_id`; when a projected point matches a
    feature already bound to a different point, merge into the
    better-observed point (rewriting observations everywhere); when it
    matches an unbound feature, add the observation.

    Candidates are frustum-culled to `max_candidates` first (stable top-k:
    the priority 1e6 + found is tied almost everywhere), so the Hamming
    matrix is [L, N].
    """
    dev = m.device
    P, N = m.max_pt, m.n_feat
    Tcw = m.kf_pose[kf_id]
    pc_all = se3.se3_apply(Tcw[None], m.pt_pos)
    uv_all = project(cam, pc_all)
    in_view = (m.pt_valid & (pc_all[:, 2] > 0.1)
               & (uv_all[:, 0] >= 0) & (uv_all[:, 0] < cam.width)
               & (uv_all[:, 1] >= 0) & (uv_all[:, 1] < cam.height))
    prio = torch.where(in_view, 1e6 + m.pt_found.to(torch.float32),
                       -torch.inf)
    top_p, cand = topk_stable(prio, max_candidates)        # [L] global pids
    cand_ok = torch.isfinite(top_p)
    L = max_candidates

    # windowed descriptor match candidate point -> feature of this KF
    idx, okm, dist = search.search_by_projection(
        uv_all[cand], torch.full((L,), radius, device=dev),
        torch.zeros(L, dtype=torch.int32, device=dev),
        m.pt_desc[cand], cand_ok,
        m.kf_feat_xy[kf_id], m.kf_feat_level[kf_id],
        m.kf_feat_desc[kf_id].contiguous(), m.kf_feat_valid[kf_id],
        level_window=7, max_dist=50, scale_factor=scale_factor)
    okm = search.resolve_duplicate_targets(idx, okm, dist, N) & cand_ok

    bound = m.kf_obs_point[kf_id][idx].to(torch.int64)   # existing pid or -1
    pid = torch.where(cand_ok, cand, P)                  # [L] global ids
    # merge: same feature claimed by the projected point and an existing
    # one -> keep the point with more keyframe observations
    obs_count = _obs_count(m)
    conflict = okm & (bound >= 0) & (bound != pid)
    keep_existing = (obs_count[torch.where(bound >= 0, bound, 0)]
                     >= obs_count[pid])
    loser = torch.where(conflict & keep_existing, pid,
                        torch.where(conflict, bound, -1))
    winner = torch.where(conflict & keep_existing, bound,
                         torch.where(conflict, pid, -1))
    # invalidate losers; rewrite all observations loser -> winner. One point
    # can lose twice, to different winners (as a candidate, and as the
    # bound point of another candidate's feature). Rule: the write of the
    # highest candidate index wins, which is the order the reference's CPU
    # scatter applies them in.
    lose_slot = torch.where(loser >= 0, loser, P)
    last = torch.full((P + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, lose_slot, torch.arange(L, device=dev), "amax")
    lost = last[:P] >= 0
    remap = torch.where(lost, winner[torch.clamp(last[:P], min=0)],
                        torch.arange(P, device=dev)).to(torch.int32)
    obs = m.kf_obs_point
    obs_new = torch.where(obs >= 0,
                          remap[torch.where(obs >= 0, obs, 0).to(torch.int64)],
                          obs)
    pt_valid = m.pt_valid & ~lost

    # bind unbound features to the projected point (one candidate per
    # feature after resolve_duplicate_targets: the slots are distinct)
    new_bind = okm & (bound == NO_POINT) & pt_valid[torch.clamp(pid, 0,
                                                                 P - 1)]
    row = _set_rows(obs_new[kf_id], torch.where(new_bind, idx, N),
                    torch.where(new_bind, pid, NO_POINT))
    obs_new[kf_id] = row
    return dataclasses.replace(m, pt_valid=pt_valid, kf_obs_point=obs_new)


def triangulate_new_points(cam: Camera, m: MapState, kf_a, kf_b,
                           scale_factor: float = 1.2,
                           max_new: int = 128) -> MapState:
    """CreateNewMapPoints contract (epipolar triangulation between two
    keyframes): match unbound features by descriptor distance, triangulate
    at the midpoint, check cheirality / parallax / reprojection, insert.

    The match is mutual, so the matched features of both keyframes are
    distinct and the new observations never meet in one slot.
    """
    dev = m.device
    P, N = m.max_pt, m.n_feat
    desc_a = m.kf_feat_desc[kf_a].contiguous()
    desc_b = m.kf_feat_desc[kf_b].contiguous()
    free_a = m.kf_feat_valid[kf_a] & (m.kf_obs_point[kf_a] == NO_POINT)
    free_b = m.kf_feat_valid[kf_b] & (m.kf_obs_point[kf_b] == NO_POINT)
    idx, ok, dist = search.match_by_descriptor(
        desc_a, free_a, desc_b, free_b, MatcherConfig(), mutual=True)
    # rotation-consistency histogram (ORBmatcher.cc:1603-1646)
    dtheta = m.kf_feat_angle[kf_a] - m.kf_feat_angle[kf_b][idx]
    ok = search.rotation_consistency(dtheta, ok)

    Ta = m.kf_pose[kf_a]
    Tb = m.kf_pose[kf_b]
    Twa = se3.se3_inverse(Ta)
    Twb = se3.se3_inverse(Tb)
    uva = m.kf_feat_xy[kf_a]
    uvb = m.kf_feat_xy[kf_b][idx]

    def norm_ray(uv):
        return torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                            (uv[:, 1] - cam.cy) / cam.fy,
                            torch.ones_like(uv[:, 0])], -1)

    # rays in world frame
    ra = se3.quat_rotate(Twa[None, :4], norm_ray(uva))
    rb = se3.quat_rotate(Twb[None, :4], norm_ray(uvb))
    oa = Twa[4:7]
    ob = Twb[4:7]

    # midpoint triangulation (closed form, batched)
    w = torch.sum(ra * rb, -1)
    d2a = torch.sum(ra * ra, -1)
    d2b = torch.sum(rb * rb, -1)
    dd = oa[None] - ob[None]
    denom = d2a * d2b - w * w
    sa = ((w * torch.sum(rb * dd, -1) - d2b * torch.sum(ra * dd, -1))
          / torch.clamp(denom, min=1e-9))
    sb = ((d2a * torch.sum(rb * dd, -1) - w * torch.sum(ra * dd, -1))
          / torch.clamp(denom, min=1e-9))
    pw = 0.5 * ((oa[None] + sa[:, None] * ra) + (ob[None] + sb[:, None] * rb))

    # checks: parallax, cheirality, reprojection
    cosp = w / torch.sqrt(torch.clamp(d2a * d2b, min=1e-12))
    pca = se3.se3_apply(Ta[None], pw)
    pcb = se3.se3_apply(Tb[None], pw)
    err_a = torch.sum((project(cam, pca) - uva) ** 2, -1)
    err_b = torch.sum((project(cam, pcb) - uvb) ** 2, -1)
    good = (ok & (cosp < 0.9998) & (pca[:, 2] > 0.05) & (pcb[:, 2] > 0.05)
            & (err_a < 5.991) & (err_b < 5.991) & (denom > 1e-9))

    # allocate up to max_new, lowest distance first (stable: ties by slot)
    prio = torch.where(good, -dist.to(torch.float32), -torch.inf)
    top_p, slots = topk_stable(prio, max_new)
    sel_ok = torch.isfinite(top_p)
    new_ids = m.next_pt + torch.cumsum(sel_ok.to(torch.int32), 0) - 1
    sel_ok = sel_ok & (new_ids < P)
    new_ids = torch.where(sel_ok, new_ids, P).to(torch.int64)

    pw_sel = pw[slots]
    dvec = pw_sel - Twa[None, 4:7]
    dist_w = torch.linalg.vector_norm(dvec, dim=-1)
    normal = dvec / torch.clamp(dist_w, min=1e-6)[:, None]
    lv = m.kf_feat_level[kf_a][slots].to(torch.float32)
    max_d = dist_w * scale_factor ** lv
    min_d = max_d / scale_factor ** 7

    # wire observations in both keyframes
    new_obs = torch.where(sel_ok, new_ids, NO_POINT)
    obs = m.kf_obs_point.clone()
    obs[kf_a] = _set_rows(obs[kf_a], torch.where(sel_ok, slots, N), new_obs)
    obs[kf_b] = _set_rows(obs[kf_b], torch.where(sel_ok, idx[slots], N),
                          new_obs)
    return dataclasses.replace(
        m,
        pt_pos=_set_rows(m.pt_pos, new_ids, pw_sel),
        pt_valid=_set_rows(m.pt_valid, new_ids, sel_ok),
        pt_desc=_set_rows(m.pt_desc, new_ids, desc_a[slots]),
        pt_normal=_set_rows(m.pt_normal, new_ids, normal),
        pt_min_dist=_set_rows(m.pt_min_dist, new_ids, min_d),
        pt_max_dist=_set_rows(m.pt_max_dist, new_ids, max_d),
        pt_first_kf=_set_rows(m.pt_first_kf, new_ids,
                              torch.zeros_like(new_ids) + kf_a),
        kf_obs_point=obs,
        next_pt=torch.clamp(m.next_pt + torch.sum(sel_ok.to(torch.int32)),
                            max=P).to(torch.int32))


def compact_map(m: MapState):
    """Repack valid keyframes and points to the front of their arrays,
    preserving slot order, and remap all cross-references (the bulk form
    of the reference's Map::EraseKeyFrame / EraseMapPoint).

    Returns (m', kf_new_of_old [K], pt_new_of_old [P]): old slot -> new
    slot (meaningful where the old slot was valid).
    """
    K, P = m.max_kf, m.max_pt
    dev = m.device
    kf_slot = torch.arange(K, dtype=torch.int32, device=dev)
    pt_slot = torch.arange(P, dtype=torch.int32, device=dev)
    # stable partition: valid slots first, in slot order
    kf_order = torch.argsort(torch.where(m.kf_valid, kf_slot, K + kf_slot),
                             stable=True)
    pt_order = torch.argsort(torch.where(m.pt_valid, pt_slot, P + pt_slot),
                             stable=True)
    kf_new_of_old = torch.argsort(kf_order, stable=True).to(torch.int32)
    pt_new_of_old = torch.argsort(pt_order, stable=True).to(torch.int32)

    # observation point ids through the point permutation; entries pointing
    # at invalid points become NO_POINT
    obs = m.kf_obs_point[kf_order]
    obs_safe = torch.where(obs >= 0, obs, 0).to(torch.int64)
    obs_new = torch.where((obs >= 0) & m.pt_valid[obs_safe],
                          pt_new_of_old[obs_safe], NO_POINT)
    first = m.pt_first_kf[pt_order]
    first_safe = torch.where(first >= 0, first, 0).to(torch.int64)
    first_new = torch.where((first >= 0) & m.kf_valid[first_safe],
                            kf_new_of_old[first_safe], -1)

    fields = {}
    for f in dataclasses.fields(m):
        x = getattr(m, f.name)
        if f.name.startswith("kf_"):
            fields[f.name] = x[kf_order]
        elif f.name.startswith("pt_"):
            fields[f.name] = x[pt_order]
    fields.update(
        kf_obs_point=obs_new, pt_first_kf=first_new,
        next_kf=torch.sum(m.kf_valid.to(torch.int32)).to(torch.int32),
        next_pt=torch.sum(m.pt_valid.to(torch.int32)).to(torch.int32))
    return MapState(**fields), kf_new_of_old, pt_new_of_old
