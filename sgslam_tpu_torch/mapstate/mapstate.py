"""The map as a fixed-capacity array-of-structs of tensors.

Port of `sgslam_tpu/mapstate/mapstate.py`: `MapState`, `empty_map`, the
covisibility functions and `insert_keyframe`. Culling clears validity bits;
allocation is sequential. The covisibility graph is never stored: it is one
[K, P] x [P, K] incidence product away.

JAX's `mode="drop"` scatters become writes into a buffer with one spare row
that collects the dropped writes, then a slice. `insert_keyframe` returns a
new `MapState` and leaves its argument as it was: the fields it changes are
copied first (about 50 MB at the default capacity).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MapCapacity
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..matching.hamming import hamming_pairs
from ..ops.orb import Features, topk_stable

NO_POINT = -1


@dataclasses.dataclass
class MapState:
    # --- keyframes ---
    kf_pose: torch.Tensor        # [K,7] Tcw (world->camera)
    kf_valid: torch.Tensor       # [K] bool
    kf_frame_id: torch.Tensor    # [K] i32 source frame index
    # per-KF frozen feature block (the KF's Frame snapshot)
    kf_feat_xy: torch.Tensor     # [K,N,2] f32 undistorted coords
    kf_feat_uvr: torch.Tensor    # [K,N] f32 pseudo-stereo right u (<0 mono)
    kf_feat_depth: torch.Tensor  # [K,N] f32
    kf_feat_level: torch.Tensor  # [K,N] i32
    kf_feat_angle: torch.Tensor  # [K,N] f32
    kf_feat_desc: torch.Tensor   # [K,N,8] i32 (uint32 bits)
    kf_feat_valid: torch.Tensor  # [K,N] bool
    kf_obs_point: torch.Tensor   # [K,N] i32 feature slot -> point id
    # --- points ---
    pt_pos: torch.Tensor         # [P,3] f32 world position
    pt_valid: torch.Tensor       # [P] bool
    pt_desc: torch.Tensor        # [P,8] i32 representative descriptor
    pt_normal: torch.Tensor      # [P,3] f32 mean viewing direction
    pt_min_dist: torch.Tensor    # [P] f32 scale-invariance band
    pt_max_dist: torch.Tensor    # [P] f32
    pt_visible: torch.Tensor     # [P] i32 times predicted visible
    pt_found: torch.Tensor       # [P] i32 times actually matched
    pt_first_kf: torch.Tensor    # [P] i32 creating keyframe
    # --- counters ---
    next_kf: torch.Tensor        # scalar i32
    next_pt: torch.Tensor        # scalar i32

    @property
    def max_kf(self):
        return self.kf_pose.shape[0]

    @property
    def max_pt(self):
        return self.pt_pos.shape[0]

    @property
    def n_feat(self):
        return self.kf_feat_xy.shape[1]

    @property
    def device(self):
        return self.kf_pose.device

    def to(self, device) -> "MapState":
        return MapState(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})


def empty_map(cap: MapCapacity, n_feat: int, device="cpu") -> MapState:
    K, P, N = cap.max_keyframes, cap.max_points, n_feat
    f32, i32 = torch.float32, torch.int32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return MapState(
        kf_pose=se3.se3_identity(device=device)[None].repeat(K, 1),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, i32),
        kf_feat_xy=full((K, N, 2), 0.0, f32),
        kf_feat_uvr=full((K, N), -1.0, f32),
        kf_feat_depth=full((K, N), -1.0, f32),
        kf_feat_level=full((K, N), 0, i32),
        kf_feat_angle=full((K, N), 0.0, f32),
        kf_feat_desc=full((K, N, 8), 0, i32),
        kf_feat_valid=full((K, N), False, torch.bool),
        kf_obs_point=full((K, N), NO_POINT, i32),
        pt_pos=full((P, 3), 0.0, f32),
        pt_valid=full((P,), False, torch.bool),
        pt_desc=full((P, 8), 0, i32),
        pt_normal=full((P, 3), 0.0, f32),
        pt_min_dist=full((P,), 0.0, f32),
        pt_max_dist=full((P,), 1e9, f32),
        pt_visible=full((P,), 0, i32),
        pt_found=full((P,), 0, i32),
        pt_first_kf=full((P,), -1, i32),
        next_kf=full((), 0, i32),
        next_pt=full((), 0, i32),
    )


def _set_rows(x, idx, values):
    """Copy of x with x[idx] = values, where idx == len(x) drops the write
    (JAX's mode="drop" for the one out-of-range index used here)."""
    buf = torch.cat([x, x[:1]])
    buf[idx] = values.to(x.dtype)
    return buf[:-1]


# ---------------------------------------------------------------------------
# Covisibility (replaces KeyFrame::UpdateConnections / GetBestCovisibility*)
# ---------------------------------------------------------------------------

def incidence_matrix(m: MapState, dtype=torch.float32):
    """[K, P] 1.0 where keyframe k observes point p. Every write is a 1.0
    (the reference adds ones and clamps at 1), so repeated entries give the
    same result in any order."""
    K, P = m.max_kf, m.max_pt
    obs = m.kf_obs_point.to(torch.int64)
    ok = (obs >= 0) & m.kf_valid[:, None]
    k_idx = torch.arange(K, device=m.device)[:, None].expand(obs.shape)
    flat_k = torch.where(ok, k_idx, 0).reshape(-1)
    flat_p = torch.where(ok, obs, P).reshape(-1)  # invalid -> spare column
    inc = torch.zeros((K, P + 1), dtype=dtype, device=m.device)
    inc.index_put_((flat_k, flat_p), torch.ones((), dtype=dtype,
                                                device=m.device))
    return inc[:, :P]


def covisibility_rows(m: MapState, kf_ids, min_weight: int = 15):
    """[Q, K] shared-point counts between query keyframes and all others,
    zero-diagonal, thresholded: the per-row form of `covisibility`."""
    P = m.max_pt
    kf_ids = torch.as_tensor(kf_ids, device=m.device).to(torch.int64)
    Q = kf_ids.shape[0]
    obs_q = m.kf_obs_point[kf_ids].to(torch.int64)          # [Q,N]
    member = torch.zeros((Q, P + 1), dtype=torch.float32, device=m.device)
    # every write of a row is 1.0 except those into the spare slot P
    member.scatter_(1, torch.where(obs_q >= 0, obs_q, P),
                    (obs_q >= 0).to(torch.float32))
    obs = torch.where(m.kf_obs_point >= 0, m.kf_obs_point, P).to(torch.int64)
    row = torch.sum(member[:, obs], dim=2)                  # [Q,K]
    row = row * m.kf_valid * m.kf_valid[kf_ids][:, None]
    row[torch.arange(Q, device=m.device), kf_ids] = 0.0
    return torch.where(row >= min_weight, row, 0.0)


def covisibility(m: MapState, min_weight: int = 15):
    """[K, K] shared-point counts, zero-diagonal, thresholded: the contract
    of KeyFrame::UpdateConnections (weight >= 15 edges, KeyFrame.cc:290)
    as one incidence product. The counts are integers below 2**24, exact in
    f32 whatever the summation order."""
    inc = incidence_matrix(m)
    w = inc @ inc.T
    w = w * (1.0 - torch.eye(m.max_kf, dtype=w.dtype, device=w.device))
    return torch.where(w >= min_weight, w, 0.0)


def insert_keyframe(cam, scale_factor: float, m: MapState, feats: Features,
                    Tcw, frame_id, matched_point_ids,
                    close_depth, max_new_points: int = 256) -> MapState:
    """Append a keyframe; wire matched observations; create new map points
    from unmatched close-depth features, nearest first.

    Contract of Tracking::CreateNewKeyFrame (Tracking.cc:1179-1248) +
    LocalMapping::ProcessNewKeyFrame (observation wiring) + the new points'
    MapPoint::UpdateNormalAndDepth stats (MapPoint.cc:330).

    matched_point_ids: [N] i32 point id per feature slot (NO_POINT if none).
    """
    dev = m.device
    P = m.max_pt
    k = int(m.next_kf)   # sequential KF slots (culling clears validity only)

    # ---- new map points from unmatched features with depth
    unmatched = (matched_point_ids == NO_POINT) & feats.valid
    cand = unmatched & (feats.depth > 0)
    # keep all close points, and far ones until the first 100 slots are
    # filled (CreateNewKeyFrame, Tracking.cc:1224-44)
    prio = torch.where(cand, -feats.depth, -torch.inf)
    top_prio, top_slot = topk_stable(prio, max_new_points)
    is_close = -top_prio < close_depth
    rank = torch.arange(max_new_points, device=dev)
    new_ok = torch.isfinite(top_prio) & (is_close | (rank < 100))
    new_ids = m.next_pt + torch.cumsum(new_ok.to(torch.int32), 0) - 1
    new_ok = new_ok & (new_ids < P)
    new_ids = torch.where(new_ok, new_ids, P).to(torch.int64)  # spare row

    # world positions from depth backprojection
    Twc = se3.se3_inverse(Tcw)
    p_cam = cam_mod.backproject(cam, feats.xy[top_slot],
                                feats.depth[top_slot])
    p_w = se3.se3_apply(Twc[None], p_cam)

    # scale-invariance band + normal (MapPoint::UpdateNormalAndDepth)
    dvec = p_w - Twc[None, 4:7]
    dist = torch.linalg.vector_norm(dvec, dim=-1)
    normal = dvec / torch.clamp(dist, min=1e-6)[:, None]
    lv = feats.level[top_slot].to(torch.float32)
    max_d = dist * scale_factor ** lv
    min_d = max_d / scale_factor ** 7  # 8 levels

    pt_pos = _set_rows(m.pt_pos, new_ids, p_w)
    pt_valid = _set_rows(m.pt_valid, new_ids, new_ok)
    pt_desc = _set_rows(m.pt_desc, new_ids, feats.desc[top_slot])
    pt_normal = _set_rows(m.pt_normal, new_ids, normal)
    pt_min = _set_rows(m.pt_min_dist, new_ids, min_d)
    pt_max = _set_rows(m.pt_max_dist, new_ids, max_d)
    pt_first = _set_rows(m.pt_first_kf, new_ids,
                         torch.full_like(new_ids, k))

    # ---- observation table: matched points + the new ones
    new_pt_for_slot = torch.full((m.n_feat,), NO_POINT, dtype=torch.int32,
                                 device=dev)
    new_pt_for_slot[top_slot] = torch.where(new_ok, new_ids,
                                            NO_POINT).to(torch.int32)
    obs_row = torch.where(matched_point_ids == NO_POINT, new_pt_for_slot,
                          matched_point_ids)

    # representative-descriptor refresh (MapPoint::
    # ComputeDistinctiveDescriptors, MapPoint.cc:242): adopt the newly
    # observed descriptor when it has drifted far from the stored one
    was_matched = matched_point_ids >= 0
    mp_safe = torch.where(was_matched, matched_point_ids, 0).to(torch.int64)
    drift = hamming_pairs(feats.desc, m.pt_desc[mp_safe])
    adopt = was_matched & (drift > 40)
    pt_desc = _set_rows(pt_desc, torch.where(adopt, mp_safe, P), feats.desc)

    # found/visible counters (MapPoint::IncreaseVisible/IncreaseFound,
    # MapPoint.cc:120-140)
    mp = torch.where(was_matched, mp_safe, P)
    ones = torch.ones_like(mp, dtype=torch.int32)
    pt_found = torch.cat([m.pt_found, m.pt_found[:1]]).index_add_(
        0, mp, ones)[:-1]
    pc_all = se3.se3_apply(Tcw[None], m.pt_pos)
    uv_all = cam_mod.project(cam, pc_all)
    in_frustum = (m.pt_valid & (pc_all[:, 2] > 0.1)
                  & (uv_all[:, 0] >= 0) & (uv_all[:, 0] < cam.width)
                  & (uv_all[:, 1] >= 0) & (uv_all[:, 1] < cam.height))
    pt_visible = m.pt_visible + in_frustum.to(torch.int32)
    # matched points count as visible even if the refined pose moved them
    # out of frame
    matched_visible = torch.cat([m.pt_visible, m.pt_visible[:1]]).index_add_(
        0, mp, ones)[:-1]
    pt_visible = torch.maximum(pt_visible, matched_visible)

    kf = {}
    if k < m.max_kf:   # a full keyframe table drops the write, as in JAX
        for name, value in (
                ("kf_pose", Tcw), ("kf_valid", True),
                ("kf_frame_id", frame_id), ("kf_feat_xy", feats.xy),
                ("kf_feat_uvr", feats.u_right),
                ("kf_feat_depth", feats.depth),
                ("kf_feat_level", feats.level),
                ("kf_feat_angle", feats.angle),
                ("kf_feat_desc", feats.desc),
                ("kf_feat_valid", feats.valid),
                ("kf_obs_point", torch.where(feats.valid, obs_row,
                                             NO_POINT))):
            t = getattr(m, name).clone()
            t[k] = value
            kf[name] = t

    return dataclasses.replace(
        m, **kf,
        pt_pos=pt_pos, pt_valid=pt_valid, pt_desc=pt_desc,
        pt_normal=pt_normal, pt_min_dist=pt_min, pt_max_dist=pt_max,
        pt_first_kf=pt_first, pt_found=pt_found, pt_visible=pt_visible,
        next_kf=m.next_kf + 1,
        next_pt=torch.clamp(m.next_pt + torch.sum(new_ok.to(torch.int32)),
                            max=P).to(torch.int32),
    )
