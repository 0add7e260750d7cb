"""The per-frame tracking pipeline (RGB-D, stereo, monocular features), the
keyframe back-end, and their host state machine.

Port of `sgslam_tpu/slam/tracking.py` (`extract_frame`,
`extract_frame_stereo`, `extract_frame_mono`, `track_step`,
`local_ba_step`, `local_ba_cov_step`, `process_new_keyframe`, `Tracker`).
`track_step` is the reference's TrackWithMotionModel + TrackLocalMap
contract: local-point selection, then two rounds of projective search,
duplicate resolution and motion-only BA. Each round's search is one
launch of the fused Hamming search K1s (`ops/hamming_search.py`) on the
GPU, and each round's motion-only BA one launch of the pose kernel
(`ops/pose_opt_cuda.py`); the back-end pass adds two searches
(triangulation and duplicate fusion).

Spans on the active tracer (`utils/timing.active()`): `tracking.step` per
frame of `Tracker.process`, with `tracking.local_points`,
`tracking.search` and `tracking.pose_opt` inside `track_step`;
`backend.insert` per keyframe insertion, with `backend.cull`,
`backend.triangulate`, `backend.fuse`, `backend.ba` and `backend.kf_cull`
inside `process_new_keyframe`; `front_end.stereo` around the SAD search of
`extract_frame_stereo`, which counts `stereo.calls` and
`stereo.candidates`.

The reference's `lax.cond`s are Python `if`s here: the brute-force
fallback on the stage-1 inlier count (one host read per frame), and the
back-end pass's two guards (two host reads per keyframe).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..config import SlamConfig
from ..geometry import se3
from ..geometry.camera import project
from ..mapstate import local_map as lm
from ..mapstate import maintenance as mt
from ..mapstate import mapstate as ms
from ..matching import search
from ..ops import orb
from ..ops import stereo as stereo_ops
from ..optim import local_ba, pose_opt
from ..utils import timing

NO_POINT = ms.NO_POINT

# candidate disparities the SAD search tries per keypoint slot, from
# `stereo_match`'s defaults (the ones `attach_stereo` searches with)
_SAD = stereo_ops.stereo_match.__kwdefaults__
STEREO_DISPARITIES = len(range(0, _SAD["max_disparity"], _SAD["step"]))


def _as_tensor(x, device):
    """numpy arrays are copied (they may be read-only views of another
    framework's buffers); tensors are moved only if they lie elsewhere."""
    return (x.to(device) if torch.is_tensor(x)
            else torch.tensor(np.asarray(x), device=device))


def extract_frame(cfg: SlamConfig, gray, depth, device="cuda") -> orb.Features:
    """ORB extraction + RGB-D depth lookup for one frame. gray, depth:
    [H, W] float32 (numpy or tensors), moved to `device`."""
    dev = resolve_device(device)
    feats = orb.extract(_as_tensor(gray, dev), cfg.orb, cfg.camera)
    return orb.attach_rgbd(feats, _as_tensor(depth, dev).to(torch.float32),
                           cfg.camera)


def extract_frame_stereo(cfg: SlamConfig, gray_l, gray_r,
                         device="cuda") -> orb.Features:
    """Stereo frame construction: extract on the left image, fill
    u_right/depth by rectified epipolar SAD search in the right image
    (the stereo Frame constructor, Frame.cc:87-127 + ComputeStereoMatches
    Frame.cc:716-890).

    The search is a `front_end.stereo` span on the active tracer; it counts
    `stereo.calls` and `stereo.candidates` (keypoint slots x candidate
    disparities, from the shapes: nothing is read from the device). Where
    the tracer carries a stage hook (`Metrics.on_stage`, set by the stereo
    chunk around its extraction loop), it is called with "extract" after
    the ORB half and "stereo" after the search."""
    dev = resolve_device(device)
    tr = timing.active()
    mark = tr.on_stage
    gray_l = _as_tensor(gray_l, dev).to(torch.float32)
    feats = orb.extract(gray_l, cfg.orb, cfg.camera)
    if mark is not None:
        mark("extract")
    tr.count("stereo.calls")
    tr.count("stereo.candidates", feats.valid.shape[0] * STEREO_DISPARITIES)
    with tr.span("front_end.stereo"):
        feats = stereo_ops.attach_stereo(
            cfg.camera, feats, gray_l,
            _as_tensor(gray_r, dev).to(torch.float32))
    if mark is not None:
        mark("stereo")
    return feats


def extract_frame_mono(cfg: SlamConfig, gray, device="cuda") -> orb.Features:
    """Monocular frame construction: no depth, u_right < 0 everywhere
    (pose optimization then uses the 2-dof mono residual)."""
    dev = resolve_device(device)
    return orb.extract(_as_tensor(gray, dev).to(torch.float32), cfg.orb,
                       cfg.camera)


def _pose_inputs(cfg: SlamConfig, feats: orb.Features, idx):
    obs = torch.stack([feats.xy[idx, 0], feats.xy[idx, 1],
                       feats.u_right[idx]], -1)
    lv = feats.level[idx].to(torch.float32)
    inv_s2 = (1.0 / cfg.orb.scale_factor ** 2) ** lv
    return obs, inv_s2


def track_step(cfg: SlamConfig, m: ms.MapState, feats: orb.Features,
               Tcw_pred, device="cuda", fallback: str = "host"):
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
    dev = resolve_device(device)
    tr = timing.active()
    m, feats, Tcw_pred = m.to(dev), feats.to(dev), Tcw_pred.to(dev)
    t = cfg.tracker
    with tr.span("tracking.local_points"):
        local = lm.select_local_points(cfg.camera, m, Tcw_pred,
                                       scale_factor=cfg.orb.scale_factor,
                                       capacity=cfg.capacity.local_points)

    def associate_and_optimize(Tcw_in, radius_mult, max_dist, rounds, iters):
        with tr.span("tracking.search"):
            pc = se3.se3_apply(Tcw_in[None], local.pos)
            idx, ok, dist = search.search_by_projection(
                project(cfg.camera, pc), local.radius * radius_mult,
                local.pred_level, local.desc,
                local.valid & (pc[..., 2] > 0.1), feats.xy, feats.level,
                feats.desc, feats.valid, level_window=1, max_dist=max_dist,
                scale_factor=cfg.orb.scale_factor)
            ok = search.resolve_duplicate_targets(idx, ok, dist,
                                                  feats.capacity)
        with tr.span("tracking.pose_opt"):
            obs, inv_s2 = _pose_inputs(cfg, feats, idx)
            Tcw, inl, n = pose_opt.pose_optimization(
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
        with tr.span("tracking.search"):
            idx, ok, dist = search.match_by_descriptor(
                local.desc, local.valid, feats.desc, feats.valid,
                cfg.matcher, max_dist=cfg.matcher.th_low, mutual=True)
            ok = search.resolve_duplicate_targets(idx, ok, dist,
                                                  feats.capacity)
        with tr.span("tracking.pose_opt"):
            obs, inv_s2 = _pose_inputs(cfg, feats, idx)
            return pose_opt.pose_optimization(
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


def _window_ba(cfg: SlamConfig, m: ms.MapState, ids, opt_mask):
    cap = cfg.capacity
    prob, pids = lm.build_ba_problem(cfg.camera, m, ids, opt_mask,
                                     max_points=cap.local_points,
                                     scale_factor=cfg.orb.scale_factor)
    poses, points, _ = local_ba.bundle_adjust(
        cfg.camera, prob, iters1=cfg.tracker.local_ba_iters1,
        iters2=cfg.tracker.local_ba_iters2)
    return lm.writeback_ba(m, ids, opt_mask, poses, pids, points)


def local_ba_step(cfg: SlamConfig, m: ms.MapState, center_kf):
    """Temporal window -> BA -> writeback (LocalMapping's per-KF
    Optimizer::LocalBundleAdjustment call). Sequential keyframes are the
    covisible set of a moving RGB-D camera; `local_ba_cov_step` is the
    covisibility-ranked variant."""
    w = cfg.capacity.local_window
    ids, opt_mask = lm.ba_window_temporal(m, center_kf, window=w,
                                          n_fixed=w // 2)
    return _window_ba(cfg, m, ids, opt_mask)


def local_ba_cov_step(cfg: SlamConfig, m: ms.MapState, center_kf, cov):
    """Covisibility-ranked local BA around `center_kf`, the loop-closure
    path's window (Optimizer.cc:456-504); `cov` is the [K, K] covisibility
    matrix. It runs with the hot path's convergence tolerance."""
    w = cfg.capacity.local_window
    ids, opt_mask = lm.ba_window(m, center_kf, cov, window=w, n_fixed=w // 2)
    return _window_ba(cfg, m, ids, opt_mask)


BACKEND_STAGES = ("cull", "triangulate", "fuse", "ba", "kf_cull")


def process_new_keyframe(cfg: SlamConfig, m: ms.MapState, kf_id,
                         on_stage=None):
    """The per-keyframe back-end pass on the map's device, in the order of
    LocalMapping::Run (LocalMapping.cc:61-87): MapPointCulling ->
    CreateNewMapPoints (triangulation with the previous valid keyframe) ->
    SearchInNeighbors (duplicate fusion) -> LocalBundleAdjustment (with at
    least 3 valid keyframes) -> KeyFrameCulling.

    `on_stage(name)`, if given, is called with "begin" and then after each
    stage of BACKEND_STAGES (for timing; it must not touch the map).
    """
    mark = on_stage or (lambda name: None)
    tr = timing.active()
    mark("begin")
    with tr.span("backend.cull"):
        m = mt.cull_map_points(m)
    mark("cull")
    with tr.span("backend.triangulate"):
        prev = int(mt.prev_valid_kf(m, kf_id))
        if prev >= 0:
            m = mt.triangulate_new_points(cfg.camera, m, kf_id, prev,
                                          scale_factor=cfg.orb.scale_factor)
    mark("triangulate")
    with tr.span("backend.fuse"):
        m = mt.fuse_duplicates(cfg.camera, m, kf_id,
                               scale_factor=cfg.orb.scale_factor,
                               max_candidates=cfg.capacity.local_points)
    mark("fuse")
    with tr.span("backend.ba"):
        if int(torch.sum(m.kf_valid)) >= 3:
            m = local_ba_step(cfg, m, kf_id)
    mark("ba")
    with tr.span("backend.kf_cull"):
        m = mt.cull_keyframes(m)
    mark("kf_cull")
    return m


class Tracker:
    """Host-side state machine (System+Tracking facade without semantics).

    States mirror Tracking.h:93-99: NOT_INITIALIZED -> OK; LOST on inlier
    collapse (the tracker then coasts on the motion model).
    """

    def __init__(self, cfg: SlamConfig, local_ba_every: int = 1,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.map = ms.empty_map(cfg.capacity, cfg.orb.max_keypoints,
                                self.device)
        self.state = "NOT_INITIALIZED"
        # localization-only mode: track against the frozen map, never
        # insert keyframes (System::ActivateLocalizationMode contract)
        self.only_tracking = False
        ident = se3.se3_identity(device=self.device)
        self.Tcw = ident
        self.velocity = ident
        self.last_Tcw = ident
        self.frame_id = 0
        self.last_kf_frame_id = -999
        self.ref_matches = 200     # match count at the reference keyframe
        self.n_kf = 0
        self.local_ba_every = local_ba_every
        self.on_compaction = None    # callback(kf_old_to_new, old_valid)
        self.on_backend_stage = None  # process_new_keyframe's on_stage
        self.compactions = 0
        self.last_kf_id = -1
        self.last_reloc_frame_id = -999
        self.kf_inserted = False
        self.trajectory: list[np.ndarray] = []
        # trajectory as relative poses against the reference keyframe
        # (System::SaveTrajectoryTUM contract, System.cc:424-453)
        self.traj_ref_kf: list[int] = []
        self.traj_rel: list[np.ndarray] = []
        self.n_inliers_hist: list[int] = []

    # -- keyframe policy (contract of Tracking::NeedNewKeyFrame) --
    def _need_new_kf(self, n_inliers, tracked_close, untracked_close):
        t = self.cfg.tracker
        since = self.frame_id - self.last_kf_frame_id
        if since < 1:
            return False
        need_close = (tracked_close < 100) and (untracked_close > 70)
        c1 = since >= t.max_frames_between_kf
        # relative to the reference keyframe's match count
        # (Tracking.cc:1085-1113: mnMatchesInliers < nRefMatches*ratio)
        c2 = (n_inliers < self.ref_matches * t.kf_tracked_ratio
              or need_close)
        return bool(c1 or (c2 and n_inliers > 15))

    def _insert_kf(self, feats, matched):
        with timing.active().span("backend.insert", rid=self.frame_id):
            kf_slot = int(self.map.next_kf)
            self.map = ms.insert_keyframe(
                self.cfg.camera, self.cfg.orb.scale_factor, self.map, feats,
                self.Tcw, self.frame_id, matched,
                self.cfg.close_depth_threshold)
            self.last_kf_frame_id = self.frame_id
            self.n_kf += 1
            self.kf_inserted = True
            self.last_kf_id = kf_slot
            # full back-end pass per keyframe (LocalMapping::Run contract):
            # point culling, triangulation, fusion, local BA, KF culling
            if self.n_kf >= 2 and (self.n_kf % self.local_ba_every == 0):
                self.map = process_new_keyframe(
                    self.cfg, self.map, kf_slot,
                    on_stage=self.on_backend_stage)
            self._maybe_compact()

    def _maybe_compact(self):
        """Repack the map when monotonic slot allocation nears capacity.

        Frames recorded relative to a culled keyframe are re-anchored to
        absolute poses first (their reference slot is about to be reused),
        then reference-KF slot ids are remapped.
        """
        m = self.map
        if (int(m.next_kf) < m.max_kf - 4
                and int(m.next_pt) < m.max_pt - 2048):
            return
        kf_valid = m.kf_valid.cpu().numpy()
        kf_pose = m.kf_pose.cpu()
        m2, kf_map, _ = mt.compact_map(m)
        kf_map = kf_map.cpu().numpy()
        for i, ref in enumerate(self.traj_ref_kf):
            if ref < 0:
                continue
            if kf_valid[ref]:
                self.traj_ref_kf[i] = int(kf_map[ref])
            else:  # anchor KF was culled: bake the absolute pose
                T_abs = se3.se3_compose(torch.as_tensor(self.traj_rel[i]),
                                        kf_pose[ref]).numpy()
                self.traj_ref_kf[i] = -1
                self.traj_rel[i] = T_abs
                self.trajectory[i] = T_abs
        if self.last_kf_id >= 0 and kf_valid[self.last_kf_id]:
            self.last_kf_id = int(kf_map[self.last_kf_id])
        self.map = m2
        self.compactions += 1
        if self.on_compaction is not None:
            self.on_compaction(kf_map, kf_valid)

    def process_stereo(self, gray_l, gray_r) -> np.ndarray:
        """Track one rectified stereo pair (System::TrackStereo role):
        identical state machine — stereo depth stands in for RGB-D depth."""
        feats = extract_frame_stereo(self.cfg, gray_l, gray_r, self.device)
        return self.process(gray_l, None, feats=feats)

    def process(self, gray, depth, feats=None) -> np.ndarray:
        """Track one RGB-D frame; returns Tcw [7] (numpy)."""
        self.kf_inserted = False
        if feats is None:
            feats = extract_frame(self.cfg, gray, depth, self.device)

        if self.state == "NOT_INITIALIZED":
            # StereoInitialization contract (Tracking.cc:548-600):
            # need enough keypoints with depth
            n_ok = int(torch.sum(feats.valid & (feats.depth > 0)))
            if n_ok >= 200:
                self.Tcw = se3.se3_identity(device=self.device)
                matched = torch.full((feats.capacity,), NO_POINT,
                                     dtype=torch.int32, device=self.device)
                self._insert_kf(feats, matched)
                self.state = "OK"
            self._record()
            self.frame_id += 1
            return self.Tcw.cpu().numpy()

        with timing.active().span("tracking.step", rid=self.frame_id,
                                  frames=1):
            Tcw_pred = se3.se3_compose(self.velocity, self.last_Tcw)
            (Tcw, matched, n_inl, tracked_close, untracked_close,
             _) = track_step(self.cfg, self.map, feats, Tcw_pred,
                             self.device)
            n_inl = int(n_inl)
            self.n_inliers_hist.append(n_inl)

            # TrackLocalMap inlier gates (Tracking.cc:1006-1012): 50
            # inliers required shortly after a relocalization, 30 otherwise
            t = self.cfg.tracker
            recently_relocated = (self.frame_id - self.last_reloc_frame_id
                                  < t.max_frames_between_kf)
            min_inl = (t.min_inliers_after_reloc if recently_relocated
                       else t.min_inliers_local_map)
            insert = False
            if n_inl < min_inl:
                self.state = "LOST"
                self.Tcw = Tcw_pred
            else:
                self.state = "OK"
                self.Tcw = Tcw
                insert = not self.only_tracking and self._need_new_kf(
                    n_inl, int(tracked_close), int(untracked_close))
        if insert:
            self.ref_matches = max(n_inl, 30)
            self._insert_kf(feats, matched)

        self.velocity = se3.se3_compose(self.Tcw,
                                        se3.se3_inverse(self.last_Tcw))
        self._record()
        self.last_Tcw = self.Tcw
        self.frame_id += 1
        return self.Tcw.cpu().numpy()

    def force_pose(self, Tcw):
        """Install an externally recovered pose (relocalization)."""
        self.Tcw = _as_tensor(Tcw, self.device).to(torch.float32)
        self.last_Tcw = self.Tcw
        self.velocity = se3.se3_identity(device=self.device)
        self.state = "OK"
        self.last_reloc_frame_id = self.frame_id
        if self.trajectory:
            self.trajectory.pop()
            self.traj_ref_kf.pop()
            self.traj_rel.pop()
            self._record()

    def _record(self):
        self.trajectory.append(self.Tcw.cpu().numpy())
        ref = self.last_kf_id if self.n_kf > 0 else -1
        self.traj_ref_kf.append(ref)
        if ref < 0:
            self.traj_rel.append(self.Tcw.cpu().numpy())
        else:
            T_rel = se3.se3_compose(self.Tcw,
                                    se3.se3_inverse(self.map.kf_pose[ref]))
            self.traj_rel.append(T_rel.cpu().numpy())

    # -- exports (System::SaveTrajectoryTUM contract) --
    def poses_cw(self) -> np.ndarray:
        """Full trajectory, reconstructed as T_rel * Tcw(ref KF) with the
        current keyframe poses."""
        if not self.trajectory:
            return np.zeros((0, 7), np.float32)
        refs = np.asarray(self.traj_ref_kf)
        rel = torch.as_tensor(np.stack(self.traj_rel))
        kf_pose = self.map.kf_pose.cpu()
        ref_T = kf_pose[np.maximum(refs, 0)]
        out = se3.se3_compose(rel, ref_T).numpy()
        raw = np.stack(self.trajectory)
        return np.where((refs >= 0)[:, None], out, raw)
