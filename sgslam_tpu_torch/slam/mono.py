"""Monocular tracking mode: two-view initialization + scale-free tracking.

Port of `sgslam_tpu/slam/mono.py` (the contract of the reference's
Tracking::MonocularInitialization + CreateInitialMapMonocular): a
reference frame is kept until a frame with >= 100 window matches arrives;
batched H/F RANSAC model selection recovers R|t and triangulates the first
points (`optim/initializer.initialize_mono`); the initial map is rescaled
so that the median scene depth is 1; both views become keyframes, and
tracking proceeds through the same `track_step` / back-end as RGB-D, the
map growing by triangulation alone.

`jnp.nanmedian` averages the two middle values of an even count, where
`torch.nanmedian` returns the lower one: `nanmedian` below is the
reference's. It sets the scale of the whole map and the parallax gate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import se3
from ..mapstate import mapstate as ms
from ..matching import search
from ..optim.initializer import initialize_mono
from . import tracking

NO_POINT = ms.NO_POINT
INIT_SEED = 17      # the reference's PRNGKey(17)


def nanmedian(x):
    """Median of the non-NaN entries of a 1-D tensor, the mean of the two
    middle ones for an even count, NaN for none (`jnp.nanmedian`, whose
    'midpoint' quantile this is, step for step); no host read."""
    v = torch.sort(x).values            # NaNs sort last
    n = torch.sum(~torch.isnan(x)).to(torch.float32)
    q = 0.5 * (n - 1.0)
    lo = torch.clamp(torch.minimum(torch.floor(q), n - 1.0), min=0.0)
    hi = torch.clamp(torch.minimum(torch.ceil(q), n - 1.0), min=0.0)
    pick = torch.stack([lo, hi]).to(torch.int64)
    lo_v, hi_v = v.index_select(0, pick)
    return (lo_v + hi_v) * 0.5


def _match_for_init(cfg: SlamConfig, ref, cur, window: float = 100.0):
    """Window-constrained mutual descriptor matching between the init
    reference frame and the current frame (ORBmatcher::
    SearchForInitialization, ORBmatcher.cc:407). Returns (idx, ok): for
    current feature i, ref feature idx[i]."""
    idx, ok, _ = search.match_by_descriptor(
        cur.desc, cur.valid, ref.desc, ref.valid, cfg.matcher,
        max_dist=cfg.matcher.th_low, mutual=True)
    d = cur.xy - ref.xy[idx]
    ok = ok & (torch.abs(d[:, 0]) < window) & (torch.abs(d[:, 1]) < window)
    if cfg.matcher.check_orientation:
        ok = search.rotation_consistency(cur.angle - ref.angle[idx], ok,
                                         cfg.matcher.histo_length)
    return idx, ok


def bootstrap_mono_map(cfg: SlamConfig, feats_ref, feats_cur, ref_frame_id,
                       cur_frame_id, T21, points, good, match_idx):
    """Build the initial monocular map (CreateInitialMapMonocular,
    Tracking.cc:724-795) on the features' device: rescale to inverse median
    depth, allocate the triangulated points, insert both views as keyframes
    with wired observations. Returns (map, Tcw_cur_scaled)."""
    dev = points.device
    med = nanmedian(torch.where(good, points[:, 2], torch.nan))
    s = 1.0 / torch.clamp(med, min=1e-6)
    pts = points * s
    T21s = torch.cat([T21[:4], T21[4:7] * s])

    m = ms.empty_map(cfg.capacity, cfg.orb.max_keypoints, dev)
    N = feats_cur.capacity
    good_i = good.to(torch.int32)
    pid = torch.where(good, torch.cumsum(good_i, 0) - 1, -1)
    slot = torch.where(good, pid, m.max_pt).to(torch.int64)

    # scale-invariance band + viewing normal from the reference view
    # (MapPoint::UpdateNormalAndDepth); KF0 sits at the origin
    dist = torch.linalg.vector_norm(pts, dim=-1)
    normal = pts / torch.clamp(dist, min=1e-6)[:, None]
    lv = feats_ref.level[match_idx].to(torch.float32)
    max_d = dist * cfg.orb.scale_factor ** lv
    min_d = max_d / cfg.orb.scale_factor ** (cfg.orb.n_levels - 1)

    # the spare row of `_set_rows` takes the non-good writes (mode="drop")
    set_rows = ms._set_rows
    m = dataclasses.replace(
        m,
        pt_pos=set_rows(m.pt_pos, slot, pts),
        pt_valid=set_rows(m.pt_valid, slot, good),
        pt_desc=set_rows(m.pt_desc, slot, feats_cur.desc),
        pt_normal=set_rows(m.pt_normal, slot, normal),
        pt_min_dist=set_rows(m.pt_min_dist, slot, min_d),
        pt_max_dist=set_rows(m.pt_max_dist, slot, max_d),
        pt_first_kf=set_rows(m.pt_first_kf, slot, torch.zeros_like(pid)),
        next_pt=torch.sum(good_i).to(torch.int32))

    # observation wiring: current feature i <-> point pid[i] <-> ref
    # feature match_idx[i] (distinct for mutual matches)
    no_pt = torch.full((N,), NO_POINT, dtype=torch.int32, device=dev)
    matched_cur = torch.where(good, pid, NO_POINT).to(torch.int32)
    matched_ref = set_rows(no_pt, torch.where(good, match_idx, N),
                           matched_cur)

    m = ms.insert_keyframe(cfg.camera, cfg.orb.scale_factor, m, feats_ref,
                           se3.se3_identity(device=dev), ref_frame_id,
                           matched_ref, cfg.close_depth_threshold)
    m = ms.insert_keyframe(cfg.camera, cfg.orb.scale_factor, m, feats_cur,
                           T21s, cur_frame_id, matched_cur,
                           cfg.close_depth_threshold)
    return m, T21s


class MonoTracker(tracking.Tracker):
    """Monocular front end over the shared Tracker state machine.

    `draws(n_valid)`, if given, returns one initialization attempt's
    (F ranks [200, 8], H ranks [200, 4]), n_valid being the attempt's
    match count clamped to at least 8 (a device tensor); tests replay the
    reference's `PRNGKey(17)` split once per attempt. By default the ranks
    come from a `torch.Generator` seeded with 17."""

    MIN_INIT_MATCHES = 100          # Tracking.cc:640-648

    def __init__(self, cfg: SlamConfig, draws=None, **kw):
        super().__init__(cfg, **kw)
        self._init_ref = None
        self._init_ref_frame_id = -1
        self._draws = draws
        self._init_gen = torch.Generator(device=self.device)
        self._init_gen.manual_seed(INIT_SEED)

    def process_mono(self, gray, feats=None) -> np.ndarray:
        """Track one monocular frame; returns Tcw [7] (numpy). `feats`
        replaces the extraction (tests feed both packages one set)."""
        if feats is None:
            feats = tracking.extract_frame_mono(self.cfg, gray, self.device)
        if self.state == "NOT_INITIALIZED":
            self._try_initialize(feats)
            self._record()
            self.frame_id += 1
            return self.Tcw.cpu().numpy()
        return self.process(gray, None, feats=feats)

    def _try_initialize(self, feats):
        n_kp = int(torch.sum(feats.valid))
        if self._init_ref is None:
            if n_kp >= self.MIN_INIT_MATCHES:
                self._init_ref = feats
                self._init_ref_frame_id = self.frame_id
            return
        idx, ok = _match_for_init(self.cfg, self._init_ref, feats)
        if int(torch.sum(ok)) < self.MIN_INIT_MATCHES:
            # too little overlap: re-seat the reference (Tracking.cc:644)
            self._init_ref = feats if n_kp >= self.MIN_INIT_MATCHES else None
            self._init_ref_frame_id = self.frame_id
            return
        samples = (self._draws(torch.clamp(torch.sum(ok), min=8))
                   if self._draws is not None else None)
        init = initialize_mono(self.cfg.camera, self._init_ref.xy[idx],
                               feats.xy, ok, self._init_gen, samples=samples)
        if not bool(init["ok"]):
            return
        good = init["good"] & ok
        if int(torch.sum(good)) < 50:
            return
        # parallax acceptance: a near-zero baseline passes the H/F vote but
        # triangulates a poorly conditioned map; demand a median
        # triangulation angle worth initializing on
        T21 = init["T21"]
        C2 = -se3.quat_rotate(se3.quat_conj(T21[:4]), T21[4:7])
        r1 = init["points"]
        r2 = r1 - C2[None]
        cosang = (torch.sum(r1 * r2, -1)
                  / torch.clamp(torch.linalg.vector_norm(r1, dim=-1)
                                * torch.linalg.vector_norm(r2, dim=-1),
                                min=1e-9))
        ang = torch.rad2deg(torch.arccos(torch.clamp(
            torch.where(good, cosang, torch.nan), -1.0, 1.0)))
        if float(nanmedian(ang)) < 2.5:
            return
        m, T21s = bootstrap_mono_map(
            self.cfg, self._init_ref, feats, self._init_ref_frame_id,
            self.frame_id, T21, init["points"], good, idx)
        self.map = m
        self.n_kf = 2
        self.last_kf_id = 1
        self.last_kf_frame_id = self.frame_id
        self.Tcw = T21s
        self.last_Tcw = T21s
        self.velocity = se3.se3_identity(device=self.device)
        self.state = "OK"
        self._init_ref = None
