"""Loop detection, Sim(3) verification, essential-graph correction, and
relocalization.

Port of `sgslam_tpu/slam/loop_closing.py`:
  * candidate retrieval: a dense BoW-score scan over the keyframe database
    with the reference's gates (exclude covisible keyframes, score at least
    the lowest covisible neighbour's), then covisibility-group score
    accumulation; both top-k's are stable sorts (`topk_stable`), since the
    scores hold many tied -inf entries and `lax.top_k` breaks ties toward
    the lower index;
  * temporal consistency over `covisibility_consistency_th` keyframes (host
    bookkeeping, as in the reference);
  * geometric verification: mutual ORB matches between the two keyframes'
    feature blocks (K1, 1024 x 1024 at 640x480), batched Horn RANSAC Sim3,
    Sim3 GN, then the SearchBySim3 widening (K1 again) and re-fit;
  * correction: essential graph (spanning tree + strong covisibility +
    every stored loop edge) -> duplicate fusion (radius 6) -> global BA
    with the loop pair pinned, in the reference's order.

The RANSAC draws of `ransac_sim3` and `ransac_pnp` come from `draws(seed,
n_valid, iters, k)`: by default a `torch.Generator` seeded by the
reference's key seed (the keyframe id, the candidate id), with no host
read; tests pass one that replays `jax.random.randint(PRNGKey(seed), ...)`.

Deferred mode (the chunked runner's): a keyframe's candidates are copied
to pinned host memory with a `non_blocking` copy recorded by an event, and
inspected at the next keyframe, which waits on that event only.

Spans on the active tracer (`utils/timing.active()`): `loop.detect` per
keyframe (and per `flush`), holding `loop.correct` when a loop is
accepted, which holds `loop.essential_graph`, `loop.fuse` and the global
BA's `loop.gba` slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..config import SlamConfig
from ..geometry import se3
from ..geometry.camera import backproject, project
from ..geometry.epipolar import seeded_ranks
from ..mapstate import maintenance as mt
from ..mapstate import mapstate as ms
from ..matching import search
from ..models import vocab as vocab_mod
from ..ops.orb import topk_stable
from ..optim import pose_graph, sim3
from ..optim.global_ba import global_ba_interruptible
from ..optim.pnp import ransac_pnp
from ..utils import timing


def _bow_of_kf(vocab, desc, valid):
    return vocab_mod.bow_vector(vocab, vocab_mod.quantize(vocab, desc, valid))


def _kf_update(vocab, m: ms.MapState, bow_db, db_valid, kf_id: int):
    """Per-keyframe database update + loop-candidate detection: the new
    keyframe's BoW row is written into `bow_db`/`db_valid` in place, and
    (top candidate ids [3], their scores [3], their covisibility rows
    [3, K] > 0) are returned on the device."""
    K = bow_db.shape[0]
    dev = bow_db.device
    bow = _bow_of_kf(vocab, m.kf_feat_desc[kf_id], m.kf_feat_valid[kf_id])
    bow_db[kf_id] = bow
    db_valid[kf_id] = True

    slot = torch.arange(K, device=dev)
    dbv = db_valid & m.kf_valid
    cov_row = ms.covisibility_rows(m, [kf_id])[0]
    scores = vocab_mod.l1_score(bow, bow_db)
    covisible = cov_row > 0
    cov_scores = torch.where(covisible & dbv, scores, torch.inf)
    min_score = torch.clamp(torch.min(cov_scores), max=1.0)
    eligible = dbv & ~covisible & (slot != kf_id) & (slot < kf_id - 5)
    floor = torch.where(torch.isfinite(min_score), min_score, 0.0)
    s = torch.where(eligible & (scores >= floor), scores, -torch.inf)
    # covisibility-group accumulation (KeyFrameDatabase::
    # DetectLoopCandidates): each candidate's group = itself + its
    # connected keyframes that also scored; groups under 0.75x the best go
    pre_s, pre_i = topk_stable(s, 8)
    pre_cov = ms.covisibility_rows(m, pre_i)                 # [8, K]
    s_pos = torch.where(torch.isfinite(s), s, 0.0)
    acc = torch.where(
        torch.isfinite(pre_s),
        pre_s + torch.sum(torch.where(pre_cov > 0, s_pos[None, :], 0.0), 1),
        -torch.inf)
    acc = torch.where(acc >= 0.75 * torch.max(acc), acc, -torch.inf)
    top_a, sel = topk_stable(acc, 3)
    top_i = pre_i[sel]
    top_s = torch.where(torch.isfinite(top_a), pre_s[sel], -torch.inf)
    return top_i, top_s, pre_cov[sel] > 0


def _match_keyframes(cfg: SlamConfig, m: ms.MapState, kf_a: int, kf_b: int):
    """Brute-force mutual ORB matches between two keyframes' feature blocks
    (K1) -> camera-frame 3-D pairs, pixels and the match mask."""
    va = m.kf_feat_valid[kf_a] & (m.kf_feat_depth[kf_a] > 0)
    vb = m.kf_feat_valid[kf_b] & (m.kf_feat_depth[kf_b] > 0)
    idx, ok, _ = search.match_by_descriptor(
        m.kf_feat_desc[kf_a], va, m.kf_feat_desc[kf_b], vb, cfg.matcher,
        max_dist=cfg.matcher.th_low, mutual=True)
    pa = backproject(cfg.camera, m.kf_feat_xy[kf_a], m.kf_feat_depth[kf_a])
    pb = backproject(cfg.camera, m.kf_feat_xy[kf_b],
                     m.kf_feat_depth[kf_b])[idx]
    return pa, pb, m.kf_feat_xy[kf_a], m.kf_feat_xy[kf_b][idx], ok


def _widen_sim3(cfg: SlamConfig, m: ms.MapState, kf_cur: int, kf_loop: int,
                S_ab, fix_scale: bool = True):
    """SearchBySim3 widening + Horn re-fit: the loop keyframe's depth-backed
    features go through S_ab into the current keyframe, a windowed
    projective search (radius 7.5 px, K1) adds correspondences, the Sim3 is
    re-estimated and the two-way inliers counted.
    Returns (S_refined [8], n_total_matches) on the device."""
    cam = cfg.camera
    depth_b = m.kf_feat_depth[kf_loop]
    valid_b = m.kf_feat_valid[kf_loop] & (depth_b > 0)
    pb = backproject(cam, m.kf_feat_xy[kf_loop], depth_b)
    pb_in_a = se3.sim3_apply(S_ab[None], pb)
    N = pb.shape[0]
    idx, ok, dist = search.search_by_projection(
        project(cam, pb_in_a), torch.full((N,), 7.5, device=pb.device),
        m.kf_feat_level[kf_loop], m.kf_feat_desc[kf_loop],
        valid_b & (pb_in_a[:, 2] > 0.1),
        m.kf_feat_xy[kf_cur], m.kf_feat_level[kf_cur],
        m.kf_feat_desc[kf_cur], m.kf_feat_valid[kf_cur],
        level_window=1, max_dist=cfg.matcher.th_high,
        scale_factor=cfg.orb.scale_factor)
    ok = search.resolve_duplicate_targets(idx, ok, dist, m.n_feat)
    depth_a = m.kf_feat_depth[kf_cur][idx]
    ok3 = ok & (depth_a > 0)
    uva = m.kf_feat_xy[kf_cur][idx]
    pa = backproject(cam, uva, depth_a)
    uvb = m.kf_feat_xy[kf_loop]

    S_ref = sim3.horn_alignment(pb, pa, ok3.to(torch.float32),
                                fix_scale=fix_scale)
    e1, e2 = sim3._two_way_chi2(cam, S_ref, pa, pb, uva, uvb)
    inl = ok3 & (e1 < 9.21) & (e2 < 9.21)
    S_final = sim3.horn_alignment(pb, pa, inl.to(torch.float32),
                                  fix_scale=fix_scale)
    return S_final, torch.sum(inl.to(torch.int32))


def _apply_correction(m: ms.MapState, old_poses, new_poses) -> ms.MapState:
    """Move every map point through its reference keyframe's correction and
    install the new keyframe poses."""
    k = torch.clamp(m.pt_first_kf, 0, m.max_kf - 1).to(torch.int64)
    pc = se3.se3_apply(old_poses[k], m.pt_pos)
    p_new = se3.se3_apply(se3.se3_inverse(new_poses[k]), pc)
    keep = ((m.pt_first_kf >= 0) & m.pt_valid)[:, None]
    return dataclasses.replace(m, pt_pos=torch.where(keep, p_new, m.pt_pos),
                               kf_pose=new_poses)


def _start_fetch(tensors):
    """Start copying device tensors to the host: a `non_blocking` copy into
    pinned memory on CUDA, recorded by an event. Returns (hosts, event)."""
    if tensors[0].device.type != "cuda":
        return list(tensors), None
    hosts = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        hosts.append(h)
    ev = torch.cuda.Event()
    ev.record()
    return hosts, ev


def _finish_fetch(fetch):
    hosts, ev = fetch
    if ev is not None:
        ev.synchronize()
    return [h.cpu().numpy() for h in hosts]


class LoopCloser:
    """Host orchestration of loop closing and relocalization on `device`.

    deferred=True delays each keyframe's candidate inspection to the next
    `on_keyframe` (or `flush`); the candidates' host copy runs meanwhile."""

    def __init__(self, cfg: SlamConfig, vocab=None, deferred: bool = False,
                 fix_scale: bool = True, device="cuda", draws=None):
        self.device = resolve_device(device)
        self.fix_scale = fix_scale
        self.cfg = cfg
        self.vocab = (vocab if vocab is not None
                      else vocab_mod.default_vocab()).to(self.device)
        K = cfg.capacity.max_keyframes
        self.bow_db = torch.zeros((K, self.vocab.n_words), dtype=torch.float32,
                                  device=self.device)
        self.db_valid = torch.zeros(K, dtype=torch.bool, device=self.device)
        self.deferred = deferred
        self.draws = draws if draws is not None else seeded_ranks
        self._deferred_det = None   # (kf_id, fetch of cand_i/cand_s/cov_top)
        self._consistency: dict[int, int] = {}     # candidate -> streak
        self.loops_closed: list[tuple[int, int]] = []
        # every past closure's (cur, loop, Sim3 as established) triple is
        # re-added to every later essential graph (sLoopEdges)
        self.loop_edges: list[tuple[int, int, np.ndarray]] = []
        # preemption hook of the post-loop GBA beyond its first 10 iters
        self.should_abort_gba = None
        self.last_gba_iters = 0
        self.gba_remaining = 0
        self._gba_fixed = None      # [K] bool loop-pair pin, or None

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def remap_keyframes(self, kf_old_to_new, old_valid):
        """Follow a map compaction: permute the BoW rows, the GBA pin, the
        streaks and the loop edges to the new keyframe slots."""
        self._deferred_det = None
        K = self.bow_db.shape[0]
        ov = np.asarray(old_valid)
        km = np.asarray(kf_old_to_new)
        valid_t = self._tensor(ov, torch.bool)
        dst = torch.where(valid_t, self._tensor(km, torch.int64), K)

        def permute(x, fill):
            buf = torch.full((K + 1,) + x.shape[1:], fill, dtype=x.dtype,
                             device=x.device)
            keep = valid_t.reshape((-1,) + (1,) * (x.dim() - 1))
            buf[dst] = torch.where(keep, x, fill)
            return buf[:K]

        if self._gba_fixed is not None:
            self._gba_fixed = permute(self._gba_fixed, False)
        self.bow_db = permute(self.bow_db, 0.0)
        self.db_valid = permute(self.db_valid, False)
        self._consistency = {int(km[k]): v for k, v in
                             self._consistency.items() if ov[k]}
        self.loop_edges = [(int(km[i]), int(km[j]), s)
                           for i, j, s in self.loop_edges
                           if i >= 0 and j >= 0 and ov[i] and ov[j]]
        self.loops_closed = [(int(km[i]) if i >= 0 and ov[i] else -1,
                              int(km[j]) if j >= 0 and ov[j] else -1)
                             for i, j in self.loops_closed]

    def on_keyframe(self, m: ms.MapState, kf_id: int):
        """Update the database; returns a corrected map if a loop closes
        (in deferred mode, the correction triggered by the previous
        keyframe's candidates), else None."""
        with timing.active().span("loop.detect"):
            return self._on_keyframe(m, kf_id)

    def _on_keyframe(self, m: ms.MapState, kf_id: int):
        corrected = None
        if self._deferred_det is not None:
            corrected = self._inspect(m, *self._deferred_det)
            self._deferred_det = None
            m = corrected if corrected is not None else m
        det = _kf_update(self.vocab, m, self.bow_db, self.db_valid, kf_id)
        if kf_id < 10:
            return corrected
        if self.deferred:
            self._deferred_det = (kf_id, _start_fetch(det))
            return corrected
        out = self._inspect(m, kf_id, _start_fetch(det))
        return out if out is not None else corrected

    def flush(self, m: ms.MapState):
        """Resolve a deferred detection (sequence end / drain idle)."""
        if self._deferred_det is None:
            return None
        with timing.active().span("loop.detect"):
            out = self._inspect(m, *self._deferred_det)
        self._deferred_det = None
        return out

    def _inspect(self, m: ms.MapState, kf_id: int, fetch):
        """Streak bookkeeping + geometric verification + correction."""
        cand_i, cand_s, cov_top = _finish_fetch(fetch)
        new_streaks: dict[int, int] = {}
        hits: list[int] = []
        for k, (ci, s) in enumerate(zip(cand_i, cand_s)):
            if not np.isfinite(s):
                continue
            ci = int(ci)
            prev = self._consistency.get(ci, 0)
            if prev == 0:
                for cj, streak in self._consistency.items():
                    if cj < cov_top.shape[1] and cov_top[k, cj]:
                        prev = max(prev, streak)
            new_streaks[ci] = prev + 1
            if prev + 1 >= self.cfg.loop.covisibility_consistency_th:
                hits.append(ci)
        self._consistency = new_streaks
        if not hits:
            return None
        hit, S_ab = self._verify_candidates(m, kf_id, hits)
        if hit is None:
            return None

        self.loops_closed.append((int(kf_id), int(hit)))
        self._consistency = {}
        with timing.active().span("loop.correct"):
            corrected, sim_opt = self._correct(m, kf_id, hit, S_ab,
                                               ms.covisibility(m))
        # persist the loop constraint as established, scale included
        self.loop_edges.append((int(kf_id), int(hit), se3.sim3_compose(
            sim_opt[kf_id], se3.sim3_inverse(sim_opt[hit])).cpu().numpy()))
        return corrected

    def _verify_candidates(self, m: ms.MapState, kf_id: int,
                           hits: list[int]):
        """BoW-match gate -> Horn RANSAC Sim3 -> Sim3 GN -> SearchBySim3
        widening -> total-match gate, per candidate; the first verified
        candidate wins (ComputeSim3). Returns (hit, S_ab) or (None, None)."""
        cfg = self.cfg
        for hit in hits:
            pa, pb, uva, uvb, ok = _match_keyframes(cfg, m, kf_id, hit)
            n_ok = ok.sum()
            if int(n_ok) < cfg.loop.min_bow_matches:
                continue
            S_ab, inl, n = sim3.ransac_sim3(
                cfg.camera, pa, pb, uva, uvb, ok,
                samples=self.draws(kf_id, n_ok, 128, 3), iters=128,
                fix_scale=self.fix_scale)
            if int(n) < cfg.loop.min_sim3_inliers:
                continue
            S_ab, inl, n = sim3.optimize_sim3(
                cfg.camera, S_ab, pa, pb, uva, uvb, ok,
                fix_scale=self.fix_scale)
            if int(n) < cfg.loop.min_sim3_inliers:
                continue
            S_ab, n_total = _widen_sim3(cfg, m, kf_id, hit, S_ab,
                                        fix_scale=self.fix_scale)
            if int(n_total) >= cfg.loop.min_total_matches:
                return hit, S_ab
        return None, None

    # ------------------------------------------------------------------
    def relocalize(self, m: ms.MapState, feats):
        """BoW candidates -> 2D-3D PnP RANSAC -> track_step widening
        (Tracking::Relocalization with DetectRelocalizationCandidates).
        Returns (Tcw [7] tensor, n_inliers) or (None, n)."""
        from . import tracking

        cfg = self.cfg
        feats = feats.to(self.device)
        bow = _bow_of_kf(self.vocab, feats.desc, feats.valid)
        scores = vocab_mod.l1_score(bow, self.bow_db)
        scores = torch.where(self.db_valid & m.kf_valid, scores, -torch.inf)
        top_s, top_i = topk_stable(scores, 3)
        best = (None, 0)
        for ci, s in zip(top_i.tolist(), top_s.tolist()):
            if not np.isfinite(s):
                continue
            obs_pt = m.kf_obs_point[ci]
            idx, ok, _ = search.match_by_descriptor(
                feats.desc, feats.valid, m.kf_feat_desc[ci],
                m.kf_feat_valid[ci] & (obs_pt >= 0), cfg.matcher,
                max_dist=cfg.matcher.th_low, mutual=False)
            pid = torch.where(ok, obs_pt[idx], 0).to(torch.int64)
            ok = ok & m.pt_valid[pid]
            n_ok = ok.sum()
            if int(n_ok) < 15:
                continue
            Tcw, _, n = ransac_pnp(cfg.camera, m.pt_pos[pid], feats.xy, ok,
                                   samples=self.draws(ci, n_ok, 256, 6),
                                   iters=256)
            n = int(n)
            if n > best[1]:
                best = (Tcw, n)
        if best[0] is None or best[1] < 12:
            return None, best[1]
        # the PnP pose seeds a full local-map association + motion-only BA
        T2, _, n2, _, _, _ = tracking.track_step(cfg, m, feats, best[0],
                                              self.device)
        n2 = int(n2)
        if n2 >= cfg.tracker.min_inliers_after_reloc:
            return T2, n2
        if best[1] >= cfg.tracker.min_inliers_after_reloc:
            return best
        return None, max(best[1], n2)

    def _correct(self, m: ms.MapState, kf_cur: int, kf_loop: int, S_cur_loop,
                 cov):
        """Essential graph -> duplicate fusion -> pinned global BA
        (CorrectLoop). Returns (corrected map, optimized Sim3 poses [K,8])."""
        tr = timing.active()
        K = m.max_kf
        with tr.span("loop.essential_graph"):
            dev = m.device
            old_poses = m.kf_pose
            sim_poses = torch.cat(
                [old_poses, torch.ones_like(old_poses[:, :1])], 1)
            nkf = int(m.next_kf)
            kf_valid = m.kf_valid.cpu().numpy()
            cov_np = cov.cpu().numpy()

            # covisibility spanning tree: parent = the earlier keyframe
            # sharing the most observations, else the nearest earlier slot
            parent = np.full(K, -1, np.int64)
            prev_valid = -1
            for k in range(nkf):
                if not kf_valid[k]:
                    continue
                if prev_valid >= 0:
                    w = cov_np[k, :k].copy()
                    w[~kf_valid[:k]] = 0.0
                    best = int(np.argmax(w)) if w.size else 0
                    parent[k] = (best if w.size and w[best] > 0
                                 else prev_valid)
                prev_valid = k

            li, lj = [int(kf_cur)], [int(kf_loop)]
            lmeas = [S_cur_loop.cpu().numpy()]
            for pi, pj, pmeas in self.loop_edges:
                if pi < 0 or pj < 0 or not (kf_valid[pi] and kf_valid[pj]):
                    continue
                li.append(pi)
                lj.append(pj)
                lmeas.append(np.asarray(pmeas))
            ei, ej, meas, ew = pose_graph.build_essential_edges(
                cov_np, sim_poses.cpu().numpy(), parent, np.asarray(li),
                np.asarray(lj), lmeas, min_covis_weight=100.0,
                max_edges=4 * K, device=dev)

            valid = np.zeros(K, bool)
            valid[:nkf] = kf_valid[:nkf]
            fixed = np.zeros(K, bool)
            fixed[kf_loop] = True
            opt = pose_graph.optimize_pose_graph(
                sim_poses, self._tensor(valid, torch.bool),
                self._tensor(fixed, torch.bool), ei, ej, meas, ew, iters=40,
                fix_scale=self.fix_scale)
            new_poses = se3.se3_make(se3.quat_normalize(opt[:, :4]),
                                     opt[:, 4:7])
            sim_opt = torch.cat([new_poses, opt[:, 7:8]], 1)
            m = _apply_correction(m, old_poses, new_poses)

        # post-correction duplicate fusion (SearchAndFuse) in the current
        # keyframe, its predecessor and every keyframe inserted after it,
        # with a wide radius: the duplicated revisit structure can sit tens
        # of pixels from its original right after the correction
        with tr.span("loop.fuse"):
            prev = int(mt.prev_valid_kf(m, kf_cur))
            fuse_slots = [prev] if prev >= 0 else []
            kf_valid_now = m.kf_valid.cpu().numpy()
            fuse_slots += [k for k in range(kf_cur, nkf) if kf_valid_now[k]]
            for k in fuse_slots[:12]:
                m = mt.fuse_duplicates(
                    self.cfg.camera, m, k,
                    scale_factor=self.cfg.orb.scale_factor,
                    max_candidates=self.cfg.capacity.local_points,
                    radius=6.0)

        # full-map BA with the verified loop pair pinned on top of the
        # keyframe-0 gauge; the first 10 iterations always complete, only
        # the budget beyond is cooperatively cancellable
        if self.cfg.loop.run_global_ba:
            fixed_extra = torch.zeros(K, dtype=torch.bool, device=dev)
            fixed_extra[kf_cur] = True
            fixed_extra[kf_loop] = True
            self._gba_fixed = fixed_extra
            total = self.cfg.loop.global_ba_iters
            base = min(10, total)
            m, done1 = global_ba_interruptible(
                self.cfg, m, iters=base, fixed_extra=self._gba_fixed)
            m, done2 = global_ba_interruptible(
                self.cfg, m, iters=total - base,
                should_abort=self.should_abort_gba,
                fixed_extra=self._gba_fixed)
            self.last_gba_iters = done1 + done2
            self.gba_remaining = total - self.last_gba_iters
        return m, sim_opt

    def continue_gba(self, m: ms.MapState, budget: int | None = None):
        """Resume an aborted global BA: `budget` bounds this slice and runs
        it without the abort hook. Returns the map, or None if nothing was
        pending."""
        if self.gba_remaining <= 0:
            return None
        if budget is not None:
            m, done = global_ba_interruptible(
                self.cfg, m, iters=min(budget, self.gba_remaining),
                fixed_extra=self._gba_fixed)
        else:
            m, done = global_ba_interruptible(
                self.cfg, m, iters=self.gba_remaining,
                should_abort=self.should_abort_gba,
                fixed_extra=self._gba_fixed)
        self.gba_remaining -= done
        return m
