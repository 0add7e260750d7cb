"""Semantic + geometric dynamic-feature rejection, SG-SLAM's core novelty.

Port of `sgslam_tpu/semantic/dynamic.py`, the contract of
Frame::RmDynamicPointWithSemanticAndGeometry:
  1. frame-to-frame correspondences for every keypoint: windowed ORB
     matching against the previous frame (`match_prev_frame`, one K1
     launch at keypoints x previous keypoints) or LK flow;
  2. drop correspondences inside the previous frame's dynamic boxes;
  3. RANSAC fundamental matrix from the purged correspondences;
  4. per-keypoint epipolar distance test, 0.2 px inside a person box and
     1.0 px outside;
  5. keep everything if fewer than 10% of the features would survive.

The reference draws its RANSAC samples from a `jax.random` key split once
per frame. Here a `sampler(n_valid, iters)` gives the [iters, 8] sample
ranks: by default uniform draws from a seeded `torch.Generator` on the
frontend's device (no host read); a test may inject one that replays the
reference's draws. Culling is a keep-mask over the fixed-capacity features.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..config import DynamicConfig
from ..geometry import epipolar
from ..ops import flow as flow_mod


@dataclasses.dataclass
class Boxes:
    """Fixed-capacity 2-D detection boxes (Detector2D output contract)."""

    xyxy: torch.Tensor    # [B,4] float32 (x1,y1,x2,y2)
    cls: torch.Tensor     # [B] int32 VOC class id
    score: torch.Tensor   # [B] float32
    valid: torch.Tensor   # [B] bool

    @staticmethod
    def empty(capacity: int = 32, device="cpu") -> "Boxes":
        return Boxes(xyxy=torch.zeros((capacity, 4), device=device),
                     cls=torch.zeros(capacity, dtype=torch.int32,
                                     device=device),
                     score=torch.zeros(capacity, device=device),
                     valid=torch.zeros(capacity, dtype=torch.bool,
                                       device=device))

    def to(self, device) -> "Boxes":
        return Boxes(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})


def in_any_box(xy, boxes: Boxes, box_mask):
    """xy [N,2] inside any (masked) box -> [N] bool
    (Frame::isInDynamicRegion)."""
    x, y = xy[..., 0:1], xy[..., 1:2]                     # [N,1]
    b = boxes.xyxy[None]                                  # [1,B,4]
    inside = ((x >= b[..., 0]) & (x <= b[..., 2])
              & (y >= b[..., 1]) & (y <= b[..., 3]))
    return torch.any(inside & (boxes.valid & box_mask)[None, :], dim=-1)


def generator_sampler(generator: torch.Generator):
    """The default RANSAC sampler: uniform ranks from `generator`."""
    return lambda n_valid, iters: epipolar.draw_samples(n_valid, iters,
                                                        generator)


def _epipolar_cull(cfg: DynamicConfig, kp_xy, kp_valid, prev_xy, status,
                   person_boxes: Boxes, prev_dynamic_boxes: Boxes, sampler,
                   cull_unmatched: bool):
    """Steps 2-5 on correspondences (prev_xy, status)."""
    in_prev_dyn = in_any_box(prev_xy, prev_dynamic_boxes,
                             torch.ones_like(prev_dynamic_boxes.valid))
    for_f = status & ~in_prev_dyn

    F, _, n_inl = epipolar.ransac_fundamental(
        kp_xy, prev_xy, for_f, iters=cfg.ransac_iters,
        thresh=cfg.ransac_thresh,
        samples=sampler(for_f.sum(), cfg.ransac_iters))

    dist = epipolar.epipolar_distance(F, kp_xy, prev_xy)
    in_person = in_any_box(kp_xy, person_boxes,
                           torch.ones_like(person_boxes.valid))
    thresh = torch.where(in_person, cfg.epi_dist_in_box, cfg.epi_dist_outside)
    is_dynamic = status & (dist > thresh)
    if cull_unmatched:
        # stronger than the reference: a keypoint inside a confident person
        # box with no frame-to-frame correspondence is culled too
        is_dynamic = is_dynamic | (~status & in_person)

    keep = kp_valid & ~is_dynamic
    keep = _survivor_floor(cfg, kp_valid, keep)
    return keep, torch.sum(status.to(torch.int32)), n_inl


def _survivor_floor(cfg: DynamicConfig, valid, keep):
    """Keep everything if fewer than `min_survivor_ratio` survive."""
    n_total = torch.sum(valid.to(torch.int32))
    n_keep = torch.sum(keep.to(torch.int32))
    too_aggressive = n_keep < cfg.min_survivor_ratio * n_total.to(
        torch.float32)
    return torch.where(too_aggressive, valid, keep)


def reject_dynamic(cfg: DynamicConfig, gray_cur, gray_prev, kp_xy, kp_valid,
                   person_boxes: Boxes, prev_dynamic_boxes: Boxes, sampler):
    """The LK-flow variant. Returns (keep_mask [N], n_flow_matches,
    n_inliers_F)."""
    prev_xy, status = flow_mod.lk_flow(
        gray_cur, gray_prev, kp_xy, kp_valid,
        levels=cfg.flow_levels, window=cfg.flow_window, iters=cfg.flow_iters)
    return _epipolar_cull(cfg, kp_xy, kp_valid, prev_xy, status,
                          person_boxes, prev_dynamic_boxes, sampler,
                          cull_unmatched=False)


def match_prev_frame(matcher_cfg, scale_factor: float, feats_cur,
                     prev_xy, prev_level, prev_angle, prev_desc, prev_valid,
                     radius: float = 24.0):
    """Frame-to-frame correspondences by windowed ORB matching (one
    [keypoints x previous keypoints] Hamming matrix, K1 on the GPU), with
    rotation-consistency filtering. Returns (prev_xy_of_cur [N,2],
    status [N] bool)."""
    from ..matching import search

    N = feats_cur.xy_raw.shape[0]
    idx, ok, dist = search.search_by_projection(
        feats_cur.xy_raw,
        torch.full((N,), radius, device=feats_cur.xy_raw.device),
        feats_cur.level, feats_cur.desc, feats_cur.valid,
        prev_xy, prev_level, prev_desc, prev_valid,
        level_window=1, max_dist=matcher_cfg.th_low,
        scale_factor=scale_factor)
    ok = search.resolve_duplicate_targets(idx, ok, dist, prev_xy.shape[0])
    if matcher_cfg.check_orientation:
        dtheta = feats_cur.angle - prev_angle[idx]
        ok = search.rotation_consistency(dtheta, ok, matcher_cfg.histo_length)
    return prev_xy[idx], ok


def reject_dynamic_matched(cfg: DynamicConfig, kp_xy, kp_valid, prev_xy,
                           status, person_boxes: Boxes,
                           prev_dynamic_boxes: Boxes, sampler):
    """Dynamic rejection on precomputed frame-to-frame correspondences
    (steps 2-5). Returns (keep_mask [N], n_corr, n_inliers_F)."""
    return _epipolar_cull(cfg, kp_xy, kp_valid, prev_xy, status,
                          person_boxes, prev_dynamic_boxes, sampler,
                          cull_unmatched=cfg.cull_unmatched_in_box)


def apply_keep_mask(feats, keep):
    """Culling = masking (replaces the reference's descriptor-row erase)."""
    return dataclasses.replace(feats, valid=feats.valid & keep)


class SemanticFrontend:
    """Per-frame dynamic-rejection state: previous-frame features, boxes
    and gray image, and the RANSAC sampler. Before the map is initialized
    the cull is by the person boxes alone (with the survivor floor);
    afterwards, the full semantic + geometric cull."""

    def __init__(self, cfg, seed: int = 3, device="cuda", sampler=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prev_feats = None
        self.prev_gray = None
        self.prev_boxes = Boxes.empty(cfg.detector.max_boxes, self.device)
        if sampler is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            sampler = generator_sampler(gen)
        self.sampler = sampler

    def cull(self, gray, feats, person_cull_boxes: Boxes,
             map_initialized: bool):
        """Returns the culled feature block for tracking. Call `push`
        afterwards with the pre-cull features + this frame's dynamic boxes
        (the next frame's match target)."""
        cfg = self.cfg
        if not map_initialized:
            inside = in_any_box(feats.xy_raw, person_cull_boxes,
                                torch.ones_like(person_cull_boxes.valid))
            keep0 = _survivor_floor(cfg.dynamic, feats.valid,
                                    feats.valid & ~inside)
            feats = apply_keep_mask(feats, keep0)
        if self.prev_feats is None:
            return feats
        if cfg.dynamic.use_lk_flow:
            keep, _, _ = reject_dynamic(
                cfg.dynamic, gray, self.prev_gray, feats.xy_raw,
                feats.valid, person_cull_boxes, self.prev_boxes,
                self.sampler)
        else:
            p = self.prev_feats
            prev_xy, status = match_prev_frame(
                cfg.matcher, cfg.orb.scale_factor, feats,
                p.xy_raw, p.level, p.angle, p.desc, p.valid,
                radius=cfg.dynamic.match_radius)
            keep, _, _ = reject_dynamic_matched(
                cfg.dynamic, feats.xy_raw, feats.valid, prev_xy, status,
                person_cull_boxes, self.prev_boxes, self.sampler)
        return apply_keep_mask(feats, keep)

    def push(self, gray, feats_raw, dynamic_boxes: Boxes):
        self.prev_gray = gray
        self.prev_feats = feats_raw
        self.prev_boxes = dynamic_boxes
