"""Data-association searches over fixed-capacity feature sets.

Port of `sgslam_tpu/matching/search.py`: every search is a dense masked
distance matrix with the spatial window, level window, threshold, ratio
test and rotation-consistency histogram applied as masks. Ties resolve to the lowest index,
as `jnp.argmin` resolves them. Match tables are (idx [N], ok [N] bool,
dist [N]) mapping query rows to train rows.

The masked matrix and its per-row best two (and, for the mutual check,
per-column best) come from `ops.hamming_search.hamming_search`: on the
card one launch of the fused search K1s, which writes no [Q,N] matrix; on
the CPU the plain torch chain. The thresholds, the ratio test and the
mutual check run here on [Q] vectors.
"""

from __future__ import annotations

import torch

from ..config import MatcherConfig
from ..ops.orb import topk_stable
from ..ops.hamming_search import Window, hamming_search
from .hamming import MAX_DIST

TWO_PI = 6.283185307179586


def rotation_consistency(dtheta, ok, histo_length: int = 30, keep_top: int = 3):
    """Keep only matches whose angle delta falls in the top-k histogram bins
    (ORBmatcher::ComputeThreeMaxima + the mvRotHist filter,
    ORBmatcher.cc:1603-1646). dtheta: [N] radians; ok: [N] bool.

    `torch.remainder` is a floor-mod like `jnp.mod`, so negative deltas land
    in the same bins; bins within reach of the third count are kept, ties
    beyond the top-k included, as in the reference."""
    t = torch.remainder(dtheta, TWO_PI)
    bins = torch.clamp((t * (histo_length / TWO_PI)).to(torch.int64), 0,
                       histo_length - 1)
    hist = torch.zeros(histo_length, dtype=torch.int32, device=ok.device)
    hist.scatter_add_(0, bins, ok.to(torch.int32))
    top = topk_stable(hist, keep_top)[0]
    thresh = torch.clamp(top[0] // 10, min=1)
    good_bin = hist >= torch.maximum(top[keep_top - 1], thresh)
    return ok & good_bin[bins]


def match_by_descriptor(desc_q, valid_q, desc_t, valid_t,
                        cfg: MatcherConfig, *, max_dist: int | None = None,
                        mutual: bool = True, ratio: float | None = None):
    """Brute-force descriptor matching with ratio test + optional mutual
    check. Returns (idx [Nq], ok [Nq], dist [Nq])."""
    max_dist = cfg.th_low if max_dist is None else max_dist
    ratio = cfg.nn_ratio if ratio is None else ratio
    best_idx, best, second, rbest = hamming_search(
        desc_q, valid_q, desc_t, valid_t, mutual=mutual)
    ok = (best <= max_dist) & (best.to(torch.float32)
                               < ratio * second.to(torch.float32))
    if mutual:                                   # rbest: train -> query
        ok = ok & (rbest[best_idx] == torch.arange(best.shape[0],
                                                   device=best.device))
    return best_idx, ok, best


def search_by_projection(proj_uv, radii, pred_level, desc_q, valid_q,
                         feat_xy, feat_level, feat_desc, feat_valid,
                         level_window: int, max_dist: int,
                         scale_factor: float, ratio: float = 1.0):
    """Windowed projective search: query entities with predicted image
    locations vs frame features (ORBmatcher::SearchByProjection).

    proj_uv: [Q,2]; radii: [Q] (px at level 0); pred_level: [Q] i32;
    desc_q: [Q,8]; feat_*: frame arrays [N].
    Returns (idx [Q], ok [Q], dist [Q]).
    """
    r = radii * scale_factor ** pred_level.to(torch.float32)      # [Q]
    best_idx, best, second, _ = hamming_search(
        desc_q, valid_q, feat_desc, feat_valid,
        Window(proj_uv, r, pred_level, feat_xy, feat_level, level_window))
    ok = best <= max_dist
    if ratio < 1.0:
        ok = ok & (best.to(torch.float32)
                   < ratio * second.to(torch.float32))
    return best_idx, ok, best


def resolve_duplicate_targets(idx, ok, dist, n_targets: int):
    """Keep only the lowest-distance query per claimed target feature; exact
    ties go to the lowest query index. Returns the updated ok.

    A segment-min: `scatter_reduce_(..., "amin")` into a buffer with one
    spare slot that collects the invalid queries."""
    big = MAX_DIST + 1
    dev = idx.device
    slot = torch.where(ok, idx, n_targets)
    best_per_target = torch.full((n_targets + 1,), big, dtype=torch.int32,
                                 device=dev)
    best_per_target.scatter_reduce_(
        0, slot, torch.where(ok, dist, big).to(torch.int32), "amin")
    is_min = ok & (dist == best_per_target[idx])
    qidx = torch.arange(idx.shape[0], dtype=torch.int32, device=dev)
    imax = torch.iinfo(torch.int32).max
    slot2 = torch.where(is_min, idx, n_targets)
    first_q = torch.full((n_targets + 1,), imax, dtype=torch.int32,
                         device=dev)
    first_q.scatter_reduce_(0, slot2, torch.where(is_min, qidx, imax), "amin")
    return is_min & (first_q[idx] == qidx)
