"""Association searches: `sgslam_tpu_torch/matching/search.py`, and the plain
chain of `ops/hamming_search.py` and `ops/hamming_cuda.py` that the card's
K1s kernel replaces (`hamming_search` is `hamming_search_reference`).

Frozen copy of the files named above as of commit 1275b16, with
their imports pointed at this folder. It imports nothing of the
program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .orb import topk_stable


MAX_DIST = 256
WORDS = 8
TWO_PI = 6.283185307179586


def _popcount32(x):
    """SWAR popcount of int64 tensors holding values in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matrix_reference(a, b):
    """Plain torch version: a [N,8], b [M,8] int32 -> [N,M] int32.

    Loops over the 8 words so that no [N,M,8] tensor exists; each XOR is
    masked to 32 bits in int64, where shifts are logical."""
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64,
                      device=a.device)
    for w in range(WORDS):
        x = (a[:, w, None].to(torch.int64) ^ b[None, :, w].to(torch.int64))
        out += _popcount32(x & 0xFFFFFFFF)
    return out.to(torch.int32)


class Window(NamedTuple):
    """The projective search's window: query row i's predicted position
    proj_uv[i] [Q,2] f32, radius r[i] [Q] f32 (already scaled to its
    level), predicted level pred_level[i] [Q] i32, against the features'
    positions feat_xy [N,2] f32 and levels feat_level [N] i32."""
    proj_uv: torch.Tensor
    r: torch.Tensor
    pred_level: torch.Tensor
    feat_xy: torch.Tensor
    feat_level: torch.Tensor
    level_window: int


def _second_min(d, best_idx):
    """Row minimum of d with the entry at best_idx replaced by MAX_DIST
    (a scatter of the scalar, so that a CUDA graph can capture it)."""
    d2 = d.clone()
    d2.scatter_(1, best_idx[:, None], MAX_DIST)
    return torch.amin(d2, dim=1)


def candidates(valid_q, valid_t, window: Window | None):
    """[Q,N] bool: the pairs a search may match."""
    cand = valid_q[:, None] & valid_t[None, :]
    if window is None:
        return cand
    w = window
    r = w.r[:, None]
    du = w.feat_xy[None, :, 0] - w.proj_uv[:, None, 0]
    dv = w.feat_xy[None, :, 1] - w.proj_uv[:, None, 1]
    in_window = (torch.abs(du) <= r) & (torch.abs(dv) <= r)
    in_level = (torch.abs(w.feat_level[None, :] - w.pred_level[:, None])
                <= w.level_window)
    return in_window & in_level & cand


def hamming_search_reference(desc_q, valid_q, desc_t, valid_t,
                             window: Window | None = None,
                             mutual: bool = False):
    """Plain version: (best_idx [Q] i64, best [Q] i32, second [Q] i32,
    rbest [N] i64 or None) over dm = where(cand, hamming, MAX_DIST), by
    the torch chain (on a card, K1 and about 16 [Q,N] launches)."""
    d = hamming_matrix_reference(desc_q, desc_t)
    dm = torch.where(candidates(valid_q, valid_t, window), d, MAX_DIST)
    best_idx = torch.argmin(dm, dim=1)
    best = torch.amin(dm, dim=1)
    second = _second_min(dm, best_idx)
    rbest = torch.argmin(dm, dim=0) if mutual else None
    return best_idx, best, second, rbest


hamming_search = hamming_search_reference


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
