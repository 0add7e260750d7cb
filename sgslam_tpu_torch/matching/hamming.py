"""Batched 256-bit Hamming distance between packed ORB descriptors.

Port of `sgslam_tpu/matching/hamming.py`. Descriptors are [*, 8] int32
(the reference's uint32 words, bit-cast). `hamming_matrix` has one exact
path per device: the hand-written CUDA kernel for CUDA tensors, its plain
torch version for CPU tensors (`ops/hamming_cuda.py`).
"""

from __future__ import annotations

import torch

from ..ops.hamming_cuda import _popcount32
from ..ops.hamming_cuda import hamming_matrix  # noqa: F401  (re-export)
from ..ops.hamming_search import MAX_DIST, _second_min


def hamming_pairs(a, b):
    """Rowwise distance between aligned descriptor arrays [N,8]."""
    x = (a.to(torch.int64) ^ b.to(torch.int64)) & 0xFFFFFFFF
    return torch.sum(_popcount32(x), dim=-1).to(torch.int32)


def masked_best_two(dist, row_mask, col_mask):
    """Per-row best and second-best over a masked distance matrix.

    dist: [N,M] int32; row_mask: [N] bool; col_mask: [N,M] or [M] bool.
    Returns (best_idx [N], best [N], second [N]) with MAX_DIST fill; the
    best index is the first minimum, as `jnp.argmin` gives it.
    """
    if col_mask.dim() == 1:
        col_mask = col_mask[None, :].expand(dist.shape)
    d = torch.where(col_mask & row_mask[:, None], dist, MAX_DIST)
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    second = _second_min(d, best_idx)
    return best_idx, best, second
