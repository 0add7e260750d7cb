"""FAST-9/16 corner detection as a dense, vectorized map over the image.

Port of `sgslam_tpu/ops/fast.py`: one score map at the low threshold, with
OpenCV's cornerScore semantics, then a strict 3x3 non-max suppression. The
shifts are gathers with clamped indices, which give the reference's edge
padding; every step is a subtraction, a min or a max, so the score map is
exact given the same level image.

These functions are the plain version and the CPU path of
`orb.detect_cells`; on the card the detection of a whole pyramid is one
launch of `csrc/fast_detect.cu`, equal to them to the bit.
"""

from __future__ import annotations

import torch

# Bresenham circle of radius 3, clockwise from 12 o'clock — (dx, dy) offsets.
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

ARC = 9  # FAST-9: contiguous arc length


def _shift(img, dx: int, dy: int):
    """img shifted so out[y, x] = img[y + dy, x + dx], edge-padded."""
    if dx == 0 and dy == 0:
        return img
    h, w = img.shape
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img.index_select(0, ys).index_select(1, xs)


def fast_score_map(img, threshold: float):
    """Dense FAST-9/16 corner score map with cv::FAST score semantics.

    img: [H, W] float32. Returns score [H, W] float32; 0 where not a corner:
        score = max over 9-arcs of min over arc of (ring - center)   [bright]
              / of (center - ring)                                    [dark]
    """
    ring = torch.stack([_shift(img, dx, dy) for dx, dy in CIRCLE])  # [16,H,W]
    diff = ring - img[None]

    def arc_score(d):
        # windowed min of length ARC over the circular axis, then max
        m = torch.cat([d, d[: ARC - 1]], dim=0)                    # [24,H,W]
        win_min = m[:16]
        for k in range(1, ARC):
            win_min = torch.minimum(win_min, m[k:k + 16])
        return torch.amax(win_min, dim=0)                          # [H,W]

    score = torch.maximum(arc_score(diff), arc_score(-diff))
    thr = torch.tensor(threshold, dtype=score.dtype, device=score.device)
    return torch.where(score > thr, score, torch.zeros_like(score))


def nms_3x3(score):
    """Strict 3x3 non-max suppression: plateau ties are suppressed,
    matching OpenCV FAST's nonmax_suppression (score must exceed all 8
    neighbours)."""
    neigh = [
        _shift(score, dx, dy)
        for dx in (-1, 0, 1) for dy in (-1, 0, 1) if (dx, dy) != (0, 0)
    ]
    nmax = torch.amax(torch.stack(neigh), dim=0)
    return torch.where((score > nmax) & (score > 0.0), score,
                       torch.zeros_like(score))


def border_mask(h: int, w: int, margin: int, dtype=torch.float32,
                device=None):
    m = torch.zeros((h, w), dtype=dtype, device=device)
    m[margin:h - margin, margin:w - margin] = 1.0
    return m
