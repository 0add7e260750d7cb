"""Stereo matching for rectified pairs: `sgslam_tpu_torch/ops/stereo.py`,
the per-keypoint epipolar SAD search with its sub-pixel parabola.

Frozen copy of the file named above as of commit 2002853, with its
imports pointed at this folder. It imports nothing of the program.

Every keypoint is searched at once over a static window of candidate
disparities; the SAD of a 5x5 bilinear patch over all (keypoint,
disparity) pairs is one batched gather + reduction, and the subpixel
parabola is closed-form. `argmin` takes the first minimum; out-of-bounds
candidates are `inf`, so a keypoint with none in bounds gets index 0,
which the border gate rejects.
"""

from __future__ import annotations

import dataclasses

import torch

from .camera import Camera
from .orb import bilinear_sample


def _patch_offsets(patch: int, device):
    """[patch * patch, 2] (dx, dy) offsets, row-major in dy."""
    half = patch // 2
    r = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def stereo_match(cam: Camera, gray_l, gray_r, xy, level, valid, *,
                 max_disparity: int = 96, patch: int = 5, step: int = 1):
    """Per-keypoint disparity search along the rectified epipolar row.

    xy: [N,2] LEFT-image keypoint coords (level-0 pixels); level: [N] i32.
    Returns (u_right [N] f32, depth [N] f32, ok [N] bool) — u_right < 0
    where no reliable match exists (the mono convention the map uses).
    """
    half = patch // 2
    offs = _patch_offsets(patch, xy.device)                    # [P2,2]

    # left template patches
    tmpl = bilinear_sample(gray_l, xy[:, None, :] + offs[None])  # [N,P2]

    # candidate disparities (positive: right feature sits left of left's u)
    disp = torch.arange(0, max_disparity, step, dtype=torch.float32,
                        device=xy.device)                      # [D]
    cand_x = xy[:, None, 0] - disp[None, :]                    # [N,D]
    xs = cand_x[:, :, None] + offs[None, None, :, 0]           # [N,D,P2]
    ys = (xy[:, None, None, 1] + offs[None, None, :, 1]).expand_as(xs)
    patches_r = bilinear_sample(gray_r, torch.stack([xs, ys], -1))
    sad = torch.mean(torch.abs(patches_r - tmpl[:, None, :]), -1)  # [N,D]
    sad = torch.where(cand_x > half, sad, torch.inf)           # in-bounds

    best = torch.argmin(sad, dim=1)
    best_sad = torch.gather(sad, 1, best[:, None])[:, 0]

    # parabola subpixel refine over (best-1, best, best+1)
    D = sad.shape[1]
    s0 = torch.gather(sad, 1, torch.clamp(best - 1, 0, D - 1)[:, None])[:, 0]
    s2 = torch.gather(sad, 1, torch.clamp(best + 1, 0, D - 1)[:, None])[:, 0]
    denom = torch.clamp(s0 - 2.0 * best_sad + s2, min=1e-9)
    delta = torch.clamp(0.5 * (s0 - s2) / denom, -1.0, 1.0)
    d_sub = (best.to(torch.float32) + delta) * step

    # acceptance: low residual, not at the search border, minimum disparity
    ok = (valid & torch.isfinite(best_sad) & (best_sad < 0.08)
          & (best > 0) & (best < D - 1) & (d_sub > 0.5))
    u_right = torch.where(ok, xy[:, 0] - d_sub, -1.0)
    depth = torch.where(ok, cam.bf / torch.clamp(d_sub, min=1e-6), 0.0)
    return u_right, depth, ok


def attach_stereo(cam: Camera, feats, gray_l, gray_r):
    """Fill a Features block's u_right/depth from a rectified stereo pair
    (the stereo-constructor contract, Frame.cc:87-127)."""
    u_right, depth, _ = stereo_match(cam, gray_l, gray_r, feats.xy_raw,
                                     feats.level, feats.valid)
    return dataclasses.replace(feats, u_right=u_right, depth=depth)
