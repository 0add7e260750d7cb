"""Sparse pyramidal Lucas-Kanade optical flow, batched over keypoints.

Port of `sgslam_tpu/ops/flow.py` (the `dynamic.use_lk_flow=True`
correspondence source). The power-of-two pyramid goes through
`image.resize_bilinear`, which reproduces `jax.image.resize`'s antialiased
weights; the reference's `fori_loop` is a Python loop of fixed length that
reads nothing back to the host.
"""

from __future__ import annotations

import torch

from .image import bilinear_sample, resize_bilinear


def _patch_coords(center, half: int):
    """center [N,2] -> sample grid [N, (2h+1)^2, 2]."""
    r = torch.arange(-half, half + 1, dtype=torch.float32,
                     device=center.device)
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    offs = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)   # [W2,2]
    return center[:, None, :] + offs[None, :, :]


def lk_flow(img_from, img_to, pts, valid, *, levels: int = 3,
            window: int = 11, iters: int = 10):
    """Track points from `img_from` to `img_to`.

    pts: [N,2] float32 positions in img_from.
    Returns (pts_to [N,2], status [N] bool).
    """
    half = window // 2
    h, w = img_from.shape
    dev = pts.device

    # power-of-two pyramids (cv::buildOpticalFlowPyramid convention)
    pyr_f, pyr_t = [img_from], [img_to]
    for _ in range(1, levels):
        ph, pw = pyr_f[-1].shape
        pyr_f.append(resize_bilinear(pyr_f[-1], ph // 2, pw // 2))
        pyr_t.append(resize_bilinear(pyr_t[-1], ph // 2, pw // 2))

    flow = torch.zeros_like(pts)
    err_ok = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    ex = torch.tensor([1.0, 0.0], device=dev)
    ey = torch.tensor([0.0, 1.0], device=dev)

    for lv in reversed(range(levels)):
        scale = 2.0 ** lv
        img_f, img_t = pyr_f[lv], pyr_t[lv]
        coords0 = _patch_coords(pts / scale, half)     # [N,W2,2]
        patch0 = bilinear_sample(img_f, coords0)       # [N,W2]
        # spatial gradients of the template (central differences)
        gx = 0.5 * (bilinear_sample(img_f, coords0 + ex)
                    - bilinear_sample(img_f, coords0 - ex))
        gy = 0.5 * (bilinear_sample(img_f, coords0 + ey)
                    - bilinear_sample(img_f, coords0 - ey))
        gxx = torch.sum(gx * gx, -1)
        gxy = torch.sum(gx * gy, -1)
        gyy = torch.sum(gy * gy, -1)
        det = gxx * gyy - gxy * gxy
        invertible = det > 1e-6
        det_safe = torch.where(invertible, det, 1.0)

        fl = flow / scale * 1.0
        for _ in range(iters):
            patch1 = bilinear_sample(img_t, coords0 + fl[:, None, :])
            diff = patch0 - patch1
            bx = torch.sum(diff * gx, -1)
            by = torch.sum(diff * gy, -1)
            dx = (gyy * bx - gxy * by) / det_safe
            dy = (gxx * by - gxy * bx) / det_safe
            step = torch.where(invertible[:, None],
                               torch.stack([dx, dy], -1), 0.0)
            fl = fl + torch.clamp(step, -half, half)
        flow = fl * scale
        err_ok = err_ok & invertible

    pts_to = pts + flow
    inb = ((pts_to[:, 0] >= half) & (pts_to[:, 0] < w - half)
           & (pts_to[:, 1] >= half) & (pts_to[:, 1] < h - half))
    # residual check: mean abs photometric error of the final patch
    coords0 = _patch_coords(pts, half)
    res = torch.mean(torch.abs(bilinear_sample(img_from, coords0)
                               - bilinear_sample(img_to,
                                                 coords0 + flow[:, None, :])),
                     -1)
    status = valid & err_ok & inb & (res < 0.12)
    return pts_to, status
