"""Visualization exporters: per-frame keypoint/box overlays, top-down map
renders, and occupancy-grid images, written as PNGs through `io/native`.

Own copy of `sgslam_tpu/viz.py` for the port (the observable role of the
reference's FrameDrawer / MapDrawer windows as file artifacts). Drawing is
numpy on the host; tensors (on any device) are copied to the host first.
"""

from __future__ import annotations

import numpy as np
import torch

from .io import native


def to_numpy(x) -> np.ndarray:
    """A host numpy array of a tensor (on any device) or an array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# keypoint/box palette (RGB)
COLOR_KP = (0, 255, 80)          # tracked keypoint: green
COLOR_KP_CULLED = (255, 60, 40)  # dynamic-culled keypoint: red
COLOR_BOX_PERSON = (255, 160, 0)
COLOR_BOX_OBJECT = (60, 160, 255)
COLOR_TRAJ = (255, 220, 0)


def _to_rgb(gray) -> np.ndarray:
    g = to_numpy(gray)
    if g.dtype != np.uint8:
        g = np.clip(g * 255.0, 0, 255).astype(np.uint8)
    if g.ndim == 2:
        g = np.repeat(g[..., None], 3, axis=-1)
    return g.copy()


def _draw_square(img, x, y, color, r: int = 1):
    h, w = img.shape[:2]
    x0, x1 = max(int(x) - r, 0), min(int(x) + r + 1, w)
    y0, y1 = max(int(y) - r, 0), min(int(y) + r + 1, h)
    img[y0:y1, x0:x1] = color


def _draw_rect(img, x1, y1, x2, y2, color, t: int = 1):
    h, w = img.shape[:2]
    x1, x2 = sorted((int(max(x1, 0)), int(min(x2, w - 1))))
    y1, y2 = sorted((int(max(y1, 0)), int(min(y2, h - 1))))
    img[y1:y1 + t, x1:x2 + 1] = color
    img[max(y2 - t + 1, 0):y2 + 1, x1:x2 + 1] = color
    img[y1:y2 + 1, x1:x1 + t] = color
    img[y1:y2 + 1, max(x2 - t + 1, 0):x2 + 1] = color


def draw_frame(gray, xy=None, valid=None, culled=None, person_boxes=None,
               object_boxes=None) -> np.ndarray:
    """FrameDrawer::DrawFrame contract: keypoint overlay (+ detector boxes).

    xy: [N,2] keypoint pixel coords; valid: [N] bool; culled: [N] bool marks
    dynamic-rejected keypoints (drawn red); boxes are `Boxes`.
    """
    img = _to_rgb(gray)
    if xy is not None:
        xy = to_numpy(xy)
        valid = (np.ones(len(xy), bool) if valid is None
                 else to_numpy(valid))
        culled = (np.zeros(len(xy), bool) if culled is None
                  else to_numpy(culled))
        for i in range(len(xy)):
            if valid[i]:
                _draw_square(img, xy[i, 0], xy[i, 1], COLOR_KP)
            elif culled[i]:
                _draw_square(img, xy[i, 0], xy[i, 1], COLOR_KP_CULLED)
    for boxes, color in ((person_boxes, COLOR_BOX_PERSON),
                         (object_boxes, COLOR_BOX_OBJECT)):
        if boxes is None:
            continue
        bx = to_numpy(boxes.xyxy)
        bv = to_numpy(boxes.valid)
        for b, ok in zip(bx, bv):
            if ok:
                _draw_rect(img, b[0], b[1], b[2], b[3], color)
    return img


def save_frame(path: str, *args, **kwargs) -> None:
    native.png_write(path, draw_frame(*args, **kwargs))


def draw_map_topdown(m, size: int = 512, margin: float = 0.5,
                     trajectory_cw=None) -> np.ndarray:
    """MapDrawer contract, top-down: map points (white) + keyframe centers
    (yellow) projected to the world x-z plane."""
    from .geometry import se3

    def centers_of(poses_cw):
        return se3.se3_inverse(
            torch.as_tensor(to_numpy(poses_cw)))[..., 4:7].numpy()

    pts = to_numpy(m.pt_pos)[to_numpy(m.pt_valid)]
    centers = centers_of(to_numpy(m.kf_pose)[to_numpy(m.kf_valid)])
    all_xz = np.concatenate([pts[:, [0, 2]], centers[:, [0, 2]]]) \
        if len(pts) or len(centers) else np.zeros((1, 2))
    lo = all_xz.min(0) - margin
    hi = all_xz.max(0) + margin
    scale = (size - 1) / max(float((hi - lo).max()), 1e-6)

    img = np.zeros((size, size, 3), np.uint8)

    def to_px(xz):
        p = (xz - lo) * scale
        return np.clip(p.astype(int), 0, size - 1)

    for p in to_px(pts[:, [0, 2]]) if len(pts) else []:
        img[size - 1 - p[1], p[0]] = (220, 220, 220)
    for c in to_px(centers[:, [0, 2]]) if len(centers) else []:
        _draw_square(img, c[0], size - 1 - c[1], COLOR_TRAJ, r=2)
    if trajectory_cw is not None and len(trajectory_cw):
        tr = centers_of(trajectory_cw)
        for c in to_px(tr[:, [0, 2]]):
            img[size - 1 - c[1], c[0]] = (255, 120, 0)
    return img


def save_map_topdown(path: str, m, **kwargs) -> None:
    native.png_write(path, draw_map_topdown(m, **kwargs))


def occupancy_to_image(logodds_2d: np.ndarray) -> np.ndarray:
    """2-D occupancy (log-odds, down-projected) -> grayscale PNG image:
    white free, black occupied, gray unknown (octomap_server's 2-D map
    convention)."""
    lo = to_numpy(logodds_2d)
    img = np.full(lo.shape, 128, np.uint8)
    img[lo < -0.2] = 255
    img[lo > 0.2] = 0
    return img


def save_occupancy(path: str, logodds_2d) -> None:
    native.png_write(path, occupancy_to_image(logodds_2d))
