"""ORB extraction with its RGB-D depth lookup: `sgslam_tpu_torch/ops/{pattern,image,fast,orb}.py`
and `slam/tracking.py:extract_frame`; its stereo frame construction,
`slam/tracking.py:extract_frame_stereo`, with the SAD search of
`stereo.py`.

Frozen copy of the files named above as of commit 1275b16, with
their imports pointed at this folder. It imports nothing of the
program.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .camera import undistort_points


PATCH_HALF = 15          # orientation patch radius (IC_Angle)
PATTERN_RADIUS = 13      # max |coordinate| of a pattern point
DESC_BITS = 256
DESC_WORDS = 8           # uint32 words per descriptor
# A rotated pattern point has radius <= 13*sqrt(2) ~ 18.4 -> patches of
# radius 19 cover every rotation (this is why the reference uses
# EDGE_THRESHOLD=19).
ROT_PATCH_HALF = 19


def make_pattern(seed: int = 42):
    """Returns int32 [256, 4] rows (x1, y1, x2, y2)."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_HALF + 1) / 5.0
    pts = rng.normal(scale=sigma, size=(DESC_BITS, 4))
    pts = np.clip(np.round(pts), -PATTERN_RADIUS, PATTERN_RADIUS)
    return pts.astype(np.int32)


PATTERN = make_pattern()


def gaussian_kernel_1d(ksize: int, sigma: float, dtype=torch.float32,
                       device=None):
    r = (ksize - 1) / 2
    x = torch.arange(ksize, dtype=dtype, device=device) - r
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / torch.sum(k)


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur, replicate padding. img: [H, W] float32.

    The same shift-multiply-accumulate as the reference (its order of
    additions), so the two packages blur to within f32 rounding; no cuDNN
    convolution, whose TF32 default would cost three decimal digits."""
    k = gaussian_kernel_1d(ksize, sigma, img.dtype, img.device)
    r = ksize // 2
    h, w = img.shape

    def conv_axis(x, axis):
        n = x.shape[axis]
        acc = None
        for i in range(ksize):
            idx = torch.clamp(torch.arange(n, device=x.device) + (i - r),
                              0, n - 1)
            term = x.index_select(axis, idx) * k[i]
            acc = term if acc is None else acc + term
        return acc

    return conv_axis(conv_axis(img, 0), 1)


@functools.lru_cache(maxsize=64)
def _resize_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 antialiased triangle-kernel weights, the
    `compute_weight_mat` of `jax.image.resize` for scale n_out/n_in."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    out_idx = np.arange(n_out, dtype=f32)
    # (i + 0.5) * inv_scale - 0.5, rounded once (fused multiply-add)
    sample = ((out_idx.astype(np.float64) + 0.5)
              * np.float64(f32(inv_scale)) - 0.5).astype(f32)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    x = dist * (f32(1.0) / f32(kernel_scale))
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = np.zeros((1, n_out), f32)
    for row in w:      # row-sequential; XLA sums in blocks of 32 (an ulp)
        total = total + row
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, device: torch.device):
    return torch.from_numpy(_resize_weights_np(n_in, n_out)).to(device)


def resize_bilinear(img, h: int, w: int):
    """cv::resize(INTER_LINEAR)-style downscale. img: [H, W] float32."""
    wh = _resize_weights(img.shape[0], h, img.device)   # [H, h]
    ww = _resize_weights(img.shape[1], w, img.device)   # [W, w]
    return (wh.T @ img) @ ww


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static per-level (h, w) like ORBextractor::ComputePyramid
    (ORBextractor.cc:1108-1133)."""
    shapes = []
    for lv in range(n_levels):
        s = 1.0 / (scale ** lv)
        shapes.append((int(round(h * s)), int(round(w * s))))
    return tuple(shapes)


def build_pyramid(img, n_levels: int, scale: float):
    """Tuple of per-level images (level 0 = input)."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [img]
    for lv in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], *shapes[lv]))
    return tuple(levels)


def gather_patches(img, centers, radius: int):
    """Gather square patches around integer centers.

    img: [H, W]; centers: [N, 2] int (x, y). Returns [N, 2r+1, 2r+1].
    Centers are clamped so the patch stays in bounds, as in the reference.
    """
    h, w = img.shape
    size = 2 * radius + 1
    cx = torch.clamp(centers[:, 0] - radius, 0, w - size)
    cy = torch.clamp(centers[:, 1] - radius, 0, h - size)
    off = torch.arange(size, device=img.device)
    rows = cy[:, None, None] + off[None, :, None]          # [N, size, 1]
    cols = cx[:, None, None] + off[None, None, :]          # [N, 1, size]
    return img.reshape(-1)[(rows * w + cols).reshape(-1)].reshape(
        -1, size, size)


def max_pool_3x3(x):
    """3x3 max filter (same shape) of an [H, W] image, padded with -inf
    (the reference's `reduce_window` with SAME padding)."""
    return torch.nn.functional.max_pool2d(x[None, None], 3, stride=1,
                                          padding=1)[0, 0]


def bilinear_sample(img, xy):
    """Sample img [H,W] at float coords xy [...,2] with bilinear interp.

    Out-of-bounds clamps to border. Used by LK flow."""
    h, w = img.shape
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


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


EDGE_MARGIN = ROT_PATCH_HALF  # = 19, the reference's EDGE_THRESHOLD


@dataclasses.dataclass
class Features:
    """Fixed-capacity per-frame feature set."""

    xy: torch.Tensor        # [N,2] f32 undistorted level-0 pixel coords
    xy_raw: torch.Tensor    # [N,2] f32 raw (distorted) level-0 pixel coords
    response: torch.Tensor  # [N] f32 FAST score
    angle: torch.Tensor     # [N] f32 radians
    level: torch.Tensor     # [N] i32 pyramid level
    desc: torch.Tensor      # [N,8] i32 packed 256-bit rBRIEF (uint32 bits)
    depth: torch.Tensor     # [N] f32 meters; <=0 invalid
    u_right: torch.Tensor   # [N] f32 pseudo-stereo right coord; <0 invalid
    valid: torch.Tensor     # [N] bool

    @property
    def capacity(self):
        return self.xy.shape[-2]

    def to(self, device) -> "Features":
        return Features(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})


def topk_stable(x, k: int):
    """(values, indices) of the k largest entries of a 1-D tensor, ties
    broken toward the lower index — the order of `lax.top_k`."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def level_budgets(cfg: OrbConfig):
    """Geometric per-level feature budget (ORBextractor.cc:436-447)."""
    inv = 1.0 / cfg.scale_factor
    total = cfg.n_features
    w = np.array([inv ** l for l in range(cfg.n_levels)])
    w = w / w.sum()
    budgets = np.floor(total * w).astype(int)
    budgets[0] += total - budgets.sum()
    return tuple(int(b) for b in budgets)


def _detect_level(img_l, budget: int, cell: int, threshold: float):
    """One pyramid level -> (xy_l [budget,2] f32 level coords, score)."""
    h, w = img_l.shape
    dev = img_l.device
    score = fast_score_map(img_l, threshold)
    score = nms_3x3(score)
    score = score * border_mask(h, w, EDGE_MARGIN, score.dtype, dev)

    ncy = -(-h // cell)
    ncx = -(-w // cell)
    sp = torch.nn.functional.pad(score, (0, ncx * cell - w, 0, ncy * cell - h))
    cells = sp.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, cell * cell)
    cell_best = torch.argmax(cells, dim=1)
    cell_score = torch.amax(cells, dim=1)

    k = min(budget, ncy * ncx)
    top_score, top_cell = topk_stable(cell_score, k)
    by = top_cell // ncx
    bx = top_cell % ncx
    iy = cell_best[top_cell] // cell
    ix = cell_best[top_cell] % cell
    x = (bx * cell + ix).to(torch.float32)
    y = (by * cell + iy).to(torch.float32)
    if k < budget:  # tiny level: pad to static budget
        zeros = torch.zeros(budget - k, dtype=torch.float32, device=dev)
        x = torch.cat([x, zeros])
        y = torch.cat([y, zeros])
        top_score = torch.cat([top_score, zeros])
    return torch.stack([x, y], dim=-1), top_score


def _ic_angle(patches):
    """Intensity-centroid orientation (IC_Angle, ORBextractor.cc:78-105).

    patches: [N, 31, 31] raw-intensity patches centered on keypoints.
    """
    r = PATCH_HALF
    rng = torch.arange(-r, r + 1, device=patches.device)
    ys, xs = torch.meshgrid(rng, rng, indexing="ij")
    circ = (xs * xs + ys * ys) <= r * r
    wx = torch.where(circ, xs, 0).to(patches.dtype)
    wy = torch.where(circ, ys, 0).to(patches.dtype)
    m10 = torch.einsum("nhw,hw->n", patches, wx)
    m01 = torch.einsum("nhw,hw->n", patches, wy)
    return torch.atan2(m01, m10)


def pack_bits(bits):
    """[N, 256] {0,1} int64 -> [N, 8] int32 words, bit b of word w is test
    32*w + b; the words carry the reference's uint32 bit patterns."""
    n = bits.shape[0]
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = torch.sum(bits.reshape(n, DESC_WORDS, 32) << shifts, dim=-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def _descriptors(patches, angles):
    """Rotated-BRIEF descriptors from blurred patches.

    patches: [N, 39, 39] blurred patches; angles: [N] radians.
    Returns int32 [N, 8].
    """
    n = patches.shape[0]
    size = 2 * ROT_PATCH_HALF + 1
    pat = torch.as_tensor(PATTERN, device=patches.device).to(torch.float32)
    a = torch.cos(angles)[:, None]  # [N,1]
    b = torch.sin(angles)[:, None]
    px1, py1, px2, py2 = (pat[None, :, i] for i in range(4))
    # OpenCV rotation convention: row = round(x sin + y cos),
    # col = round(x cos - y sin)
    r1 = torch.round(px1 * b + py1 * a).to(torch.int64) + ROT_PATCH_HALF
    c1 = torch.round(px1 * a - py1 * b).to(torch.int64) + ROT_PATCH_HALF
    r2 = torch.round(px2 * b + py2 * a).to(torch.int64) + ROT_PATCH_HALF
    c2 = torch.round(px2 * a - py2 * b).to(torch.int64) + ROT_PATCH_HALF

    flat = patches.reshape(n, size * size)
    v1 = torch.gather(flat, 1, r1 * size + c1)
    v2 = torch.gather(flat, 1, r2 * size + c2)
    return pack_bits((v1 < v2).to(torch.int64))


def extract(img, cfg: OrbConfig, cam: Camera) -> Features:
    """Full ORB extraction on one grayscale image [H, W] float32, on the
    image's device."""
    img = img.to(torch.float32)
    dev = img.device
    levels = build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    budgets = level_budgets(cfg)

    xs, ss, lv_ids, angs, descs = [], [], [], [], []
    for lv, (img_l, budget) in enumerate(zip(levels, budgets)):
        xy_l, score = _detect_level(img_l, budget, cfg.cell_size,
                                    cfg.fast_min_threshold / 255.0)
        centers = torch.round(xy_l).to(torch.int64)
        # orientation on the raw level image
        ang = _ic_angle(gather_patches(img_l, centers, PATCH_HALF))
        # descriptors on the blurred level image
        img_b = gaussian_blur(img_l, 7, 2.0)
        pat39 = gather_patches(img_b, centers, ROT_PATCH_HALF)
        descs.append(_descriptors(pat39, ang))
        xs.append(xy_l * (cfg.scale_factor ** lv))
        ss.append(score)
        lv_ids.append(torch.full((budget,), lv, dtype=torch.int32,
                                 device=dev))
        angs.append(ang)

    xy_raw = torch.cat(xs)
    response = torch.cat(ss)
    level = torch.cat(lv_ids)
    angle = torch.cat(angs)
    desc = torch.cat(descs)
    valid = response > 0.0

    # pad to static capacity
    n = xy_raw.shape[0]
    cap = cfg.max_keypoints
    if n < cap:
        p = cap - n

        def pad(x, value=0):
            return torch.cat([x, torch.full((p,) + x.shape[1:], value,
                                            dtype=x.dtype, device=dev)])

        xy_raw, response, level, angle, desc = (
            pad(xy_raw), pad(response), pad(level), pad(angle), pad(desc))
        valid = pad(valid, False)

    xy_und = undistort_points(cam, xy_raw)
    neg = torch.full((cap,), -1.0, dtype=torch.float32, device=dev)
    return Features(xy=xy_und, xy_raw=xy_raw, response=response, angle=angle,
                    level=level, desc=desc, depth=neg, u_right=neg.clone(),
                    valid=valid)


def attach_rgbd(feats: Features, depth_map, cam: Camera) -> Features:
    """RGB-D pseudo-stereo: per-keypoint depth + virtual right coord.

    Contract of Frame::ComputeStereoFromRGBD (Frame.cc:893-914): depth is
    looked up at the raw keypoint pixel; u_right = u - bf/d for valid depth.
    """
    h, w = depth_map.shape
    xi = torch.clamp(torch.round(feats.xy_raw[:, 0]).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(feats.xy_raw[:, 1]).to(torch.int64), 0, h - 1)
    d = depth_map[yi, xi]
    ok = (d > 0) & feats.valid
    u_right = torch.where(ok, feats.xy[:, 0] - cam.bf / torch.clamp(d, min=1e-6),
                          -1.0)
    depth = torch.where(ok, d, -1.0)
    return dataclasses.replace(feats, depth=depth, u_right=u_right)


def scale_factors(cfg: OrbConfig):
    """The pyramid's scale factor of every level, scale_factor ** level."""
    return tuple(cfg.scale_factor ** lv for lv in range(cfg.n_levels))


def extract_frame(cfg, gray, depth):
    """ORB extraction + RGB-D depth lookup for one frame on gray's
    device (`tracking.extract_frame`)."""
    feats = extract(gray, cfg.orb, cfg.camera)
    return attach_rgbd(feats, depth.to(torch.float32), cfg.camera)


def extract_frame_stereo(cfg, gray_l, gray_r):
    """ORB extraction on the left image + the rectified epipolar SAD
    search in the right one, on gray_l's device
    (`tracking.extract_frame_stereo`)."""
    from .stereo import attach_stereo

    gray_l = gray_l.to(torch.float32)
    feats = extract(gray_l, cfg.orb, cfg.camera)
    return attach_stereo(cfg.camera, feats, gray_l,
                         gray_r.to(gray_l.device, torch.float32))
