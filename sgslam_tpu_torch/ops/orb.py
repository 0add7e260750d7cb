"""ORB feature extraction: pyramid FAST + IC_Angle orientation + rBRIEF.

Port of `sgslam_tpu/ops/orb.py`. Per pyramid level: dense FAST score, strict
NMS, per-cell argmax and a per-level top-k of cells, then the
intensity-centroid angle on the raw level and 256 rotated-BRIEF tests on the
7x7-blurred level. On the card the detection up to the per-cell argmax is
one kernel launch for all levels (`detect_cells`, `ops/fast_cuda.py`). The
output is a fixed-capacity `Features` set with a validity mask, as in the
reference.

Two rules keep the selected keypoints identical to the reference's:
  * `lax.top_k` breaks ties toward the lower index; `torch.topk` promises no
    order among ties, so the top-k here is a stable descending sort, sliced.
  * `argmax` takes the first maximum in both frameworks.
Descriptors are held as int32 [N, 8], a bit-cast of the reference's uint32
words: torch has no uint32 shift on the CPU. The words are packed in int64
and wrapped to int32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import OrbConfig
from ..geometry.camera import Camera, undistort_points
from ..utils import timing
from . import fast as fast_mod
from . import image as image_mod
from .fast_cuda import cell_grid, fast_detect_kernel
from .pattern import DESC_WORDS, PATCH_HALF, PATTERN, ROT_PATCH_HALF

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


def level_cells(img_l, cell: int, threshold: float):
    """One level's cells, plain: (cell_score [ncy*ncx] f32, cell_best
    [ncy*ncx] int64), the max of the level's NMS'd, border-masked FAST
    score over each `cell` x `cell` cell (the level padded with zeros to
    whole cells) and the row-major index in the cell of its first maximum.
    """
    h, w = img_l.shape
    score = fast_mod.fast_score_map(img_l, threshold)
    score = fast_mod.nms_3x3(score)
    score = score * fast_mod.border_mask(h, w, EDGE_MARGIN, score.dtype,
                                         img_l.device)
    ncy, ncx = cell_grid(h, w, cell)
    sp = torch.nn.functional.pad(score, (0, ncx * cell - w, 0, ncy * cell - h))
    cells = sp.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, cell * cell)
    return torch.amax(cells, dim=1), torch.argmax(cells, dim=1)


def detect_cells(levels, cell: int, threshold: float):
    """Every level's cells (`level_cells`), concatenated in level order.

    CPU tensors take the plain version (`detect_cells_reference`); CUDA
    tensors launch `csrc/fast_detect.cu` once for the whole pyramid, or
    raise. The tracer counts `fast.calls` and, of those, `fast.kernel`."""
    tr = timing.active()
    tr.count("fast.calls")
    if levels[0].device.type == "cpu":
        return detect_cells_reference(levels, cell, threshold)
    out = fast_detect_kernel(levels, cell, threshold, EDGE_MARGIN)
    tr.count("fast.kernel")
    return out


def detect_cells_reference(levels, cell: int, threshold: float):
    """The plain body of `detect_cells`, `level_cells` level by level, as
    torch ops on any device (on a card, about 236 launches a level)."""
    per = [level_cells(img_l, cell, threshold) for img_l in levels]
    return torch.cat([s for s, _ in per]), torch.cat([b for _, b in per])


def _select_level(cell_score, cell_best, ncx: int, budget: int, cell: int):
    """One level's cells -> (xy_l [budget,2] f32 level coords, score): the
    `budget` best cells, ties toward the lower cell, padded with zeros."""
    dev = cell_score.device
    k = min(budget, cell_score.shape[0])
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
    img = img.to(torch.float32).contiguous()
    dev = img.device
    levels = image_mod.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    budgets = level_budgets(cfg)
    cell = cfg.cell_size
    cell_score, cell_best = detect_cells(levels, cell,
                                         cfg.fast_min_threshold / 255.0)

    xs, ss, lv_ids, angs, descs = [], [], [], [], []
    first = 0
    for lv, (img_l, budget) in enumerate(zip(levels, budgets)):
        ncy, ncx = cell_grid(*img_l.shape, cell)
        cells = slice(first, first + ncy * ncx)
        first = cells.stop
        xy_l, score = _select_level(cell_score[cells], cell_best[cells], ncx,
                                    budget, cell)
        centers = torch.round(xy_l).to(torch.int64)
        # orientation on the raw level image
        ang = _ic_angle(image_mod.gather_patches(img_l, centers, PATCH_HALF))
        # descriptors on the blurred level image
        img_b = image_mod.gaussian_blur(img_l, 7, 2.0)
        pat39 = image_mod.gather_patches(img_b, centers, ROT_PATCH_HALF)
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
