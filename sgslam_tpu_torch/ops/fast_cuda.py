"""FAST-9/16 detection of a whole ORB pyramid in one CUDA kernel launch.

`orb.detect_cells` runs the plain torch version (`fast.fast_score_map`,
`fast.nms_3x3`, `fast.border_mask` and `orb.level_cells`' cell
reduction, level by level) on CPU tensors and `fast_detect_kernel` on
CUDA tensors: `csrc/fast_detect.cu`, one launch that gives every level's
per-cell best score and its first index, the plain version's to the bit.
There is no fallback from one to the other: a build or launch failure
raises. `fast_detect_kernel.launches` counts kernel launches, and
`ops/cuda_lib.py` builds, loads and launches the kernel.

The level pointers and shapes and the threshold are kernel arguments: a
call copies nothing to the device, allocates only its two outputs,
launches on the current stream and does not synchronise.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.timing import PEAKS
from .cuda_lib import CSRC, CudaKernel

MIN_CELL, MAX_CELL = 8, 32        # the kernel's tile holds a 32-pixel cell
MAX_LEVELS = 16


def cell_grid(h: int, w: int, cell: int) -> tuple:
    """(cells down, cells across) of an [h, w] level padded to whole
    cells."""
    return -(-h // cell), -(-w // cell)


def fast_detect_bound(shapes, cell: int) -> float:
    """The least time, ms, of one detection on an H100: every level's
    float32 pixels read once and the per-cell outputs (a float32 score and
    an int64 index) written once, at the published HBM rate."""
    cells = sum(a * b for a, b in (cell_grid(h, w, cell) for h, w in shapes))
    nbytes = sum(h * w for h, w in shapes) * 4 + cells * (4 + 8)
    return nbytes / PEAKS["hbm_bytes_per_s"] * 1e3


class FastDetectKernel(CudaKernel):
    """F's binding."""

    name = "FAST detection"
    source = CSRC / "fast_detect.cu"
    entries = {"sgslam_fast_detect": [ctypes.c_void_p] * 3
               + [ctypes.c_int] * 3 + [ctypes.c_float]
               + [ctypes.c_void_p] * 2}

    def __call__(self, levels, cell: int, threshold: float, margin: int):
        """(cell_score [C] f32, cell_best [C] int64): every level's cells
        in level order, each level's row-major; the levels are [h, w]
        float32 contiguous tensors on one card."""
        if not levels:
            raise ValueError("no pyramid levels")
        dev = levels[0].device
        if dev.type != "cuda":
            raise ValueError("the FAST kernel's levels must be CUDA tensors")
        if len(levels) > MAX_LEVELS:
            raise ValueError(f"{len(levels)} levels exceed the kernel's "
                             f"{MAX_LEVELS}")
        if not MIN_CELL <= cell <= MAX_CELL:
            raise ValueError(f"cell size {cell} outside the kernel's "
                             f"{MIN_CELL}-{MAX_CELL}")
        if margin < 0:
            raise ValueError(f"negative border margin {margin}")
        for lv, t in enumerate(levels):
            if t.device != dev:
                raise ValueError(f"level {lv} lies on {t.device}, not {dev}")
            if t.dtype != torch.float32:
                raise TypeError(f"level {lv} must be float32, got {t.dtype}")
            if t.dim() != 2 or t.numel() == 0:
                raise ValueError(f"level {lv} must be a non-empty [h, w], "
                                 f"got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"level {lv} must be contiguous")
        n = len(levels)
        total = sum(a * b for a, b in (cell_grid(*t.shape, cell)
                                       for t in levels))
        cell_score = torch.empty(total, dtype=torch.float32, device=dev)
        cell_best = torch.empty(total, dtype=torch.int64, device=dev)
        imgs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in levels))
        hs = (ctypes.c_int * n)(*(t.shape[0] for t in levels))
        ws = (ctypes.c_int * n)(*(t.shape[1] for t in levels))
        self.launch("sgslam_fast_detect", dev, imgs, hs, ws, n, cell, margin,
                    threshold, cell_score.data_ptr(), cell_best.data_ptr())
        return cell_score, cell_best


fast_detect_kernel = FastDetectKernel()
