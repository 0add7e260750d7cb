"""Deterministic segment sums: the port's one float scatter-add.

`segment_sum(values, index, n, init)` adds the rows of `values` that share
an index onto `init` (zeros by default), in a fixed order; rows whose index
lies outside [0, n) are dropped, as the reference's `mode="drop"` scatters
drop them.

Why: a float `index_add_` or `index_put_(accumulate=True)` on a CUDA tensor
sums through atomics, in an order that changes from launch to launch, so a
whole run on the card did not repeat itself; XLA's scatters (the
reference's) do. On the card the wrapper launches `csrc/segment_sum.cu`,
which sorts the kept rows by index (a stable radix sort over the
`key_bits(n)` bits the indices have) and writes each output row once; on
the CPU the plain version, `segment_sum_reference`, adds in the kernel's
order op for op, so the kernel, its plain version and any two launches
agree to the bit. The order: a segment of at most `LONG` rows (every
segment of the BA and the pose graph) is added row after row onto `init`,
as `index_add_` adds it; a longer one (the occupancy voxels that every ray
samples, dense voxels, a camera's observations) as `BLOCK` strided
partial sums from zero, halved in a fixed tree and then added to `init`,
so that the card sums it in parallel. A wrapper takes the plain version
only for a tensor on the CPU, and for a CUDA tensor launches the kernel or
raises. `segment_kernel.launches` counts kernel launches, and
`ops/cuda_lib.py` builds, loads and launches the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.timing import PEAKS
from .cuda_lib import CSRC, CudaKernel

_FLOATS = {torch.float32: "f32", torch.float64: "f64"}
LONG = 256      # a longer segment is summed by a block (the kernel's kLong)
BLOCK = 256     # the partial sums of such a segment (the kernel's kBlock)


def _check(values, index, n, init):
    """The output's shape, after checking the arguments."""
    if values.dim() == 0 or index.dim() != 1 or \
            index.shape[0] != values.shape[0]:
        raise ValueError(f"values {tuple(values.shape)} and index "
                         f"{tuple(index.shape)} must share their first axis")
    if index.dtype.is_floating_point or index.dtype == torch.bool:
        raise TypeError(f"index must be an integer tensor, not {index.dtype}")
    shape = (n,) + tuple(values.shape[1:])
    if init is not None and (tuple(init.shape) != shape
                             or init.dtype != values.dtype):
        raise ValueError(f"init {tuple(init.shape)} {init.dtype} must be "
                         f"{shape} {values.dtype}")
    return shape


def _prepare(values, index, n, init):
    shape = _check(values, index, n, init)
    if init is None:
        return torch.zeros(shape, dtype=values.dtype, device=values.device)
    return init.clone(memory_format=torch.contiguous_format)


def key_bits(n: int) -> int:
    """Bits of the kernel's sort keys, the kept indices in [0, n): at least
    1, else ceil(log2(n))."""
    return max(1, (int(n) - 1).bit_length())


def segment_sum_reference(values, index, n: int, init=None):
    """Plain version, in the kernel's order: `index_add_` (sequential on
    the CPU) of the rows of segments of at most LONG rows; row k of a
    longer segment goes to partial sum k % BLOCK (from zero, in order), the
    partial sums are halved in a fixed tree, and the total is added to
    init."""
    out = _prepare(values, index, n, init)
    idx = index.to(torch.int64)
    keep = (idx >= 0) & (idx < n)
    if not bool(keep.any()):
        return out
    counts = torch.bincount(idx[keep], minlength=n)
    long_row = keep & (counts[idx.clamp(0, n - 1)] > LONG)
    short = keep & ~long_row
    out.index_add_(0, idx[short], values[short])
    if not bool(long_row.any()):
        return out
    cols = values[0].numel()
    key, order = torch.sort(idx[long_row], stable=True)
    vals = values[long_row].reshape(-1, cols)[order]
    segs, sizes = torch.unique_consecutive(key, return_counts=True)
    rank = torch.repeat_interleave(
        torch.arange(len(segs), device=idx.device), sizes)
    start = torch.cumsum(sizes, 0) - sizes
    pos = torch.arange(len(key), device=idx.device) - start[rank]
    part = torch.zeros((len(segs) * BLOCK, cols), dtype=values.dtype,
                       device=values.device)
    part.index_add_(0, rank * BLOCK + pos % BLOCK, vals)
    part = part.reshape(len(segs), BLOCK, cols)
    h = BLOCK // 2
    while h:
        part = torch.cat([part[:, :h] + part[:, h:2 * h], part[:, 2 * h:]], 1)
        h //= 2
    flat = out.view(n, cols)
    flat[segs] = flat[segs] + part[:, 0]
    return out


def segment_bound(values, index, n: int, init) -> tuple:
    """(bound ms, bytes ms, adds ms) of one segment sum on an H100: the
    kept rows' values, every row's index and the output (and init) moved
    once each at the published HBM rate, or one add per kept value at the
    published float32 rate, whichever takes longer. A dropped row's value
    is never needed."""
    cols = values[0].numel() if values.shape[0] else 1
    kept = int(((index >= 0) & (index < n)).sum())
    size = values.element_size()
    nbytes = (kept * cols * size + index.shape[0] * index.element_size()
              + n * cols * size * (2 if init is not None else 1))
    bytes_ms = nbytes / PEAKS["hbm_bytes_per_s"] * 1e3
    ops_ms = kept * cols / PEAKS["fp32_flops"] * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


class SegmentSumKernel(CudaKernel):
    """S's binding: one entry point per float type, and the entry point
    that sizes a call's scratch."""

    name = "segment-sum kernel"
    source = CSRC / "segment_sum.cu"
    entries = {f"sgslam_segment_sum_{tag}": [ctypes.c_int]
               + [ctypes.c_void_p] * 2 + [ctypes.c_int]
               + [ctypes.c_void_p] * 2
               + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                  ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
               for tag in _FLOATS.values()}

    def __init__(self):
        super().__init__()
        self._scratch = None

    def check(self, lib):
        """Refuses a library that sums in another order than the plain
        version, and binds the scratch-size entry point."""
        if (lib.sgslam_segment_sum_long(),
                lib.sgslam_segment_sum_block()) != (LONG, BLOCK):
            raise RuntimeError(f"{self.source.name} sums segments in "
                               "another order than its plain version")
        scratch = lib.sgslam_segment_sum_scratch
        scratch.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                            ctypes.c_int64, ctypes.c_int]
        scratch.restype = ctypes.c_int64
        self._scratch = scratch

    def __call__(self, values, index, n: int, init=None):
        if not (values.is_cuda and index.is_cuda):
            raise ValueError("values and index must be CUDA tensors")
        if values.device != index.device or (
                init is not None and init.device != values.device):
            raise ValueError("values, index and init lie on different "
                             "devices")
        if values.dtype not in _FLOATS:
            raise TypeError(f"values must be float32 or float64, not "
                            f"{values.dtype}")
        shape = _check(values, index, n, init)
        rows = values.shape[0]
        cols = values[0].numel() if rows else 1
        if rows == 0 or cols == 0 or n == 0:
            return _prepare(values, index, n, init)
        vals = values.reshape(rows, cols).contiguous()
        if index.dtype not in (torch.int32, torch.int64):
            index = index.to(torch.int64)
        idx = index.contiguous()
        start = None if init is None else init.contiguous()
        self.load()
        bits = key_bits(n)
        nbytes = self._scratch(rows, cols, vals.element_size(), n, bits)
        if nbytes < 0:
            raise ValueError(f"the segment-sum kernel takes fewer than 2^30 "
                             f"rows of at most 65535 columns onto fewer than "
                             f"2^31 rows, not {rows} x {cols} onto {n}")
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=values.device)
        out = torch.empty(shape, dtype=values.dtype, device=values.device)
        self.launch(f"sgslam_segment_sum_{_FLOATS[values.dtype]}",
                    values.device, values.device.index, vals.data_ptr(),
                    idx.data_ptr(), idx.element_size(),
                    None if start is None else start.data_ptr(),
                    out.data_ptr(), rows, cols, n, bits, scratch.data_ptr(),
                    nbytes)
        return out


segment_kernel = SegmentSumKernel()


def segment_sum(values, index, n: int, init=None):
    """values [R, ...] float, index [R] int -> [n, ...]: `init` (default
    zeros) plus, for each s in [0, n), the rows r with index[r] == s, added
    in the order of the module's docstring. Indices outside [0, n) are
    dropped. The same bits on every launch, and on the card as on the
    CPU."""
    if values.device.type == "cpu" and index.device.type == "cpu":
        return segment_sum_reference(values, index, n, init)
    return segment_kernel(values, index, n, init)
