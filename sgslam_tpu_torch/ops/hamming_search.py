"""K1s: the fused Hamming search — CUDA kernel and plain version.

Every association search (`matching/search.py`) reduces a masked Hamming
distance matrix per query row to its first argmin, minimum and second
minimum, and the mutual check also takes each column's first argmin.
`hamming_search` returns those four vectors. On a CUDA tensor it launches
`csrc/hamming_search.cu`, which computes the distances, the candidate mask
and the reductions in one kernel and writes nothing of size [Q, N]; on a
CPU tensor it runs the plain version, `hamming_search_reference`: the
search's torch chain as the port ran it before the kernel existed (K1's
distance matrix, then `where`, `argmin`, `amin` and `_second_min`). There
is no fallback from one to the other: a build or launch failure raises.
`hamming_search_kernel.launches` counts kernel launches, and
`ops/cuda_lib.py` builds, loads and launches the kernel.

It replaces the reductions around the TPU kernel
`sgslam_tpu/ops/pallas_hamming.py::_hamming_kernel`; K1 stays that
kernel's counterpart and is no longer on the path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils.timing import PEAKS
from .cuda_lib import CSRC, CudaKernel
from .hamming_cuda import WORDS, hamming_matrix

MAX_DIST = 256
MAX_COLS = 65535        # the kernel keys a column in 16 bits
WAVES = 2               # blocks per SM the grid reaches, where it can
# a pair's window test: two subtractions and two |.| <= r in float32, the
# levels' subtraction, |.| and compare
WINDOW_OPS = 7


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
    d = hamming_matrix(desc_q, desc_t)
    dm = torch.where(candidates(valid_q, valid_t, window), d, MAX_DIST)
    best_idx = torch.argmin(dm, dim=1)
    best = torch.amin(dm, dim=1)
    second = _second_min(dm, best_idx)
    rbest = torch.argmin(dm, dim=0) if mutual else None
    return best_idx, best, second, rbest


def search_bound(q: int, n: int, mutual: bool = False, window: bool = True,
                 n_cand: int | None = None) -> tuple:
    """(bound ms, bytes ms, ops ms) of one search on an H100: its inputs
    read and outputs written once at the published HBM rate (descriptors
    and flags; with a window the positions, radii and levels; best_idx,
    best and second, and rbest when mutual), or its operations, whichever
    takes longer. The operations: every pair's distance as 2 * 256 int8
    operations on the tensor cores; or, with a window and `n_cand` (the
    input's candidate pairs), what that input needs: every pair's window
    test (WINDOW_OPS at the float32 peak) and the candidates' distances."""
    per_q = WORDS * 4 + 1 + 8 + 4 + 4
    per_n = WORDS * 4 + 1 + (8 if mutual else 0)
    if window:
        per_q += 8 + 4 + 4
        per_n += 8 + 4
    bytes_ms = (q * per_q + n * per_n) / PEAKS["hbm_bytes_per_s"] * 1e3
    if window and n_cand is not None:
        ops_ms = (q * n * WINDOW_OPS / PEAKS["fp32_flops"]
                  + 2 * n_cand * WORDS * 32 / PEAKS["int8_ops"]) * 1e3
    else:
        ops_ms = 2 * q * n * WORDS * 32 / PEAKS["int8_ops"] * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def _card_index(t) -> int:
    """The index of the card `t` lies on (raises for any other device)."""
    i = t.get_device()
    if i < 0:
        raise ValueError("the search's tensors must be CUDA tensors")
    return i


def _ready(t, name, dtype, shape, index):
    """t as the kernel reads it: on card `index`, of `dtype` and `shape`,
    contiguous and 16-byte aligned (copied where it is not)."""
    if t.get_device() != index:
        raise ValueError(f"{name} must be a CUDA tensor on card {index}")
    if t.shape != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class HammingSearchKernel(CudaKernel):
    """K1s's binding, with each card's workspace and SM count."""

    name = "Hamming search"
    source = CSRC / "hamming_search.cu"
    entries = {"sgslam_hamming_search": [ctypes.c_void_p] * 9
               + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 7}

    def __init__(self):
        super().__init__()
        self._tile = None
        self._sms = {}
        self._ws = {}

    def check(self, lib):
        """Reads the kernel's tile, (rows, columns)."""
        for f in (lib.sgslam_hamming_search_rows,
                  lib.sgslam_hamming_search_cols):
            f.argtypes = []
            f.restype = ctypes.c_int
        self._tile = (lib.sgslam_hamming_search_rows(),
                      lib.sgslam_hamming_search_cols())

    def _workspace(self, device, words: int):
        """The device's zeroed int64 workspace of at least `words`: the
        kernel's column buffer and counters, which every launch leaves
        zeroed. Grown outside CUDA-graph capture only (so that no graph's
        pool holds it), and grow-only: a larger buffer is added and the
        earlier ones are kept, never freed, because a graph captured
        before may still launch on them. Calls that share a buffer run on
        one stream."""
        bufs = self._ws.setdefault(device.index, [])
        if not bufs or bufs[-1].numel() < words:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the Hamming search's workspace must be "
                                   "grown before a CUDA graph captures it: "
                                   "call the search once outside the graph")
            bufs.append(torch.zeros(max(words, 1 << 14), dtype=torch.int64,
                                    device=device))
        return bufs[-1]

    def splits(self, device, q: int, n: int) -> int:
        """Column splits of the grid: enough for WAVES blocks per SM
        where the columns allow it."""
        rows, cols = self._tile
        if device.index not in self._sms:
            self._sms[device.index] = torch.cuda.get_device_properties(
                device).multi_processor_count
        row_tiles, n_tiles = -(-q // rows), -(-n // cols)
        want = -(-WAVES * self._sms[device.index] // row_tiles)
        return max(1, min(n_tiles, want))

    def __call__(self, desc_q, valid_q, desc_t, valid_t,
                 window: Window | None = None, mutual: bool = False):
        q, n = desc_q.shape[0], desc_t.shape[0]
        if not 0 < n <= MAX_COLS:
            raise ValueError(f"{n} columns: the kernel takes 1 to "
                             f"{MAX_COLS}")
        dev, i = desc_q.device, _card_index(desc_q)
        args = [_ready(desc_q, "desc_q", torch.int32, (q, WORDS), i),
                _ready(valid_q, "valid_q", torch.bool, (q,), i),
                _ready(desc_t, "desc_t", torch.int32, (n, WORDS), i),
                _ready(valid_t, "valid_t", torch.bool, (n,), i)]
        if window is None:
            args += [None] * 5
            level_window = 0
        else:
            w = window
            args += [_ready(w.proj_uv, "proj_uv", torch.float32, (q, 2), i),
                     _ready(w.r, "r", torch.float32, (q,), i),
                     _ready(w.pred_level, "pred_level", torch.int32, (q,), i),
                     _ready(w.feat_xy, "feat_xy", torch.float32, (n, 2), i),
                     _ready(w.feat_level, "feat_level", torch.int32, (n,), i)]
            level_window = int(w.level_window)
        best_idx = torch.empty(q, dtype=torch.int64, device=dev)
        best = torch.empty(q, dtype=torch.int32, device=dev)
        second = torch.empty(q, dtype=torch.int32, device=dev)
        rbest = (torch.empty(n, dtype=torch.int64, device=dev) if mutual
                 else None)
        if q == 0:
            if mutual:
                raise ValueError("a mutual search needs at least one row")
            return best_idx, best, second, rbest
        self.load()
        rows = self._tile[0]
        if -(-q // rows) > 65535:     # grid.y counts row tiles
            raise ValueError(f"{q} rows exceed the kernel's grid")
        splits = self.splits(dev, q, n)
        partials = (torch.empty((splits, q), dtype=torch.int64, device=dev)
                    if splits > 1 else None)
        colbuf = counters = None
        if mutual or splits > 1:
            n_col = n if mutual else 0
            colbuf = self._workspace(dev, n_col + -(-q // rows) // 2 + 1
                                     ).data_ptr()
            counters = colbuf + 8 * n_col
        ptr = [None if t is None else t.data_ptr() for t in args]
        self.launch("sgslam_hamming_search", dev, *ptr, level_window, q, n,
                    splits, int(mutual), best_idx.data_ptr(),
                    best.data_ptr(), second.data_ptr(),
                    None if rbest is None else rbest.data_ptr(),
                    None if partials is None else partials.data_ptr(),
                    colbuf, counters)
        return best_idx, best, second, rbest


hamming_search_kernel = HammingSearchKernel()


def hamming_search(desc_q, valid_q, desc_t, valid_t,
                   window: Window | None = None, mutual: bool = False):
    """(best_idx [Q] i64, best [Q] i32, second [Q] i32, rbest [N] i64 or
    None) of the masked search. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if desc_q.device.type == "cpu" and desc_t.device.type == "cpu":
        return hamming_search_reference(desc_q, valid_q, desc_t, valid_t,
                                        window, mutual)
    return hamming_search_kernel(desc_q, valid_q, desc_t, valid_t, window,
                                 mutual)
