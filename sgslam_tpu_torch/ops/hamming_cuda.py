"""K1: the 256-bit Hamming distance matrix — CUDA kernel and plain version.

The CUDA kernel (`csrc/hamming.cu`) replaces the TPU's Pallas kernel
`sgslam_tpu/ops/pallas_hamming.py::_hamming_kernel`; `ops/cuda_lib.py`
builds, loads, launches and counts it.

`hamming_matrix(a, b)` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. There is no fallback from
one to the other. `hamming_kernel.launches` counts kernel launches. The
association searches do not call it on the card: each is one launch of the
fused search (`ops/hamming_search.py`), whose plain version calls it.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.timing import PEAKS
from .cuda_lib import CSRC, CudaKernel

WORDS = 8


def _popcount32(x):
    """SWAR popcount of int64 tensors holding values in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matrix_reference(a, b):
    """Plain torch version: a [N,8], b [M,8] int32 -> [N,M] int32.

    Loops over the 8 words so that no [N,M,8] tensor exists; each XOR is
    masked to 32 bits in int64, where shifts are logical."""
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64,
                      device=a.device)
    for w in range(WORDS):
        x = (a[:, w, None].to(torch.int64) ^ b[None, :, w].to(torch.int64))
        out += _popcount32(x & 0xFFFFFFFF)
    return out.to(torch.int32)


def unpack_bits(x):
    """[K,8] int32 words -> [K,256] float32 {0,1} bits: the input of the
    library call for the same function, `torch.cdist(bits_a, bits_b,
    p=0)`, which timing sets beside K1."""
    shifts = torch.arange(32, device=x.device, dtype=torch.int64)
    bits = (x.to(torch.int64)[:, :, None] >> shifts) & 1
    return bits.reshape(x.shape[0], 256).to(torch.float32)


def hamming_bound(n: int, m: int) -> tuple:
    """(bound ms, bytes ms, ops ms) of one [n,8] x [m,8] distance matrix
    on an H100: both inputs read and the int32 output written once at the
    published HBM rate, or the distances by the route the card runs
    fastest, |a| + |b| - 2 <bits_a, bits_b> on the tensor cores (the JAX
    package's production route), as 2 n m 256 int8 operations at the
    published rate, whichever takes longer."""
    bytes_ms = ((n + m) * WORDS * 4 + n * m * 4) / PEAKS[
        "hbm_bytes_per_s"] * 1e3
    ops_ms = 2 * n * m * WORDS * 32 / PEAKS["int8_ops"] * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


class HammingKernel(CudaKernel):
    """K1's binding."""

    name = "Hamming kernel"
    source = CSRC / "hamming.cu"
    entries = {"sgslam_hamming_matrix": [ctypes.c_void_p] * 3
               + [ctypes.c_int] * 2}

    def __call__(self, a, b):
        for name, t in (("a", a), ("b", b)):
            if not t.is_cuda:
                raise ValueError(f"{name} must be a CUDA tensor")
            if t.dtype != torch.int32:
                raise TypeError(f"{name} must be int32, got {t.dtype}")
            if t.dim() != 2 or t.shape[1] != WORDS:
                raise ValueError(f"{name} must be [*, {WORDS}], got "
                                 f"{tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
        if a.device != b.device:
            raise ValueError("a and b lie on different devices")
        n, m = a.shape[0], b.shape[0]
        if -(-n // 64) > 65535:     # grid.y counts 64-row tiles
            raise ValueError(f"{n} rows exceed the kernel's grid")
        out = torch.empty((n, m), dtype=torch.int32, device=a.device)
        if n == 0 or m == 0:
            return out
        self.launch("sgslam_hamming_matrix", a.device, a.data_ptr(),
                    b.data_ptr(), out.data_ptr(), n, m)
        return out


hamming_kernel = HammingKernel()


def hamming_matrix(a, b):
    """a [N,8] int32, b [M,8] int32 -> [N,M] int32 Hamming distances.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return hamming_matrix_reference(a, b)
    return hamming_kernel(a, b)
