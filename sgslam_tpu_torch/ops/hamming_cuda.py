"""K1: the 256-bit Hamming distance matrix — CUDA kernel and plain version.

The CUDA kernel (`csrc/hamming.cu`) replaces the TPU's Pallas kernel
`sgslam_tpu/ops/pallas_hamming.py::_hamming_kernel`. It is compiled with
`nvcc` for sm_90a into a shared library with a plain C entry point, at first
use, from the package's own sources into `build/` at the repository root,
and bound with ctypes.

`hamming_matrix(a, b)` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. There is no fallback from
one to the other. `hamming_kernel.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from ..utils.timing import PEAKS, smi

WORDS = 8
CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCE = CSRC / "hamming.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


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

# Documented popc throughput of compute capability 9.0, per clock per SM.
POPC_PER_CLK_SM = 16


def hamming_bound(n: int, m: int, popc_per_s: float) -> tuple:
    """(bound ms, bytes ms, popc ms) of one [n,8] x [m,8] distance matrix
    on an H100: both inputs read and the int32 output written once at the
    published HBM rate, or n * m * 8 popcounts at `popc_per_s`, whichever
    takes longer."""
    bytes_ms = ((n + m) * WORDS * 4 + n * m * 4) / PEAKS[
        "hbm_bytes_per_s"] * 1e3
    ops_ms = n * m * WORDS / popc_per_s * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def documented_popc_rate(device) -> float:
    """popc per second of the card at its maximum SM clock by the
    documented POPC_PER_CLK_SM (the least rate K1's bound may take)."""
    dev = torch.device(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_mhz = float(smi("clocks.max.sm", dev.index or 0).split()[0])
    return POPC_PER_CLK_SM * sms * max_mhz * 1e6

def build_library(verbose: bool = False, source: Path = _SOURCE) -> Path:
    """Compile a CUDA source of csrc/ (by default hamming.cu), if not
    already built, into a shared library and return its path. The file
    name carries a hash of the source and the flags, so an edit rebuilds."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = _BUILD_DIR / f"libsgslam_{source.stem}_{tag}.so"
    if lib.exists():
        return lib
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           f"build {source.name}")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc, *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        res = subprocess.run(cmd + ["-o", tmp, str(source)],
                             capture_output=True, text=True, check=False)
        if verbose or res.returncode != 0:
            print(res.stdout + res.stderr, end="")
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}) on {source}")
        os.replace(tmp, lib)      # atomic: concurrent builds never see half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


class HammingKernel:
    """ctypes binding of the CUDA kernel, loaded at first launch, with a
    count of launches."""

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    def load(self, verbose: bool = False):
        with self._lock:
            if self._fn is None:
                lib = ctypes.CDLL(str(build_library(verbose)))
                fn = lib.sgslam_hamming_matrix
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

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
        fn = self.load()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, m, stream)
        if err != 0:
            raise RuntimeError(f"Hamming kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return out


hamming_kernel = HammingKernel()


def hamming_matrix(a, b):
    """a [N,8] int32, b [M,8] int32 -> [N,M] int32 Hamming distances.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return hamming_matrix_reference(a, b)
    return hamming_kernel(a, b)
