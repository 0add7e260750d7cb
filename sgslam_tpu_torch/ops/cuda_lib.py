"""How the port's hand-written CUDA kernels are built, loaded, launched
and counted.

Each kernel is one source under `csrc/` with a plain C interface: no
torch headers, and every entry point that launches takes the current
stream as its last argument and returns the CUDA error of its launch (0
for none). `build_library` compiles a source with `nvcc` for sm_90a into a
shared library under `build/` at the repository root, at first use; the
file name carries a hash of the source and the flags, so an edit rebuilds
and a library already built is reused.

`CudaKernel` is the base of every kernel's ctypes binding. A binding
declares its source, its nvcc flags beyond `NVCC_FLAGS` and its launching
entry points' argument types; `load` builds and opens the library once,
under a lock, and runs the binding's own `check` of it; `launch` runs an
entry point on the current stream of a tensor's card and counts it in
`launches`. A build that fails, a library that `check` refuses and a
launch that returns an error all raise: no wrapper falls back to its
plain version. The binding itself checks its inputs and allocates its
outputs.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def build_library(source: Path, flags: tuple = (),
                  verbose: bool = False) -> Path:
    """Compile a CUDA source of csrc/, if not already built, into a shared
    library and return its path; `flags` are added to NVCC_FLAGS. The file
    name carries a hash of the source and the flags, so an edit rebuilds."""
    src = source.read_bytes()
    flags = (*NVCC_FLAGS, *flags)
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:12]
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
        cmd = [nvcc, *flags]
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


class CudaKernel:
    """ctypes binding of one `csrc/` source, loaded at first launch, with
    a count of launches. A subclass sets `name` (for its errors),
    `source`, `flags` and `entries`: each launching entry point's argument
    types, the stream left out."""

    name: str
    source: Path
    flags: tuple = ()
    entries: dict = {}

    def __init__(self):
        self.launches = 0
        self.fns = None         # {entry point: ctypes function} once loaded
        self._lock = threading.Lock()

    def build(self, verbose: bool = False) -> Path:
        return build_library(self.source, self.flags, verbose)

    def check(self, lib):
        """The binding's own check of its library, just opened, before any
        launch; raises to refuse it."""

    def load(self, verbose: bool = False) -> dict:
        with self._lock:
            if self.fns is None:
                lib = ctypes.CDLL(str(self.build(verbose)))
                fns = {}
                for entry, argtypes in self.entries.items():
                    fn = getattr(lib, entry)
                    fn.argtypes = [*argtypes, ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                    fns[entry] = fn
                self.check(lib)
                self.fns = fns
        return self.fns

    def launch(self, entry: str, device: torch.device, *args):
        """Run `entry` with `args` and the current stream of `device`'s
        card, entering that card only where it is not the current one."""
        fn = self.load()[entry]
        i = device.index
        with (contextlib.nullcontext() if torch.cuda.current_device() == i
              else torch.cuda.device(i)):
            err = fn(*args, torch.cuda.current_stream(i).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
