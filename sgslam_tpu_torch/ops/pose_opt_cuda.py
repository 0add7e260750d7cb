"""Motion-only BA in one CUDA kernel launch: the card's `pose_optimization`.

`optim/pose_opt.py::pose_optimization` runs its plain torch body on CPU
tensors and `pose_opt_kernel` on CUDA tensors: `csrc/pose_opt.cu`, one
thread block that runs every round and iteration of the call (residuals,
Jacobians, H and b, the 6x6 solve, the SE(3) update, the guarded step and
the chi2 gating) and writes the pose, the inlier mask and their count.
There is no fallback from one to the other: a build or launch failure
raises. `pose_opt_kernel.launches` counts kernel launches.

The kernel is built like K1 (`ops/hamming_cuda.build_library`: nvcc for
sm_90a into `build/` at first use, a plain C entry point bound with
ctypes), with `-fmad=false` so that its float32 products and sums round
one at a time, as the plain body's torch ops do. Every scalar is a
kernel argument: a call copies nothing to the device, allocates only its
outputs, launches on the current stream and does not synchronise.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from .hamming_cuda import CSRC, build_library

_SOURCE = CSRC / "pose_opt.cu"
FLAGS = ("-fmad=false",)


class PoseOptKernel:
    """ctypes binding of the kernel, loaded at first launch, with a count
    of launches."""

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    def load(self, verbose: bool = False):
        with self._lock:
            if self._fn is None:
                lib = ctypes.CDLL(str(build_library(verbose, _SOURCE, FLAGS)))
                fn = lib.sgslam_pose_opt
                fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                               + [ctypes.c_float] * 5 + [ctypes.c_int] * 3
                               + [ctypes.c_float] * 2
                               + [ctypes.c_void_p] * 4)
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def __call__(self, cam, Tcw0, pw, obs, inv_sigma2, valid, *,
                 rounds: int, iters: int, guarded: bool,
                 chi2_mono: float, chi2_stereo: float):
        """(Tcw [7] f32, inlier [N] bool, n_inliers [] int64) of one call;
        the inputs as `pose_optimization` takes them, float32 and bool on
        one card."""
        n = pw.shape[0]
        dev = pw.device
        i = dev.index
        if dev.type != "cuda":
            raise ValueError("the pose kernel's tensors must be CUDA tensors")
        args = []
        for name, t, dtype, shape in (
                ("Tcw0", Tcw0, torch.float32, (7,)),
                ("pw", pw, torch.float32, (n, 3)),
                ("obs", obs, torch.float32, (n, 3)),
                ("inv_sigma2", inv_sigma2, torch.float32, (n,)),
                ("valid", valid, torch.bool, (n,))):
            if t.device != dev:
                raise ValueError(f"{name} must lie on {dev}, not {t.device}")
            if t.dtype != dtype:
                raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
            if t.shape != shape:
                raise ValueError(f"{name} must be {shape}, got "
                                 f"{tuple(t.shape)}")
            args.append(t if t.is_contiguous() else t.contiguous())
        Tcw = torch.empty(7, dtype=torch.float32, device=dev)
        inlier = torch.empty(n, dtype=torch.bool, device=dev)
        count = torch.empty((), dtype=torch.int64, device=dev)
        fn = self.load()
        with contextlib.ExitStack() as guard:
            if torch.cuda.current_device() != i:
                guard.enter_context(torch.cuda.device(i))
            err = fn(*(t.data_ptr() for t in args), n,
                     cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                     int(rounds), int(iters), int(bool(guarded)),
                     chi2_mono, chi2_stereo, Tcw.data_ptr(),
                     inlier.data_ptr(), count.data_ptr(),
                     torch.cuda.current_stream(i).cuda_stream)
        if err != 0:
            raise RuntimeError(f"pose optimization launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return Tcw, inlier, count


pose_opt_kernel = PoseOptKernel()
