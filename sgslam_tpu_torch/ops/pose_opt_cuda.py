"""Motion-only BA in one CUDA kernel launch: the card's `pose_optimization`.

`optim/pose_opt.py::pose_optimization` runs its plain torch body on CPU
tensors and `pose_opt_kernel` on CUDA tensors: `csrc/pose_opt.cu`, one
thread block that runs every round and iteration of the call (residuals,
Jacobians, H and b, the 6x6 solve, the SE(3) update, the guarded step and
the chi2 gating) and writes the pose, the inlier mask and their count.
There is no fallback from one to the other: a build or launch failure
raises. `pose_opt_kernel.launches` counts kernel launches, and
`ops/cuda_lib.py` builds, loads and launches the kernel.

It is compiled with `-fmad=false` so that its float32 products and sums
round one at a time, as the plain body's torch ops do. Every scalar is a
kernel argument: a call copies nothing to the device, allocates only its
outputs, launches on the current stream and does not synchronise.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CSRC, CudaKernel


class PoseOptKernel(CudaKernel):
    """P's binding."""

    name = "pose optimization"
    source = CSRC / "pose_opt.cu"
    flags = ("-fmad=false",)
    entries = {"sgslam_pose_opt": [ctypes.c_void_p] * 5 + [ctypes.c_int]
               + [ctypes.c_float] * 5 + [ctypes.c_int] * 3
               + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3}

    def __call__(self, cam, Tcw0, pw, obs, inv_sigma2, valid, *,
                 rounds: int, iters: int, guarded: bool,
                 chi2_mono: float, chi2_stereo: float):
        """(Tcw [7] f32, inlier [N] bool, n_inliers [] int64) of one call;
        the inputs as `pose_optimization` takes them, float32 and bool on
        one card."""
        n = pw.shape[0]
        dev = pw.device
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
        self.launch("sgslam_pose_opt", dev, *(t.data_ptr() for t in args), n,
                    cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                    int(rounds), int(iters), int(bool(guarded)),
                    chi2_mono, chi2_stereo, Tcw.data_ptr(),
                    inlier.data_ptr(), count.data_ptr())
        return Tcw, inlier, count


pose_opt_kernel = PoseOptKernel()
