"""sgslam_tpu_torch — the PyTorch/CUDA port of `sgslam_tpu`.

The sub-packages mirror `sgslam_tpu` module for module, so each function has
a counterpart of the same name. The port imports `torch` and numpy, never
`jax` and nothing of `sgslam_tpu`.

Entry points (`slam.system.System`, `slam.tracking.Tracker`,
`slam.mono.MonoTracker`, the chunked runners, `io.synthetic.
SyntheticSequence`, `io.tum.TumSequence`) run on the GPU unless the caller
passes `device="cpu"` (`python -m sgslam_tpu_torch.run_tum --cpu`); there
is no silent fallback from one to the other.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. Asking for CUDA where there is no
    GPU is an error, not a reason to run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sgslam_tpu_torch: a CUDA device was asked for but none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
