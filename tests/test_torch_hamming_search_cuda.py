"""The fused Hamming search (K1s) on the card, held to the bit against its
plain version (K1 and the torch chain) at the call sites' shapes and
with every planted edge case of `ops/search_cases.py`, denormal windows
included. No JAX here: the CPU
comparison with the reference is `test_torch_hamming_search.py`.

On a machine with a card:
    python -m pytest tests/test_torch_hamming_search_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from sgslam_tpu_torch.ops import hamming_search as hs
from sgslam_tpu_torch.ops.search_cases import search_args, search_case

MODES = {"window_lw1": (1, False), "window_lw7": (7, False),
         "descriptor": (None, False), "mutual": (None, True),
         "window_mutual": (1, True)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("q,n", [(300, 257), (640, 640), (1024, 1000),
                                 (1024, 1024), (4096, 1024), (2176, 2176)])
def test_kernel_matches_plain_on_gpu(cuda_device, mode, q, n):
    level_window, mutual = MODES[mode]
    case = search_case(np.random.default_rng(q + n), q, n, denormals=True)
    args = search_args(case, cuda_device, level_window)
    kernel = hs.HammingSearchKernel()
    got = kernel(*args, mutual=mutual)
    torch.cuda.synchronize()
    want = hs.hamming_search_reference(*args, mutual=mutual)
    for name, g, w in zip(("best_idx", "best", "second", "rbest"), got,
                          want):
        if w is None:
            assert g is None, name
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), name
    assert kernel.launches == 1
