"""Dense solves: `sgslam_tpu_torch/geometry/linalg.py`.

Frozen copy of the files named above as of commit 1275b16, with
their imports pointed at this folder. It imports nothing of the
program.
"""

from __future__ import annotations

import torch


def solve(A, b):
    """`jnp.linalg.solve`: A [..., n, n], b [..., n] or [..., n, k]."""
    return torch.linalg.solve_ex(A, b)[0]


def inv(A):
    """`jnp.linalg.inv`: A [..., n, n]."""
    return torch.linalg.inv_ex(A)[0]


def _finite_or_zero(A):
    bad = ~torch.isfinite(A).all(-1).all(-1)
    return torch.where(bad[..., None, None], 0.0, A), bad


def _nan_where(bad, outs):
    return tuple(torch.where(bad.reshape(bad.shape + (1,) * (x.dim()
                                                             - bad.dim())),
                             torch.nan, x) for x in outs)


def svd(A, full_matrices: bool = True):
    """`jnp.linalg.svd` -> (U, S, Vh): a batch item of A with a non-finite
    entry gives NaN factors; the other items are torch's own."""
    A0, bad = _finite_or_zero(A)
    return _nan_where(bad, torch.linalg.svd(A0, full_matrices=full_matrices))


def eigh(A):
    """`jnp.linalg.eigh` (lower triangle) -> (eigenvalues, eigenvectors): a
    batch item of A with a non-finite entry gives NaN for both."""
    A0, bad = _finite_or_zero(A)
    return _nan_where(bad, torch.linalg.eigh(A0))
