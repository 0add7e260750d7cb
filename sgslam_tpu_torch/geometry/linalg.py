"""Dense linear algebra with the reference's failure semantics.

`jnp.linalg.solve`, `inv`, `svd` and `eigh` never raise: a singular system
or a non-finite input gives non-finite entries, and the callers (the LM
loops, RANSAC scoring) reject such a step or hypothesis by comparison. The
torch counterparts raise a `LinAlgError` instead (`solve` and `inv` on an
exactly zero pivot; `svd` and `eigh` when the solver reports that a NaN
input did not converge), and on the GPU that check is a host read.

`solve` and `inv` are the `_ex` forms: the same partial-pivoting LU, which
runs on past a zero pivot, so a singular system gives the inf and NaN
entries that the reference's gives. `svd` and `eigh` zero a batch item
whose input is not finite, factor it, and return NaN for that item, as the
reference does for such an input. Nothing is read back to the host.
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
