"""Failure semantics of `sgslam_tpu_torch/geometry/linalg.py` against
`jnp.linalg`.

The reference's `solve`, `inv`, `svd` and `eigh` never raise: a singular
system or a non-finite input gives non-finite entries, and the LM loops
reject such a step by comparison (`sgslam_tpu/optim/local_ba.py:224`). The
port's wrappers must not raise either. Which entries of a singular
system's solution are non-finite depends on the LU's elimination order
(XLA's and LAPACK's differ), so a batch item is compared by whether it is
all finite, and items that are agree to 1e-5 relative; so do singular
values and eigenvalues of finite items.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch import convert
from sgslam_tpu_torch.geometry import linalg
from sgslam_tpu_torch.optim import local_ba as tba

from test_torch_local_ba import make_problem

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _systems(case):
    """A batch of eight 6x6 systems: well posed, one with an exactly zero
    pivot, or one with a NaN entry."""
    rng = np.random.default_rng(["regular", "singular", "nan"].index(case))
    A = rng.normal(size=(8, 6, 6)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + np.eye(6, dtype=np.float32)
    b = rng.normal(size=(8, 6)).astype(np.float32)
    if case == "singular":
        A[3, 1] = 2.0 * A[3, 0]                   # rank 5, exact in f32
        A[3, :, 1] = 2.0 * A[3, :, 0]
    if case == "nan":
        A[5, 2, 4] = np.nan
    return A, b


def _same_items(port, ref):
    """Batch items [B, ...]: the same items all finite, and those equal to
    RTOL."""
    port, ref = np.asarray(port), np.asarray(ref)
    fin = np.isfinite(ref).reshape(len(ref), -1).all(1)
    np.testing.assert_array_equal(
        np.isfinite(port).reshape(len(port), -1).all(1), fin)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("case", ["regular", "singular", "nan"])
def test_solve_and_inv_never_raise(case):
    A, b = _systems(case)
    ref_x = jnp.linalg.solve(jnp.asarray(A), jnp.asarray(b)[..., None])
    ref_i = jnp.linalg.inv(jnp.asarray(A))
    x = linalg.solve(torch.from_numpy(A), torch.from_numpy(b)[..., None])
    Ai = linalg.inv(torch.from_numpy(A))
    assert np.isfinite(np.asarray(ref_x)).all() == (case == "regular")
    _same_items(x.numpy(), ref_x)
    _same_items(Ai.numpy(), ref_i)


@pytest.mark.parametrize("fn", ["svd", "eigh"])
def test_nonfinite_item_gives_nan(fn):
    A, _ = _systems("nan")
    A[5] = np.nan                       # the whole item, as a bad sample
    ref = getattr(jnp.linalg, fn)(jnp.asarray(A))
    out = getattr(linalg, fn)(torch.from_numpy(A))
    vals_ref = np.asarray(ref[1] if fn == "svd" else ref[0])
    vals = (out[1] if fn == "svd" else out[0]).numpy()
    assert np.isnan(vals_ref[5]).all()
    for o in out:
        assert torch.isnan(o[5]).all()
        assert torch.isfinite(torch.cat([o[:5], o[6:]])).all()
    keep = np.arange(8) != 5
    np.testing.assert_allclose(vals[keep], vals_ref[keep], rtol=RTOL,
                               atol=1e-5)


def test_bundle_adjust_rejects_a_failed_solve(monkeypatch):
    """A reduced camera system whose LU fails gives a non-finite step in
    the reference, whose cost comparison then rejects it: every step of
    the run is rejected and the input comes back unchanged. The port does
    the same instead of raising."""
    d = make_problem(np.random.default_rng(0))
    prob = convert.ba_problem_from_numpy(d)
    monkeypatch.setattr(linalg, "solve", lambda A, b: torch.full_like(
        b, float("nan")))
    poses, points, inlier = tba.bundle_adjust(tcfg.tum3_config().camera,
                                              prob)
    np.testing.assert_array_equal(poses.numpy(), d["poses"])
    np.testing.assert_array_equal(points.numpy(), d["points"])
    assert inlier.shape == d["obs_w"].shape
