"""The fused Hamming search (K1s) on the CPU: the port's two searches give
exactly the JAX package's (idx, ok, dist) on seeded inputs that hold every
edge case of the first-index rule and the candidate mask
(`ops/search_cases.py`); a model of the kernel's keys, running minima and
split merges gives exactly the plain version's four outputs; and the
wrapper raises, never falls back, when the kernel cannot be built.

The kernel itself runs only on a card: `test_torch_hamming_search_cuda.py`
holds it against its plain version there, as `chip_smoke.py` does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu.config import MatcherConfig as JMatcher
from sgslam_tpu.matching import search as jsearch
from sgslam_tpu_torch.config import MatcherConfig as TMatcher
from sgslam_tpu_torch.matching import search as tsearch
from sgslam_tpu_torch.ops import cuda_lib
from sgslam_tpu_torch.ops import hamming_search as hs
from sgslam_tpu_torch.ops.search_cases import search_case

Q, N = 300, 257          # N: two column tiles of 128 and a ragged column


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=[0, 1], ids=["seed0", "seed1"])
def case(request):
    return search_case(np.random.default_rng(request.param), Q, N)


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                            else x.copy())


def _eq(t_out, j_out):
    for a, b in zip(t_out, j_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _projection_args(c, radius_mult=1.0):
    return [c["proj_uv"], c["radii"] * np.float32(radius_mult),
            c["pred_level"], c["desc_q"], c["valid_q"], c["feat_xy"],
            c["feat_level"], c["desc_t"], c["valid_t"]]


@pytest.mark.parametrize("level_window,ratio", [(1, 1.0), (1, 0.6),
                                                (7, 1.0), (7, 0.6)])
def test_search_by_projection_matches_reference(case, level_window, ratio):
    args = _projection_args(case, 3.0)
    kw = dict(level_window=level_window, max_dist=100, scale_factor=1.2,
              ratio=ratio)
    j = jsearch.search_by_projection(*map(jnp.asarray, args), **kw)
    t = tsearch.search_by_projection(*map(_t, args), **kw)
    _eq(t, j)
    idx, ok, dist = (x.numpy() for x in t)
    assert ok.sum() > 0                          # the search really matches
    # the planted rows: no candidate (NaN / inf, invalid) and a lone
    # candidate at 256, all at column 0 with the fill
    assert (idx[:18] == 0).all() and (dist[:18] == 256).all()
    # duplicate minima: the lower of the two equal columns
    assert (idx[18:26] == 16 + 2 * np.arange(8)).all()


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("ratio", [1.0, 0.6])
def test_match_by_descriptor_matches_reference(case, mutual, ratio):
    args = [case["desc_q"], case["valid_q"], case["desc_t"],
            case["valid_t"]]
    kw = dict(max_dist=80, mutual=mutual, ratio=ratio)
    j = jsearch.match_by_descriptor(*map(jnp.asarray, args), JMatcher(),
                                    **kw)
    t = tsearch.match_by_descriptor(*map(_t, args), TMatcher(), **kw)
    _eq(t, j)
    assert t[1].sum() > 0


def _kernel_model(dm, cand, splits, cols=128, mutual=False):
    """The kernel's arithmetic in numpy: keys (d << 16 | j) with a
    non-candidate's d at 512 or more, (best, second) starting at the
    virtual (256, 0), one running pair per split of the column tiles,
    the splits merged; per column the encoded atomicMax of
    ((256 - d) << 32 | ~i) over candidates with d < 256."""
    q, n = dm.shape
    d = np.where(cand, dm, 512 + dm).astype(np.int64)
    empty = 256 << 16
    keys = (d << 16) | np.arange(n)
    parts = []
    n_tiles = -(-n // cols)
    for s in range(splits):
        b = np.full(q, empty, np.int64)
        sec = np.full(q, empty, np.int64)
        for tile in range(s, n_tiles, splits):
            for j in range(tile * cols, min(n, (tile + 1) * cols)):
                k = keys[:, j]
                sec = np.minimum(sec, np.maximum(b, k))
                b = np.minimum(b, k)
        parts.append((b, sec))
    b, sec = parts[0]
    for b2, s2 in parts[1:]:
        sec = np.minimum(np.minimum(sec, s2), np.maximum(b, b2))
        b = np.minimum(b, b2)
    rbest = None
    if mutual:
        row = (0xFFFFFFFF - np.arange(q))[:, None]
        enc = np.where(cand & (dm < 256), ((256 - d) << 32) | row,
                       0).max(axis=0)
        rbest = np.where(enc >> 32, 0xFFFFFFFF - (enc & 0xFFFFFFFF), 0)
    return b & 0xFFFF, b >> 16, sec >> 16, rbest


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("splits", [1, 2, 3])
def test_kernel_model_matches_plain(case, windowed, splits):
    """The kernel's tie rules hold: its keys and merges give the plain
    version's best_idx, best, second and column argmin exactly."""
    c = case
    scale = torch.tensor(1.2) ** _t(c["pred_level"]).float()
    window = hs.Window(_t(c["proj_uv"]), _t(c["radii"]) * 3.0 * scale,
                       _t(c["pred_level"]), _t(c["feat_xy"]),
                       _t(c["feat_level"]), 1) if windowed else None
    args = [_t(c["desc_q"]), _t(c["valid_q"]), _t(c["desc_t"]),
            _t(c["valid_t"])]
    ref = hs.hamming_search_reference(*args, window, mutual=True)
    cand = hs.candidates(args[1], args[3], window).numpy()
    dm = hs.hamming_matrix(args[0], args[2]).numpy().astype(np.int64)
    got = _kernel_model(dm, cand, splits, mutual=True)
    for name, g, r in zip(("best_idx", "best", "second", "rbest"), got, ref):
        np.testing.assert_array_equal(g, r.numpy(), err_msg=name)
    assert (ref[3].numpy()[1:4] == 0).all()       # all-masked columns


def test_cpu_search_does_not_launch(case):
    before = hs.hamming_search_kernel.launches
    tsearch.match_by_descriptor(_t(case["desc_q"]), _t(case["valid_q"]),
                                _t(case["desc_t"]), _t(case["valid_t"]),
                                TMatcher())
    assert hs.hamming_search_kernel.launches == before


def test_kernel_rejects_cpu_tensors():
    d = torch.zeros((4, 8), dtype=torch.int32)
    v = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        hs.hamming_search_kernel(d, v, d, v)


def test_unbuildable_kernel_raises(monkeypatch):
    """A tensor off the CPU goes to the kernel: when the library cannot be
    built, the call raises and the plain version is not taken. (Meta
    tensors stand in for CUDA ones here, with the wrapper's device checks
    passed through.)"""
    def no_nvcc(*a, **k):
        raise RuntimeError("nvcc not found")

    def no_plain(*a, **k):
        raise AssertionError("took the plain version")

    monkeypatch.setattr(cuda_lib, "build_library", no_nvcc)
    monkeypatch.setattr(hs, "hamming_search_reference", no_plain)
    monkeypatch.setattr(hs, "_card_index", lambda t: 0)
    monkeypatch.setattr(hs, "_ready", lambda t, *a: t)
    kernel = hs.HammingSearchKernel()
    monkeypatch.setattr(hs, "hamming_search_kernel", kernel)
    d = torch.zeros((40, 8), dtype=torch.int32, device="meta")
    v = torch.ones(40, dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        hs.hamming_search(d, v, d, v, mutual=True)
    assert kernel.launches == 0 and kernel.fns is None


def test_search_bound_is_the_hand_count():
    b, by, ops = hs.search_bound(4096, 1024)
    assert ops == pytest.approx(2 * 4096 * 1024 * 256 / 1979e12 * 1e3)
    assert by == pytest.approx((4096 * (32 + 1 + 16 + 16) + 1024 * (
        32 + 1 + 12)) / 3.35e12 * 1e3)
    assert b == ops and 1.08e-3 < b < 1.10e-3
    # what a windowed input needs: every pair's window test, the
    # candidates' distances
    b, _, ops = hs.search_bound(4096, 1024, n_cand=6000)
    assert ops == pytest.approx((4096 * 1024 * 7 / 67e12
                                 + 2 * 6000 * 256 / 1979e12) * 1e3)
    assert b == ops and 4.2e-4 < b < 4.4e-4
    assert hs.search_bound(1024, 1024, mutual=True,
                           window=False)[1] == pytest.approx(
        (1024 * 49 + 1024 * 41) / 3.35e12 * 1e3)
