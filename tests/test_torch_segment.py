"""`sgslam_tpu_torch/ops/segment.py`: the deterministic segment sum that
every float scatter-add of the port goes through.

On the CPU the wrapper is its plain version; it must equal a numpy loop in
float32 that adds in the contract's order to the bit (the order of the
adds is part of the contract: the CUDA kernel adds in that order too): a
segment of at most `LONG` rows row after row onto init, a longer one as
`BLOCK` strided partial sums halved in a fixed tree, then added to init.
It must equal `jax.ops.segment_sum` within float32 rounding of sums of
1000 terms (rtol 1e-5). The `cuda` cases hold the kernel against the plain
version to the bit, and two launches against each other, at short and long
segments; this file imports JAX only inside the test
that needs it, so that the `cuda` cases run on a machine without JAX:
`python -m pytest --noconftest -m cuda tests/test_torch_segment.py`."""

import numpy as np
import pytest
import torch

from sgslam_tpu_torch.ops import segment


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, rows, cols, n, dtype=np.float32, dropped=True):
    rng = np.random.default_rng(seed)
    shape = (rows,) if cols is None else (rows, cols)
    values = (rng.normal(size=shape) * 10.0 ** rng.uniform(
        -3, 6, size=shape)).astype(dtype)
    lo = -3 if dropped else 0
    index = rng.integers(lo, n + (3 if dropped else 0), size=rows)
    return values, index


def _loop(values, index, n, init=None):
    """The sum in the contract's order, in the values' own precision: rows
    in increasing r, one add each, for a segment of at most LONG rows; for
    a longer one, its k-th row into partial sum k % BLOCK, then the tree."""
    out = (np.zeros((n,) + values.shape[1:], values.dtype) if init is None
           else init.copy())
    kept = [(r, s) for r, s in enumerate(index) if 0 <= s < n]
    sizes = np.bincount([s for _, s in kept], minlength=n)
    parts, seen = {}, {}
    for r, s in kept:
        if sizes[s] <= segment.LONG:
            out[s] = out[s] + values[r]
            continue
        p = parts.setdefault(s, [np.zeros_like(values[0])
                                 for _ in range(segment.BLOCK)])
        k = seen.get(s, 0)
        p[k % segment.BLOCK] = p[k % segment.BLOCK] + values[r]
        seen[s] = k + 1
    for s, p in parts.items():
        h = segment.BLOCK // 2
        while h:
            for t in range(h):
                p[t] = p[t] + p[t + h]
            h //= 2
        out[s] = out[s] + p[0]
    return out


@pytest.mark.parametrize("rows,cols,n", [(1000, None, 37), (500, 30, 64),
                                         (64, 5, 1), (300, 3, 1000)])
def test_plain_version_is_the_ordered_sum(rows, cols, n):
    values, index = _case(rows, rows, cols, n)
    got = segment.segment_sum(torch.from_numpy(values),
                              torch.from_numpy(index), n)
    np.testing.assert_array_equal(got.numpy(), _loop(values, index, n))


def test_init_is_added_onto_and_left_alone():
    values, index = _case(7, 400, None, 50)
    init = np.random.default_rng(8).normal(size=50).astype(np.float32)
    t_init = torch.from_numpy(init.copy())
    got = segment.segment_sum(torch.from_numpy(values),
                              torch.from_numpy(index), 50, t_init)
    np.testing.assert_array_equal(got.numpy(), _loop(values, index, 50, init))
    np.testing.assert_array_equal(t_init.numpy(), init)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matches_jax_segment_sum(dtype):
    import jax
    import jax.numpy as jnp

    values, index = _case(11, 1000, 4, 20, dtype, dropped=False)
    got = segment.segment_sum(torch.from_numpy(values),
                              torch.from_numpy(index), 20).numpy()
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(values, jnp.float32),
                                         jnp.asarray(index), 20))
    scale = np.abs(values).max()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("rows,cols,n,init", [
    (3000, None, 4, True),      # occupancy-like: a few very long segments
    (2000, 5, 9, False),        # dense voxels, five columns
    (2 * 257 + 256, 2, 3, True)])   # one segment of LONG rows, two of LONG+1
def test_long_segments_follow_the_tree_order(rows, cols, n, init):
    values, index = _case(rows + 1, rows, cols, n)
    if rows == 2 * 257 + 256:
        index = np.repeat([0, 1, 2], [257, 256, 257])
    start = (np.random.default_rng(3).normal(size=(n,) + values.shape[1:])
             .astype(np.float32) if init else None)
    got = segment.segment_sum(
        torch.from_numpy(values), torch.from_numpy(index), n,
        None if start is None else torch.from_numpy(start.copy()))
    np.testing.assert_array_equal(got.numpy(), _loop(values, index, n, start))


def test_bad_inputs_raise():
    v = torch.zeros(4, 2)
    with pytest.raises(ValueError):
        segment.segment_sum(v, torch.zeros(3, dtype=torch.int64), 5)
    with pytest.raises(TypeError):
        segment.segment_sum(v, torch.zeros(4), 5)
    with pytest.raises(ValueError):
        segment.segment_sum(v, torch.zeros(4, dtype=torch.int64), 5,
                            torch.zeros(5, 3))
    with pytest.raises(ValueError):
        segment.segment_kernel(v, torch.zeros(4, dtype=torch.int64), 5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,n", [(200000, None, 3000),
                                         (52224, 30, 98304),
                                         (401408, None, 3584 ** 2),
                                         (4194304, None, 40),
                                         (307200, 5, 600)])
def test_kernel_repeats_and_matches_plain_on_gpu(cuda_device, rows, cols, n):
    values, index = _case(rows % 97, rows, cols, n)
    v = torch.from_numpy(values).to(cuda_device)
    i = torch.from_numpy(index).to(cuda_device)
    first = segment.segment_kernel(v, i, n)
    second = segment.segment_kernel(v, i, n)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    plain = segment.segment_sum_reference(v.cpu(), i.cpu(), n)
    assert torch.equal(first.cpu(), plain)
