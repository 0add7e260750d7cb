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
segments and at the main path's shapes; this file imports JAX only inside
the tests that need it, so that the `cuda` cases run on a machine without
JAX: `python -m pytest --noconftest -m cuda tests/test_torch_segment.py`.

The kernel keys the rows (its `key_of`, here `_sort_keys`: the index, or n
for a dropped row), sorts the kept ones over `key_bits(n)` bits and marks
each output row's run of sorted positions; `_pipeline` runs those steps in
plain torch and must equal the plain version to the bit."""

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


def test_key_bits_cover_the_kept_keys():
    """The sorted keys are the kept indices, [0, n): ceil(log2(n)) bits, at
    least 1, at n = 1, 2^k - 1, 2^k and 2^k + 1 (the BA's window 17 bits,
    the occupancy grid 21, the global BA 24: 3 passes of 8 bits each)."""
    assert segment.key_bits(1) == 1
    for k in (1, 2, 7, 8, 17, 21, 24, 30):
        assert segment.key_bits(2 ** k - 1) == k
        assert segment.key_bits(2 ** k) == k
        assert segment.key_bits(2 ** k + 1) == k + 1
    for n in (2, 3, 98304, 2 ** 21, 2 ** 24):
        bits = segment.key_bits(n)
        assert (n - 1) >> bits == 0 < (n - 1) >> (bits - 1)
    assert [segment.key_bits(n) for n in (98304, 2 ** 21, 2 ** 24)] == [
        17, 21, 24]


def _sort_keys(index, n: int):
    """The kernel's keys (its `key_of`), as int64: the index where it lies
    in [0, n), else n, which marks a dropped row; the kernel sorts only the
    kept ones."""
    idx = index.to(torch.int64)
    return torch.where((idx >= 0) & (idx < n), idx, n)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_dropped_rows_get_key_n(dtype):
    """-1, -5, n and n + 3 all become n, outside the sorted keys' bits."""
    n = 10
    index = torch.tensor([3, -1, 0, -5, 9, n, 4, n + 3, 3, 0], dtype=dtype)
    keys = _sort_keys(index, n)
    assert keys.dtype == torch.int64
    assert keys.tolist() == [3, n, 0, n, 9, n, 4, n, 3, 0]
    assert int(keys[keys < n].max()) >> segment.key_bits(n) == 0


def _pipeline(values, index, n, init=None, per_block=37, digit=8):
    """The kernel's steps in plain torch: keys, the dropped rows (key n)
    left out; an LSD radix sort of the kept keys over key_bits(n) bits,
    `digit` bits a pass, each pass stable; per block of `per_block` output
    rows, its range of sorted positions by a lower-bound search and the
    start and stop of each row's run; then init (or zero) plus a short run
    row by row, a long one in the tree."""
    rows = values.shape[0]
    cols = values[0].numel()
    vals = values.reshape(rows, cols)
    keys = _sort_keys(index, n)
    bits = segment.key_bits(n)
    order = torch.nonzero(keys < n).flatten()
    for lo in range(0, bits, digit):
        d = (keys[order] >> lo) & ((1 << digit) - 1)
        order = order[torch.sort(d, stable=True).indices]
    skeys = keys[order]
    start = torch.zeros(n, dtype=torch.int64)
    stop = torch.zeros(n, dtype=torch.int64)
    for s0 in range(0, n, per_block):
        s1 = min(s0 + per_block, n)
        p0, p1 = torch.searchsorted(skeys, torch.tensor([s0, s1])).tolist()
        run = skeys[p0:p1]
        pos = torch.arange(p0, p1)
        head = torch.ones(p1 - p0, dtype=torch.bool)
        head[1:] = run[1:] != run[:-1]
        tail = torch.ones(p1 - p0, dtype=torch.bool)
        tail[:-1] = run[1:] != run[:-1]
        start[run[head]] = pos[head]
        stop[run[tail]] = pos[tail] + 1
    length = stop - start
    out = (torch.zeros((n, cols), dtype=values.dtype) if init is None
           else init.reshape(n, cols).clone())
    short = length <= segment.LONG
    for m in range(int(length[short].max()) if short.any() else 0):
        grow = short & (length > m)
        out[grow] = out[grow] + vals[order[start[grow] + m]]
    for s in torch.nonzero(~short).flatten().tolist():
        a, e = int(start[s]), int(stop[s])
        part = torch.zeros((segment.BLOCK, cols), dtype=values.dtype)
        for j in range(a, e, segment.BLOCK):
            m = min(segment.BLOCK, e - j)
            part[:m] = part[:m] + vals[order[j:j + m]]
        h = segment.BLOCK // 2
        while h:
            part[:h] = part[:h] + part[h:2 * h]
            h //= 2
        out[s] = out[s] + part[0]
    return out.reshape((n,) + tuple(values.shape[1:]))


def _lengths_case(seed, lengths, cols, dtype, n_extra=40):
    """Segments of the given lengths (shuffled among short random ones and
    dropped rows: -1, -5, n, n + 3), values of many magnitudes."""
    rng = np.random.default_rng(seed)
    n = len(lengths) + n_extra
    index = np.concatenate([np.full(L, s) for s, L in enumerate(lengths)]
                           + [rng.integers(len(lengths), n, 300),
                              np.array([-1, -5, n, n + 3] * 5)])
    index = index[rng.permutation(len(index))]
    shape = (len(index),) if cols is None else (len(index), cols)
    values = (rng.normal(size=shape) * 10.0 ** rng.uniform(
        -3, 6, size=shape)).astype(dtype)
    return values, index, n


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_init", [False, True])
def test_pipeline_equals_plain_and_jax(dtype, with_init):
    """Segments of 1, 256 (the longest short one), 257 (the shortest long
    one) and 6728 rows (insert_scan's longest in phase 7): the kernel's
    steps in plain torch equal the plain version to the bit at any block
    size and for int32 and int64 indices, and jax.ops.segment_sum within
    float32 rounding. The kernel itself is held to the plain version only
    in the `cuda` cases: on the CPU the wrapper is the plain version."""
    import jax
    import jax.numpy as jnp

    values, index, n = _lengths_case(5, [1, 256, 257, 6728, 1, 3], 3, dtype)
    init = (np.random.default_rng(6).normal(size=(n, 3)).astype(dtype)
            if with_init else None)
    t_init = None if init is None else torch.from_numpy(init)
    v = torch.from_numpy(values)
    ref = segment.segment_sum_reference(v, torch.from_numpy(index), n,
                                        t_init)
    for idx_dtype, per_block in ((torch.int64, 37), (torch.int32, 1),
                                 (torch.int32, 1024)):
        i = torch.from_numpy(index).to(idx_dtype)
        got = _pipeline(v, i, n, t_init, per_block=per_block)
        assert torch.equal(got, ref), (idx_dtype, per_block)
    jx = np.asarray(jax.ops.segment_sum(jnp.asarray(values, jnp.float32),
                                        jnp.asarray(index), n))
    if init is not None:
        jx = jx + init.astype(np.float32)
    scale = np.abs(values).max() + (0 if init is None else np.abs(init).max())
    np.testing.assert_allclose(ref.numpy(), jx, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("n,cols", [(1, None), (64, 30), (1000, 1)])
def test_pipeline_at_small_n(n, cols):
    """One output row, BA-like rows of 30 columns, one column: the steps
    equal the plain version to the bit, with digits of 3 bits (several LSD
    passes even at small n)."""
    values, index = _case(n, 700, cols, n)
    v, i = torch.from_numpy(values), torch.from_numpy(index)
    assert torch.equal(_pipeline(v, i, n, digit=3),
                       segment.segment_sum_reference(v, i, n))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _held(first, second, v, i, n, init=None):
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    plain = segment.segment_sum_reference(
        v.cpu(), i.cpu(), n, None if init is None else init.cpu())
    assert torch.equal(first.cpu(), plain)


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
    _held(segment.segment_kernel(v, i, n), segment.segment_kernel(v, i, n),
          v, i, n)


def _sparse_case(seed, rows, cols, n, kept, long_rows=()):
    """The main path's shapes: `kept` of the rows land on random outputs,
    the others are dropped (-1); `long_rows` more rows go to a few
    outputs each (the occupancy voxels at the sensor)."""
    rng = np.random.default_rng(seed)
    index = np.where(rng.random(rows) < kept, rng.integers(0, n, rows), -1)
    at = 0
    for s, L in enumerate(long_rows):
        index[at:at + L] = s * 97
        at += L
    index = index[rng.permutation(rows)]
    shape = (rows,) if cols is None else (rows, cols)
    return rng.normal(size=shape).astype(np.float32), index.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,n,kept,long_rows,with_init", [
    (24576, 30, 98304, 0.1, (), False),           # local BA, phase 10
    (4194304, None, 2 ** 21, 0.15,
     (23009, 6728, 2000, 300), True),             # insert_scan onto init
    (524288, 30, 2 ** 24, 0.07, (), False)])      # the global BA
def test_kernel_at_the_timed_shapes_on_gpu(cuda_device, rows, cols, n, kept,
                                           long_rows, with_init):
    values, index = _sparse_case(rows % 89, rows, cols, n, kept, long_rows)
    v = torch.from_numpy(values).to(cuda_device)
    i = torch.from_numpy(index).to(cuda_device)
    init = (torch.randn((n,) + tuple(v.shape[1:]), device=cuda_device)
            if with_init else None)
    _held(segment.segment_kernel(v, i, n, init),
          segment.segment_kernel(v, i, n, init), v, i, n, init)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_without_long_segments_launches_no_long_work(cuda_device,
                                                            dtype):
    """No segment longer than LONG (the BA's sums): one call is a memset,
    `histogram`, one `sort_pass` per 8 key bits and one `sum_rows` grid,
    and nothing else (no output pre-pass, no long-segment grid); the result
    equals the plain version."""
    from torch.profiler import ProfilerActivity, profile

    n = 98304
    values, index = _sparse_case(3, 24576, 30, n, 0.1)
    v = torch.from_numpy(values).to(cuda_device).to(dtype)
    i = torch.from_numpy(index).to(cuda_device)
    first = segment.segment_kernel(v, i, n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        second = segment.segment_kernel(v, i, n)
        torch.cuda.synchronize()
    ops = {e.key: e.count for e in prof.key_averages()
           if e.device_time_total > 0}
    named = {"histogram": 1, "sort_pass": -(-segment.key_bits(n) // 8),
             "sum_rows": 1, "Memset": 1}
    assert {w: sum(c for k, c in ops.items() if w in k)
            for w in named} == named, ops
    assert sum(ops.values()) == sum(named.values()), ops
    _held(first, second, v, i, n)
