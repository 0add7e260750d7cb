"""The benchmark's arithmetic: percentiles, the device's busy time from
kernel intervals, the published peaks of one H100 and the work bounds of
the two hand-written kernels the per-layer rooflines divide by.

`search_bound` and `segment_bound` are frozen copies of
`sgslam_tpu_torch/ops/hamming_search.py:search_bound` and
`ops/segment.py:segment_bound` (as of commit 1275b16), taking shapes and
counts rather than the program's tensors.
"""

from __future__ import annotations

import math

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
# without sparsity, at the full 700 W power limit): HBM3 bandwidth, float32
# outside the tensor cores, int8 on the tensor cores.
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12,
         "int8_ops": 1979e12}
WORDS = 8               # 32-bit words of a 256-bit ORB descriptor
WINDOW_OPS = 7          # a pair's window test in the search kernel


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of `values` by linear interpolation
    between the closest ranks (numpy's default method)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_ns(intervals) -> int:
    """Length of the union of [start, end) intervals (ns): the time in
    which at least one operation ran."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, start: int, end: int):
    """The idle stretches [(gap_start, gap_end)] of [start, end) that no
    interval covers."""
    gaps, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return [(a, b) for a, b in gaps if b > a]


def search_bound(q: int, n: int, mutual: bool = False, window: bool = True,
                 n_cand: int | None = None) -> float:
    """The least time (ms) one fused Hamming search of q query rows
    against n features can take on an H100: its inputs read and outputs
    written once at the published HBM rate, or its operations, whichever
    takes longer. With a window and `n_cand` (the input's candidate
    pairs), the operations are every pair's window test at the float32
    peak and the candidates' distances (2 * 256 int8 operations each);
    without a window, every pair's distance."""
    per_q = WORDS * 4 + 1 + 8 + 4 + 4
    per_n = WORDS * 4 + 1 + (8 if mutual else 0)
    if window:
        per_q += 8 + 4 + 4
        per_n += 8 + 4
    bytes_ms = (q * per_q + n * per_n) / PEAKS["hbm_bytes_per_s"] * 1e3
    if window and n_cand is not None:
        ops_ms = (q * n * WINDOW_OPS / PEAKS["fp32_flops"]
                  + 2 * n_cand * WORDS * 32 / PEAKS["int8_ops"]) * 1e3
    else:
        ops_ms = 2 * q * n * WORDS * 32 / PEAKS["int8_ops"] * 1e3
    return max(bytes_ms, ops_ms)


def segment_bound(kept: int, rows: int, cols: int, n: int, value_size: int,
                  index_size: int, has_init: bool) -> float:
    """The least time (ms) one segment sum can take on an H100: the kept
    rows' values, every row's index and the output (and init) moved once
    each at the published HBM rate, or one add per kept value at the
    float32 rate, whichever takes longer."""
    nbytes = (kept * cols * value_size + rows * index_size
              + n * cols * value_size * (2 if has_init else 1))
    bytes_ms = nbytes / PEAKS["hbm_bytes_per_s"] * 1e3
    ops_ms = kept * cols / PEAKS["fp32_flops"] * 1e3
    return max(bytes_ms, ops_ms)
