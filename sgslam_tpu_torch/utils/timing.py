"""The program's tracer (`Metrics`, `active`, `tracing`), a profiler trace
context, and the card timers of the measurement layer.

`Metrics` is the tracer of one facade (`System`, a chunked runner): its
counters count always; its spans are recorded only while it is on
(`start()` to `stop()`), and cost one attribute test while it is off. A
span records its name, its start and end in Unix-epoch ns (the clock of
torch.profiler's kineto events), its parent and its request id (the frame
id), and opens a `torch.profiler.record_function` range of the same name,
so that it sits on a device trace's timeline. Functions below a facade
reach the facade's tracer through `active()`, which the facade sets for
the call with `tracing(metrics)`.

The card timers (`event_ms`, `graph_ms`, `device_ops`), the card's label
(`card`) and the device choice of a harness (`measurement_device`) are the
one copy that `chip_smoke.py`, the harnesses (`bench`, `bench_kernels`,
`bench_sweep`, `profile_chunk`, `bench_dist_ba`, `bench_dist_ba_realmap`)
and `tools/` use. `PEAKS` are the published rates of one H100 that every
bound and share is taken against.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch


class Span:
    """One span of a tracer's record. `parent` is the index of the
    enclosing span in the record (-1 at the top), `rid` the request id
    (the frame id; a chunk's span carries its first frame's), `frames` the
    frames it covers where it says so, `attrs` a dict of further facts or
    None. `end_ns` is None while the span is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "rid", "frames",
                 "attrs")

    def __init__(self, name, start_ns, parent, rid, frames, attrs):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.rid, self.frames = parent, rid, frames
        self.attrs = attrs

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Open:
    """The context of one recorded span."""

    __slots__ = ("m", "span", "index", "range")

    def __init__(self, m, span):
        self.m, self.span = m, span

    def __enter__(self):
        m = self.m
        self.index = len(m.spans)
        m.spans.append(self.span)
        m._stack.append(self.index)
        for fn in m.listeners:
            fn(self.span.name, True)
        self.range = torch.profiler.record_function(self.span.name)
        self.range.__enter__()
        return self.span

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        m = self.m
        self.span.end_ns = time.time_ns()
        m._stack.pop()
        for fn in m.listeners:
            fn(self.span.name, False)
        return False


_OFF = contextlib.nullcontext()


class Metrics:
    """Counters, and spans while on. `listeners` are called with (span
    name, True) as a recorded span opens and (name, False) as it closes.
    `on_stage`, None by default, is a stage hook that a caller lends to
    the code below it for a block, on or off: the stereo chunk sets its
    stage hook here around its extraction loop, so that
    `tracking.extract_frame_stereo`, whose signature is fixed, marks its
    two halves."""

    def __init__(self):
        self.counters: dict[str, int] = defaultdict(int)
        self.on = False
        self.on_stage = None
        self.spans: list[Span] = []
        self.listeners: list = []
        self._stack: list[int] = []
        self._base: dict[str, int] = {}

    def count(self, name: str, inc: int = 1):
        self.counters[name] += inc

    def span(self, name: str, rid=None, frames=None, attrs=None):
        """`with metrics.span("tracking.search"):` records the block as a
        span while the tracer is on. `rid` defaults to the enclosing
        span's."""
        if not self.on:
            return _OFF
        parent = self._stack[-1] if self._stack else -1
        if rid is None and parent >= 0:
            rid = self.spans[parent].rid
        return _Open(self, Span(name, time.time_ns(), parent, rid, frames,
                                attrs))

    def start(self):
        """Switch on with an empty record; counts are read from here. Call
        it outside the facade's calls (no span open)."""
        self.on = True
        self.spans = []
        self._stack = []
        self._base = dict(self.counters)

    def stop(self):
        self.on = False

    def record(self) -> dict:
        """{"spans": the spans since `start()`, in the order they opened
        (a span still open has no `end_ns`), "counts": {counter: increase
        since `start()`}}."""
        counts = {k: v - self._base.get(k, 0)
                  for k, v in self.counters.items()}
        return {"spans": list(self.spans),
                "counts": {k: v for k, v in counts.items() if v}}

    def span_stats(self) -> dict:
        """{span name: (count, median host ms, p90 host ms)} of the closed
        spans: host time between the span's edges."""
        by = defaultdict(list)
        for s in self.spans:
            if s.end_ns is not None:
                by[s.name].append(s.ms)
        return {k: (len(v), float(np.median(v)), float(np.percentile(v, 90)))
                for k, v in by.items()}

    def report(self) -> str:
        """One line per span name (count, median and p90 host ms), then
        one per counter."""
        lines = [f"{k:28s} n={n:6d} median={med:9.3f} ms p90={p90:9.3f} ms"
                 for k, (n, med, p90) in sorted(self.span_stats().items())]
        lines += [f"{k:28s} {v}" for k, v in sorted(self.counters.items())]
        return "\n".join(lines)


_IDLE = Metrics()
_active = _IDLE


def active() -> Metrics:
    """The tracer of the facade call in progress (one that is off outside
    any)."""
    return _active


@contextlib.contextmanager
def tracing(m: Metrics):
    """Make `m` the active tracer for the block."""
    global _active
    prev, _active = _active, m
    try:
        yield m
    finally:
        _active = prev


@contextlib.contextmanager
def xla_trace(logdir: str):
    """Profiler context, the port's counterpart of the reference's XLA
    trace: `torch.profiler` over the CPU and, where there is one, the card;
    the trace is written into `logdir` as a Chrome/TensorBoard `.json`
    when the block ends. Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
# without sparsity, at the full 700 W power limit): HBM3 bandwidth, float32
# outside the tensor cores, bf16 and int8 on the tensor cores.
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12,
         "bf16_flops": 989e12, "int8_ops": 1979e12}


def smi(query: str, index: int = 0) -> str:
    """`nvidia-smi --query-gpu=QUERY --format=csv,noheader` of card
    `index`."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         f"--id={index}"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def card(device) -> str:
    """The label every number measured on `device` carries: the card's name
    and power limit as nvidia-smi gives them, or "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    return smi("name,power.limit", dev.index or 0)


def measurement_device(cpu: bool, prog: str) -> torch.device:
    """The device a harness measures on: the first card, or the CPU when
    `cpu` (its `--cpu`). Without a card and without `cpu` it exits non-zero
    before it measures anything, so that no CPU number runs under a card's
    name. On the card TF32 is off, as everywhere in the port."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device; pass --cpu to measure "
                         "on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def sync(device) -> None:
    """Wait for the card (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def event_times(fn, runs: int, warmup: int = 5, device="cuda",
                args=None) -> list:
    """ms of each of `runs` calls of `fn` after `warmup` untimed calls. On
    a card: between CUDA events, the device time of what the call launches
    plus the host time of the call while the card waits for it; on the CPU:
    the host clock around the call. `args(r)`, if given, makes call r's
    arguments (r = 0 for the warm-up) before its timing starts."""
    cuda = torch.device(device).type == "cuda"
    make = args or (lambda r: ())
    for _ in range(warmup):
        fn(*make(0))
    times = []
    for r in range(1, runs + 1):
        a = make(r)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*a)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*a)
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def event_ms(fn, runs: int, warmup: int = 5, device="cuda",
             args=None) -> float:
    """Median of `event_times`: the time of one call."""
    return float(np.median(event_times(fn, runs, warmup, device, args)))


def graph_ms(fn, calls: int, replays: int = 50) -> float:
    """Device time of one call of `fn` on the card: `calls` calls captured
    in a CUDA graph, replayed back to back between CUDA events (median over
    `replays`), so that no host time is counted. `fn` must read nothing
    back to the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return event_ms(graph.replay, runs=replays, warmup=2) / calls


def device_ops(fn, reps: int = 5):
    """[(name, calls, device us)] per call of `fn` on the card: its device
    operations (kernels, copies, memsets) from torch.profiler's CUDA
    activity, most expensive first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count / reps, e.device_time_total / reps)
            for e in prof.key_averages() if e.device_time_total > 0]
    return sorted(rows, key=lambda r: -r[2])

