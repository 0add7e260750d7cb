"""Per-stage timing + metrics registry, a profiler trace context, and the
card timers of the measurement layer.

Own copy of `sgslam_tpu/utils/timing.py` (`Metrics`, numpy only), with
`xla_trace` as a `torch.profiler` trace of the same shape. `Metrics`'
timers read the host clock: on the GPU they time the host's enqueue of a
stage unless the stage ends in a host read or a synchronize.

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


class Metrics:
    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)
        self.counters: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def count(self, name: str, inc: int = 1):
        self.counters[name] += inc

    def summary(self) -> dict:
        out = {}
        for k, v in self.samples.items():
            a = np.asarray(v) * 1e3
            out[k] = dict(n=len(a), mean_ms=float(a.mean()),
                          median_ms=float(np.median(a)),
                          p90_ms=float(np.percentile(a, 90)))
        out.update({f"count/{k}": v for k, v in self.counters.items()})
        return out

    def report(self) -> str:
        lines = []
        for k, s in sorted(self.summary().items()):
            if isinstance(s, dict):
                lines.append(f"{k:30s} n={s['n']:5d} median={s['median_ms']:8.2f}ms "
                             f"mean={s['mean_ms']:8.2f}ms p90={s['p90_ms']:8.2f}ms")
            else:
                lines.append(f"{k:30s} {s}")
        return "\n".join(lines)



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
# outside the tensor cores, bf16 on the tensor cores.
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12,
         "bf16_flops": 989e12}


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

