"""Per-stage timing + metrics registry, and a profiler trace context.

Own copy of `sgslam_tpu/utils/timing.py` (`Metrics`, numpy only), with
`xla_trace` as a `torch.profiler` trace of the same shape. The timers read
the host clock: on the GPU they time the host's enqueue of a stage unless
the stage ends in a host read or a synchronize.
"""

from __future__ import annotations

import contextlib
import os
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
