"""The traced run's instruments: CUDA events at the program's stage marks,
profiler ranges that label the host's stages, and the reduction of the
profiler's trace to busy time, launches, the kernels' device time inside
their ranges, and a breakdown.

Stage marks: the program calls its hook with a stage's name after the
stage (and "begin" first). `Stages` records a CUDA event at each mark, so
a stage's time is the device time between its mark and the previous one,
and opens a profiler range `bench.stage` at each mark, which the next mark
closes; the closing mark names what the host did in it.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

from . import stats


class Stages:
    """Marks of one hook, in order: [(name, event or host time, tag)],
    where tag is the frame the runner handed over last (or, with
    `follow`, the tag of another hook's marks)."""

    def __init__(self, device, ranges: bool = True, follow=None):
        self.cuda = torch.device(device).type == "cuda"
        self.follow = follow
        self.marks = []
        self.closing = []
        self.ranges = ranges
        self._range = None
        self.tag = None

    def __call__(self, name: str):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
        else:
            e = time.perf_counter()
        tag = self.follow.tag if self.follow is not None else self.tag
        self.marks.append((name, e, tag))
        if self.ranges:
            if self._range is not None:
                self._range.__exit__(None, None, None)
                self.closing.append(name)
            self._range = torch.profiler.record_function("bench.stage")
            self._range.__enter__()

    def close(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self.closing.append("outside")
            self._range = None

    def durations(self):
        """[(stage, ms, tag)]: each mark after the first of its run, with
        the time since the previous mark ("begin" starts a run)."""
        if self.cuda:
            torch.cuda.synchronize()
        out = []
        for (n0, e0, _), (n1, e1, tag) in zip(self.marks, self.marks[1:]):
            if n1 == "begin":
                continue
            ms = (e0.elapsed_time(e1) if self.cuda
                  else (e1 - e0) * 1e3)
            out.append((n1, ms, tag))
        return out


def _events(prof):
    return prof.profiler.kineto_results.events()


SPANS = ("bench.k1s", "bench.segsum")


def reduce(prof, closing=()):
    """The trace of one profiled window -> a dict with busy_s, window_s
    (the `bench.window` range), kernels (count), ops ({name: seconds}),
    span_device_s ({span: device seconds launched inside its ranges}),
    span_calls, idle_by_stage ({label: seconds}); `closing` names the
    `bench.stage` ranges in order (`Stages.closing`)."""
    cuda = torch.autograd.DeviceType.CUDA
    gpu, launch = [], {}
    ranges = defaultdict(list)
    window = None
    for e in _events(prof):
        name = e.name()
        if e.device_type() == cuda:
            if e.is_user_annotation() or name.startswith("bench."):
                continue
            s = e.start_ns()
            gpu.append((s, s + e.duration_ns(), name, e.correlation_id()))
            continue
        if name == "bench.window":
            window = (e.start_ns(), e.end_ns())
        elif name.startswith("bench."):
            ranges[name].append((e.start_ns(), e.end_ns()))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
    if window is None or not gpu:
        return None
    w0, w1 = window
    gpu = [g for g in gpu if g[1] > w0 and g[0] < w1]
    busy = stats.union_ns((max(s, w0), min(e, w1)) for s, e, _, _ in gpu)
    ops = defaultdict(float)
    kernels = 0
    for s, e, name, _ in gpu:
        ops[name] += (e - s) / 1e9
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
    span_s, span_calls = {}, {}
    for sp in SPANS:
        rs = sorted(ranges.get(sp, []))
        starts = [r[0] for r in rs]
        total = 0.0
        for s, e, _, corr in gpu:
            t = launch.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= rs[i][1]:
                total += (e - s) / 1e9
        span_s[sp] = total
        span_calls[sp] = len(rs)
    stage = sorted(ranges.get("bench.stage", []))
    labels = list(closing) + ["outside"] * max(0, len(stage) - len(closing))
    starts = [r[0] for r in stage]
    idle = defaultdict(float)
    for a, b in stats.idle_gaps([(s, e) for s, e, _, _ in gpu], w0, w1):
        i = bisect.bisect_right(starts, a) - 1
        label = (labels[i] if i >= 0 and a <= stage[i][1] else "outside")
        idle["outside" if label == "begin" else label] += (b - a) / 1e9
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "kernels": kernels, "ops": dict(ops), "span_device_s": span_s,
            "span_calls": span_calls, "idle_by_stage": dict(idle)}


def breakdown(summary: dict) -> dict:
    """The line's `breakdown`: the device operations that took most time
    and the idle time by what the host was doing, ten of each."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(summary["idle_by_stage"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle[:10]]}
