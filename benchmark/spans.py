"""The program's own spans on a profiled window's trace.

    python3 -m benchmark.spans --workload <cell> --seed <n> [<n> ...]
                               --seconds <s>

runs one cell's set-up and one window under torch.profiler with the
program's tracer (`sgslam_tpu_torch/utils/timing.Metrics`) on, once per
seed, and prints for each a JSON line: the window's counts, the seven
counts of `values` and the launches, synchronising calls and idle seconds
of each span (`split`). It is a diagnostic beside the benchmark's
command: the harness does not switch the tracer on, and no metric of
`BENCHMARK.json` reads these counts.

The tracer, while on, records each span (name, parent, request id,
frames, attributes) and opens a profiler range of the span's name.
`reduce` pairs the tracer's spans with those ranges (by name, in order;
the tracer's own Unix-epoch stamps where the counts differ) and puts
every kernel launch and every synchronising runtime call of the window
down to the innermost span whose range holds it on the host's timeline,
as `trace.reduce` does for `bench.k1s`: a kernel by its launch's
correlation id. A span's inclusive counts add its descendants'. The
device's idle gaps go to the innermost span the host was in when the gap
began.

Synchronising calls: any CUDA runtime or driver call whose name holds
"Synchronize" (`cudaStreamSynchronize`, `cudaDeviceSynchronize`,
`cudaEventSynchronize`; a blocking copy to or from pageable memory is a
`cudaMemcpyAsync` followed by a `cudaStreamSynchronize`), and the
synchronous `cudaMemcpy`.
"""

from __future__ import annotations

import argparse
import bisect
import json
import re
import statistics
import sys
from collections import defaultdict

import torch

from . import stats

_SUFFIX = re.compile(r"_v\d+$")


def is_sync(name: str) -> bool:
    base = _SUFFIX.sub("", name)
    return (base.startswith("cu") and "Synchronize" in base) or \
        base == "cudaMemcpy"


def _events(prof):
    return prof.profiler.kineto_results.events()


def reduce(prof, record):
    """The profiled half's trace and the tracer's record (`Metrics.record()`)
    -> a dict, or None without a record or without device events:

    spans: one dict per recorded span, in the order they opened (name,
        parent, children, rid, frames, attrs, launches, syncs: inclusive
        counts; self_launches, self_syncs, self_idle_s: the span's own);
    outside: launches, syncs and idle_s of the window that no span holds;
    sync_calls: {runtime call name: count} of the window;
    paired: whether every span met a range of its name;
    offset_ns: median of (tracer stamp - range start) over the pairs."""
    if record is None or prof is None:
        return None
    recs = record["spans"]
    names = {r.name for r in recs}
    cuda = torch.autograd.DeviceType.CUDA
    ranges = defaultdict(list)
    kernels, launch, host = [], {}, []
    window = None
    for e in _events(prof):
        name = e.name()
        if e.device_type() == cuda:
            if e.is_user_annotation() or name.startswith("bench."):
                continue
            s = e.start_ns()
            kernels.append((s, s + e.duration_ns(), name,
                            e.correlation_id()))
            continue
        if name == "bench.window":
            window = (e.start_ns(), e.end_ns())
        elif name in names and e.is_user_annotation():
            ranges[name].append((e.start_ns(), e.end_ns()))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
            if is_sync(name):
                host.append((e.start_ns(), name))
    if window is None or not kernels:
        return None
    w0, w1 = window
    kernels = [k for k in kernels if k[1] > w0 and k[0] < w1]

    # each span's interval on the trace's clock
    by_name = defaultdict(list)
    for i, r in enumerate(recs):
        by_name[r.name].append(i)
    iv = [(r.start_ns, r.start_ns if r.end_ns is None else r.end_ns)
          for r in recs]
    paired, offsets = True, []
    for name, idx in by_name.items():
        rs = sorted(ranges.get(name, []))
        if len(rs) != len(idx):
            paired = False
            continue
        for i, (a, b) in zip(idx, rs):
            offsets.append(recs[i].start_ns - a)
            iv[i] = (a, b)

    n = len(recs)
    self_l, self_s, self_idle = [0] * n, [0] * n, [0.0] * n
    outside = {"launches": 0, "syncs": 0, "idle_s": 0.0}
    calls = defaultdict(int)
    points = []       # (host time, kind, weight)
    for s, e, name, corr in kernels:
        t = launch.get(corr)
        if t is not None and not name.startswith(("Memcpy", "Memset")):
            points.append((t, 0, 1.0))
    for t, name in host:
        if w0 <= t <= w1:
            points.append((t, 1, 1.0))
            calls[name] += 1
    for a, b in stats.idle_gaps([(s, e) for s, e, _, _ in kernels], w0, w1):
        points.append((a, 2, (b - a) / 1e9))
    points.sort()

    # sweep: spans sorted by start hold a stack of the open ones, so the
    # top of the stack is the innermost span that holds a point
    order = sorted(range(n), key=lambda i: (iv[i][0], -iv[i][1]))
    starts = [iv[i][0] for i in order]
    stack, k = [], 0
    for t, kind, w in points:
        j = bisect.bisect_right(starts, t)
        while k < j:
            i = order[k]
            while stack and iv[stack[-1]][1] < iv[i][0]:
                stack.pop()
            stack.append(i)
            k += 1
        while stack and iv[stack[-1]][1] < t:
            stack.pop()
        if stack:
            i = stack[-1]
            if kind == 0:
                self_l[i] += 1
            elif kind == 1:
                self_s[i] += 1
            else:
                self_idle[i] += w
        else:
            key = ("launches", "syncs", "idle_s")[kind]
            outside[key] += w if kind == 2 else 1

    inc_l, inc_s = list(self_l), list(self_s)
    kids = [[] for _ in range(n)]
    for i in range(n - 1, -1, -1):
        p = recs[i].parent
        if p >= 0:
            inc_l[p] += inc_l[i]
            inc_s[p] += inc_s[i]
            kids[p].insert(0, i)
    spans = [{"name": r.name, "parent": r.parent, "children": kids[i],
              "rid": r.rid,
              "frames": r.frames, "attrs": r.attrs or {},
              "launches": inc_l[i], "syncs": inc_s[i],
              "self_launches": self_l[i], "self_syncs": self_s[i],
              "self_idle_s": self_idle[i]} for i, r in enumerate(recs)]
    return {"spans": spans, "outside": outside, "sync_calls": dict(calls),
            "paired": paired,
            "offset_ns": statistics.median(offsets) if offsets else None}


def holds(red, i, name) -> bool:
    """Whether span i has a descendant named `name`."""
    sp = red["spans"]
    todo = list(sp[i]["children"])
    while todo:
        j = todo.pop()
        if sp[j]["name"] == name:
            return True
        todo += sp[j]["children"]
    return False


def outermost(red, name, keep=None):
    """The spans named `name` with no ancestor of that name (so their
    inclusive counts add up without counting anything twice), those that
    `keep(index)` accepts."""
    sp = red["spans"]
    out = []
    for i, s in enumerate(sp):
        if s["name"] != name or (keep is not None and not keep(i)):
            continue
        p = s["parent"]
        while p >= 0 and sp[p]["name"] != name:
            p = sp[p]["parent"]
        if p < 0:
            out.append(i)
    return out


def frames(red, name):
    """The frames of the outermost spans named `name` (their `frames`)."""
    return sum(red["spans"][i]["frames"] or 0 for i in outermost(red, name))


def split(red) -> dict:
    """{span name: [launches, syncs, idle s]} of the spans' own counts,
    with "outside"; for the run's log."""
    out = defaultdict(lambda: [0, 0, 0.0])
    for s in red["spans"]:
        v = out[s["name"]]
        v[0] += s["self_launches"]
        v[1] += s["self_syncs"]
        v[2] += s["self_idle_s"]
    o = red["outside"]
    out["outside"] = [o["launches"], o["syncs"], o["idle_s"]]
    return {k: [v[0], v[1], round(v[2], 4)] for k, v in
            sorted(out.items(), key=lambda kv: -kv[1][0])}


def _per(total, n):
    return total / n if n else None


def values(kind: str, record, red) -> dict:
    """The seven counts of a window, {name: value or None}: of a chunked
    runner, per frame of its `runner.chunk` spans, the synchronising calls
    inside them (`syncs.chunked`), the kernels launched inside
    `front_end.extract` (`extract_launches.chunked`) and inside the
    `tracking.scan` spans of pass "track" (`track_launches.chunked`), and
    100 * `tracking.rescans` / `tracking.scans` (`rescans.chunked`); of a
    live runner, the synchronising calls per `runner.frame` span of a
    frame that inserted no keyframe (`syncs.live`), per `backend.insert`
    span that ran a back-end pass (`backend_syncs.live`), and
    `ba.lm_iters` / `ba.calls` (`ba_iters.live`). A span count is None
    without a reduction (a trace with no device events); a ratio is None
    where its denominator is 0."""
    counts = record["counts"] if record is not None else {}
    sp = red["spans"] if red is not None else []

    def total(key, idx):
        return sum(sp[i][key] for i in idx)

    if kind == "chunked":
        out = {"rescans.chunked": _per(
            100.0 * counts.get("tracking.rescans", 0),
            counts.get("tracking.scans", 0))}
        n = frames(red, "runner.chunk") if red is not None else 0
        track = outermost(red, "tracking.scan",
                          lambda i: sp[i]["attrs"].get("pass") == "track") \
            if red is not None else []
        out["syncs.chunked"] = _per(
            total("syncs", outermost(red, "runner.chunk")) if n else 0, n)
        out["extract_launches.chunked"] = _per(
            total("launches", outermost(red, "front_end.extract"))
            if n else 0, n)
        out["track_launches.chunked"] = _per(total("launches", track), n)
        return out
    if kind == "live":
        out = {}
        if red is not None:
            plain = outermost(red, "runner.frame",
                              lambda i: not holds(red, i, "backend.insert"))
            passes = outermost(red, "backend.insert",
                               lambda i: holds(red, i, "backend.ba"))
            out["syncs.live"] = _per(total("syncs", plain), len(plain))
            out["backend_syncs.live"] = _per(total("syncs", passes),
                                             len(passes))
        else:
            out["syncs.live"] = out["backend_syncs.live"] = None
        out["ba_iters.live"] = _per(counts.get("ba.lm_iters", 0),
                                    counts.get("ba.calls", 0))
        return out
    raise ValueError(f"no counts for the runner kind {kind!r}")


def program_tracer(runner):
    """The program's tracer behind a runner (`runners/<kind>.py`): the
    chunked tracker's or the `System`'s `metrics`, or None."""
    for attr in ("ct", "s"):
        obj = getattr(runner, attr, None)
        if obj is not None:
            return getattr(obj, "metrics", None)
    return None


def profile(spec, seed: int, seconds: float, device) -> dict:
    """One cell's set-up and one window of `seconds` under torch.profiler
    with the program's tracer on -> {"window": the runner's counts,
    "record": the tracer's record, "reduced": `reduce`'s dict or None,
    "values": `values`}."""
    from . import capture as capture_mod
    from . import traffic
    from .reference import config as ref_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    doc = spec.config
    r = doc["runner"]
    lead = int(r["boot_frames"]) + int(r["warm_frames"])
    n = traffic.frames_needed(spec.traffic, seconds, lead,
                              int(r.get("chunk", 1)))
    runner_mod = spec.runner()
    frames_ = traffic.render(spec.traffic, ref_config.from_file(doc).camera,
                             n, seed, device, views=runner_mod.Runner.views)
    runner = runner_mod.Runner(doc, frames_, device,
                               capture_mod.Capture(seed))
    try:
        runner.setup()
        tracer = program_tracer(runner)
        if tracer is None:
            raise RuntimeError("the program has no tracer")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        tracer.start()
        with torch.profiler.record_function("bench.window"):
            win = runner.window(seconds)
        tracer.stop()
        prof.stop()
        record = tracer.record()
        red = reduce(prof, record)
    finally:
        runner.close()
    return {"window": win, "record": record, "reduced": red,
            "values": values(runner_mod.Runner.kind, record, red)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)

    from . import core

    spec = core.Spec(core.load_bench(), a.workload)
    if not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    from sgslam_tpu_torch.utils.timing import card

    label = card(device)
    for seed in a.seed:
        out = profile(spec, seed, a.seconds, device)
        red = out["reduced"]
        win = {k: v for k, v in out["window"].items()
               if k not in ("frame_ms", "keyframe")}
        line = {"workload": a.workload, "seed": seed, "card": label,
                "window": win, "values": out["values"],
                "counts": out["record"]["counts"]}
        if red is not None:
            line.update(split=split(red), sync_calls=red["sync_calls"],
                        outside=red["outside"], paired=red["paired"],
                        offset_ns=red["offset_ns"])
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
