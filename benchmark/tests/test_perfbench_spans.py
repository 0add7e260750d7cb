"""`benchmark/spans.py`: the reduction on a hand-made trace (kernels put
down to the innermost span by their launch, synchronising calls, idle
gaps, spans paired with their ranges), the arithmetic of its seven counts,
and profiled CPU rehearsals of both cells, where the trace has no device
events: the counters give numbers, the span counts nothing."""

import time

import pytest
import torch

from benchmark import core, harness, spans
from sgslam_tpu_torch.utils import timing

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Ev:
    """One kineto event as `spans.reduce` reads it."""

    def __init__(self, name, start, end=None, dev=CPU, corr=0,
                 annotation=False):
        self._n, self._s, self._e = name, start, start if end is None else end
        self._d, self._c, self._a = dev, corr, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._a


class Prof:
    def __init__(self, events):
        class R:
            def events(self):
                return events

        class P:
            kineto_results = R()

        self.profiler = P()


def _record():
    """A tracer record: two chunk spans, the first with an extraction and
    a scan of pass "track" holding two steps, the second with a scan of
    pass "retrack1"."""
    m = timing.Metrics()
    m.start()
    m.count("tracking.scans", 3)
    m.count("tracking.rescans")
    with m.span("runner.chunk", rid=10, frames=4):
        with m.span("front_end.extract"):
            pass
        with m.span("tracking.scan", attrs={"pass": "track"}):
            with m.span("tracking.step"):
                pass
            with m.span("tracking.step"):
                pass
    with m.span("runner.chunk", rid=14, frames=4):
        with m.span("tracking.scan", attrs={"pass": "retrack1"}):
            pass
    return m.record()


# the ranges the profiler saw (its own clock: 1000 ns per unit), in the
# order [chunk, extract, scan, step, step, chunk, scan]
RANGES = [("runner.chunk", 0, 100), ("front_end.extract", 5, 30),
          ("tracking.scan", 35, 90), ("tracking.step", 40, 60),
          ("tracking.step", 60, 80), ("runner.chunk", 120, 200),
          ("tracking.scan", 130, 180)]


def _trace(record, launches, syncs, kernels):
    ev = [Ev("bench.window", 0, 250_000)]
    ev += [Ev(n, a * 1000, b * 1000, annotation=True) for n, a, b in RANGES]
    for k, t in enumerate(launches):
        ev.append(Ev("cudaLaunchKernel", t * 1000, corr=k + 1))
    for t, name in syncs:
        ev.append(Ev(name, t * 1000, corr=1000 + t))
    for k, (a, b) in enumerate(kernels):
        ev.append(Ev("kern", a * 1000, b * 1000, dev=CUDA, corr=k + 1))
    return Prof(ev)


def _reduced():
    rec = _record()
    # launches: extract, extract, step 1, step 2, scan (not in a step),
    # chunk 2's scan, outside any span
    launches = [10, 20, 45, 65, 85, 150, 110]
    syncs = [(25, "cudaStreamSynchronize"), (50, "cudaStreamSynchronize"),
             (95, "cudaEventSynchronize"),
             (160, "cudaStreamSynchronize_v3020"), (190, "cudaMemcpy"),
             (205, "cudaDeviceSynchronize"), (170, "cudaMemcpyAsync"),
             (175, "cudaStreamQuery")]
    kernels = [(12, 14), (22, 24), (47, 49), (66, 70), (86, 88),
               (151, 152), (111, 112)]
    return rec, spans.reduce(_trace(rec, launches, syncs, kernels), rec)


def test_is_sync():
    assert spans.is_sync("cudaStreamSynchronize")
    assert spans.is_sync("cudaDeviceSynchronize")
    assert spans.is_sync("cudaEventSynchronize_v3020")
    assert spans.is_sync("cudaMemcpy")
    assert not spans.is_sync("cudaMemcpyAsync")
    assert not spans.is_sync("cudaLaunchKernel")
    assert not spans.is_sync("cudaStreamWaitEvent")


def test_reduce_puts_each_call_in_its_innermost_span():
    rec, red = _reduced()
    assert red["paired"]
    sp = red["spans"]
    got = [(s["name"], s["self_launches"], s["self_syncs"], s["launches"],
            s["syncs"]) for s in sp]
    assert got == [("runner.chunk", 0, 1, 5, 3),
                   ("front_end.extract", 2, 1, 2, 1),
                   ("tracking.scan", 1, 0, 3, 1),
                   ("tracking.step", 1, 1, 1, 1),
                   ("tracking.step", 1, 0, 1, 0),
                   ("runner.chunk", 0, 1, 1, 2),
                   ("tracking.scan", 1, 1, 1, 1)]
    assert red["outside"]["launches"] == 1
    assert red["outside"]["syncs"] == 1
    assert red["sync_calls"] == {"cudaStreamSynchronize": 2,
                                 "cudaEventSynchronize": 1,
                                 "cudaStreamSynchronize_v3020": 1,
                                 "cudaMemcpy": 1, "cudaDeviceSynchronize": 1}
    assert [s["children"] for s in sp] == [[1, 2], [], [3, 4], [], [], [6],
                                           []]
    assert sp[0]["rid"] == 10 and sp[3]["rid"] == 10 and sp[5]["rid"] == 14
    # the idle gaps: each goes to the span the host was in as it began
    idle = sum(s["self_idle_s"] for s in sp) + red["outside"]["idle_s"]
    assert idle == pytest.approx((250 - 14) * 1e-6)
    assert sp[1]["self_idle_s"] == pytest.approx((8 + 23) * 1e-6)
    split = spans.split(red)
    assert split["front_end.extract"][:2] == [2, 1]
    assert split["outside"][:2] == [1, 1]


def test_reduce_without_device_events_or_record():
    rec = _record()
    assert spans.reduce(_trace(rec, [10], [], []), rec) is None
    assert spans.reduce(_trace(rec, [10], [], [(12, 14)]), None) is None


def test_unpaired_spans_fall_back_to_their_stamps():
    rec = _record()
    prof = _trace(rec, [10], [], [(12, 14)])
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() != "tracking.step"]
    red = spans.reduce(Prof(events), rec)
    assert not red["paired"]


def test_chunked_values():
    rec, red = _reduced()
    got = spans.values("chunked", rec, red)
    assert got == {"syncs.chunked": 5 / 8,
                   "extract_launches.chunked": 2 / 8,
                   "track_launches.chunked": 3 / 8,
                   "rescans.chunked": 100 / 3}
    assert spans.values("chunked", None, None) == dict.fromkeys(got)
    assert spans.values("chunked", rec, None) == {
        **dict.fromkeys(got), "rescans.chunked": 100 / 3}


def test_live_values():
    m = timing.Metrics()
    m.start()
    m.count("ba.calls", 2)
    m.count("ba.lm_iters", 31)
    with m.span("runner.frame", rid=0, frames=1):
        pass
    with m.span("runner.frame", rid=1, frames=1):
        with m.span("backend.insert"):
            with m.span("backend.ba"):
                pass
    with m.span("runner.frame", rid=2, frames=1):
        pass
    rec = m.record()
    spans_ = ["runner.frame", "runner.frame", "backend.insert", "backend.ba",
              "runner.frame"]
    red = {"spans": [{"name": n, "parent": s.parent, "children": c,
                      "frames": s.frames, "attrs": {}, "syncs": y}
                     for n, s, c, y in zip(spans_, rec["spans"],
                                           [[], [2], [3], [], []],
                                           [4, 30, 29, 20, 6])]}
    assert spans.values("live", rec, red) == {"syncs.live": (4 + 6) / 2,
                                              "backend_syncs.live": 29,
                                              "ba_iters.live": 15.5}
    assert spans.values("live", None, None) == {
        "syncs.live": None, "backend_syncs.live": None,
        "ba_iters.live": None}
    with pytest.raises(ValueError):
        spans.values("stream", rec, red)


@pytest.mark.parametrize("cell,counted", [
    ("chunked.slow_walker", {"rescans.chunked"}),
    ("live.walkers_fastrot", {"ba_iters.live"})])
def test_profiled_rehearsal_reads_the_program(cell, counted):
    """On the CPU the trace has no device events: the span counts give
    nothing, the counters a number, and the tracer is off again after."""
    spec = harness.tiny(core.Spec(core.load_bench(), cell))
    torch.set_num_threads(4)
    out = spans.profile(spec, 2 ** 32 + 99, 2.5, torch.device("cpu"))
    assert out["reduced"] is None
    assert out["window"]["frames"] > 0
    assert {k for k, v in out["values"].items() if v is not None} == counted
    for name in counted:
        assert out["values"][name] >= 0
    names = {s.name for s in out["record"]["spans"]}
    outer = "runner.chunk" if cell.startswith("chunked") else "runner.frame"
    assert outer in names and "front_end.extract" in names


def test_cli_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert spans.main(["--workload", "chunked.slow_walker", "--seed", "1",
                       "--seconds", "1"]) == 2
