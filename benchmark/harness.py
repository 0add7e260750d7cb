"""One run of one cell: set-up, the measured window, the check, the line.

`run()` is the whole run on a device it is given; `run.py` is the measured
command, which refuses to run without a card. Tests call `run()` on the
CPU at a tiny size (a rehearsal: its numbers are host times, and it names
its device "cpu").
"""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from . import capture as capture_mod
from . import check, core, trace, traffic
from .reference import config as ref_config

DETECTOR_WEIGHTS = "sgslam_tpu/assets/detector.npz"


class Ctx:
    """What the metric readers read (`metrics/<name>.py`)."""

    def __init__(self, kind, setup_s, window, stages=(), backend=(),
                 summary=None, bounds=None):
        self.kind = kind
        self.setup_s = setup_s
        self.window = window
        self.stages = list(stages)
        self.backend = list(backend)
        self.trace = summary
        self.bounds = bounds

    def stage_ms(self, names, frames=None):
        """Summed ms of the named stages, over the frames (tags) given."""
        return sum(ms for n, ms, tag in self.stages
                   if n in names and (frames is None or tag in frames))

    def plain_frames(self):
        """Window frame indices that inserted no keyframe (live)."""
        w = self.window
        return {w["first"] + k for k, kf in enumerate(w["keyframe"])
                if not kf}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(spec: core.Spec, seed: int, seconds: float, trace_on: bool,
        device, t0: float, control: bool = False):
    """The run; returns (result line dict, check lines, extra) where extra
    holds the window's counts and, with `control`, the control's and the
    program's readings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    doc = spec.config
    runner_mod = spec.runner()
    rcfg = ref_config.from_file(doc)
    r = doc["runner"]
    lead = int(r["boot_frames"]) + int(r["warm_frames"])
    n = traffic.frames_needed(spec.traffic, seconds, lead,
                              int(r.get("chunk", 1)))
    t_render = time.perf_counter()
    frames = traffic.render(spec.traffic, rcfg.camera, n, seed, device,
                            views=runner_mod.Runner.views)
    t_built = time.perf_counter()
    print(f"set-up: {n} frames rendered in {t_built - t_render:.2f} s, "
          f"{t_render - t0:.2f} s before", file=sys.stderr, flush=True)
    cap = capture_mod.Capture(seed)
    cap.install()
    try:
        runner = runner_mod.Runner(doc, frames, device, cap)
        runner.setup()
        stages = backend = spans = None
        if trace_on:
            stages = trace.Stages(device)
            backend = trace.Stages(device, ranges=False, follow=stages)
            runner.hook(stages, backend)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        setup_s = time.perf_counter() - t0
        print(f"set-up: program built and warmed in "
              f"{t0 + setup_s - t_built:.2f} s; set-up {setup_s:.2f} s",
              file=sys.stderr, flush=True)
        cap.armed = True
        prof = None
        if not trace_on:
            win = runner.window(seconds)
        else:
            # the first half times the stages by CUDA events alone; the
            # second half runs under the profiler, whose host overhead
            # would stretch the stages
            win = runner.window(seconds / 2, stages)
            stages.close()
            offset = len(stages.closing)
            spans = capture_mod.Spans()
            spans.install()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            with torch.profiler.record_function("bench.window"):
                win2 = runner.window(seconds / 2, stages)
            stages.close()
            prof.stop()
        cap.armed = False
        mem = (torch.cuda.max_memory_allocated(device)
               if device.type == "cuda" else 0)
        traj = runner.trajectory()
        summary = bounds = None
        durations, backend_ms = [], []
        if trace_on:
            runner.hook(None, None)
            spans.uninstall()
            part1 = range(win["first"], win["end"])
            durations = [d for d in stages.durations() if d[2] in part1]
            backend_ms = [d for d in backend.durations() if d[2] in part1]
            if device.type == "cuda":
                summary = trace.reduce(prof,
                                       closing=stages.closing[offset:])
                if summary is not None:
                    summary["frames"] = win2["frames"]
            bounds = spans.bounds()
        prof = None
        runner.close()
        runner = None
    finally:
        cap.uninstall()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ctx = Ctx(runner_mod.Runner.kind, setup_s, win, durations, backend_ms,
              summary, bounds)
    names = spec.metric_names(trace_on)
    units = spec.units()
    metrics = {}
    for name in names:
        v = spec.reader(name)(ctx)
        if v is not None:
            metrics[name] = {"value": v, "unit": units[name]}

    # the check: the sampled calls against the reference, the trajectory
    # against the ground truth
    judge = check.Judge(rcfg, str(core.REPO / DETECTOR_WEIGHTS), device)
    values = judge.numbers(cap)
    last = win2 if trace_on else win
    w0, w1 = win["first"], last["end"]
    values["ate_m"] = check.ate(traj[w0:w1], frames.T_wc[w0:w1])
    limits = dict(spec.limits["limits"])
    limits["ate_m"] = doc["guarantees"]["ate_rmse_m"]
    ok, checks = check.verdict(values, limits)
    extra = {"window": {k: v for k, v in win.items()
                        if k not in ("frame_ms", "keyframe")}}
    if trace_on:
        extra["traced"] = {k: v for k, v in win2.items()
                           if k not in ("frame_ms", "keyframe")}
    if control:
        extra["control"] = judge.numbers(cap, control=True)
        extra["program"] = values
    found = core.forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(mem)}
    if trace_on:
        if summary is not None:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
    parts = [win, win2] if trace_on else [win]
    result = {"correct": bool(ok),
              "attempted": sum(int(w["frames"]) for w in parts),
              "failed": sum(int(w["lost"]) for w in parts),
              "metrics": metrics, "device": dev}
    if trace_on and summary is not None:
        result["breakdown"] = trace.breakdown(summary)
    result["checks"] = checks
    lines = [f"check {k}: {_fmt(c['value'])} (limit {_fmt(c['limit'])})"
             for k, c in checks.items()]
    return result, lines, extra


def _fmt(v):
    if v is None:
        return "none"
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    return repr(v)


def tiny(spec: core.Spec, width: int = 320) -> core.Spec:
    """A copy of `spec` at a size a CPU rehearsal holds: the camera scaled
    by s = width / its width (fx, fy and bf times s, so a stereo camera
    keeps its baseline; cx' + 0.5 = (cx + 0.5) * s and cy alike, pixel
    centres kept; the height times s, rounded), fewer features, map slots,
    a short warm-up and frequent keyframes."""
    import copy

    s = copy.copy(spec)
    d = copy.deepcopy(spec.config)
    c = d["camera"]
    w0 = c["width"]
    c.update(fx=c["fx"] * width / w0, fy=c["fy"] * width / w0,
             cx=(c["cx"] + 0.5) * width / w0 - 0.5,
             cy=(c["cy"] + 0.5) * width / w0 - 0.5,
             bf=c["bf"] * width / w0, width=width,
             height=round(c["height"] * width / w0))
    d["orb"].update(n_features=600, max_keypoints=640)
    d["capacity"].update(max_keyframes=48, max_points=8192,
                         max_obs_per_kf=640, local_window=4,
                         local_points=1024)
    d["tracker"].update(max_frames_between_kf=3)
    d["mapping"].update(grid_dim=64, max_points_per_kf=2048)
    d["runner"].update(boot_frames=4, warm_frames=4)
    s.config = d
    return s
