"""The port's tracer (`utils/timing.Metrics`) through its facades, on the
CPU at 320x240.

  * off (the default), a span is one shared null context: a run records
    no span, opens no profiler range and makes no CUDA event;
  * on, the spans nest with the right parents and request ids through
    `System.track_rgbd`, a `ChunkedSemanticTracker` chunk that inserts a
    keyframe, and `process_new_keyframe`;
  * the stage hooks receive the marks they received before the tracer
    existed, off and on: the golden lists below were recorded from the
    parent tree on this fixture (one torch thread);
  * a span's Unix-epoch stamp meets its profiler range's `start_ns()`;
  * `ba.lm_iters` counts the LM iterations local BA ran, early exit
    included, and `tracking.rescans` a forced fallback.
"""

import numpy as np
import pytest
import torch

from sgslam_tpu_torch import config as C
from sgslam_tpu_torch.geometry import camera, se3
from sgslam_tpu_torch.io.synthetic import SyntheticSequence
from sgslam_tpu_torch.models.detector import Detector2D
from sgslam_tpu_torch.optim import local_ba
from sgslam_tpu_torch.slam import scan_pipeline, tracking
from sgslam_tpu_torch.slam.loop_closing import LoopCloser
from sgslam_tpu_torch.slam.system import System
from sgslam_tpu_torch.utils import timing

N = 14          # frames rendered
N_SYSTEM = 8    # frames through System.track_rgbd
CHUNK = 4

_FRAME = ["begin", "detector", "extract", "cull", "track"]
_KF = ["loop_closing", "mapping"]
_PASS = ["begin", "cull", "triangulate", "fuse", "ba", "kf_cull"]
_CHUNK = ["begin", "extract", "detector", "cull", "track"]
# the hooks' marks on this fixture at the parent commit
GOLDEN = {
    "system": (_FRAME + _KF) * 3 + _FRAME + _FRAME + _KF + _FRAME * 3 + _KF,
    "backend": _PASS * 4,
    "chunk": (_CHUNK + ["insert1", "retrack1"]
              + _CHUNK + ["insert1", "retrack1", "insert2", "retrack2"]
              + _CHUNK + ["insert1", "retrack1"]),
    "chunk_loop": ["begin", "loop_closing"] * 4,
}


def _cfg(**tracker):
    return C.synthetic_config(
        width=320, height=240,
        orb=C.OrbConfig(n_features=600, max_keypoints=640),
        tracker=C.TrackerConfig(max_frames_between_kf=3,
                                depth_threshold_factor=70.0, **tracker),
        capacity=C.MapCapacity(max_keyframes=48, max_points=8192,
                               local_window=4, local_points=1024))


CFG = _cfg()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence(CFG.camera, n_frames=N, dynamic=True,
                            device="cpu")
    return [seq.frame(i) for i in range(N)]


@pytest.fixture(scope="module")
def detector():
    return Detector2D(CFG.detector, device="cpu")


def _run(frames, det, on: bool, chunks: int = 3, cfg=CFG):
    """System over N_SYSTEM frames and a ChunkedSemanticTracker over
    `chunks` chunks, every hook recording; the tracers on or off."""
    hooks = {k: [] for k in GOLDEN}
    s = System(cfg, detector=det, device="cpu")
    s.on_stage = hooks["system"].append
    s.tracker.on_backend_stage = hooks["backend"].append
    if on:
        s.metrics.start()
    for g, d in frames[:N_SYSTEM]:
        s.track_rgbd(g, d, rgb=g[..., None].expand(-1, -1, 3))
    ct = scan_pipeline.ChunkedSemanticTracker(
        cfg, det, chunk=CHUNK, fetch_every=2,
        loop=LoopCloser(cfg, device="cpu"), device="cpu")
    ct.on_chunk_stage = hooks["chunk"].append
    ct.on_stage = hooks["chunk_loop"].append
    if on:
        ct.metrics.start()
    i = 0
    while ct._carry is None or i < 2:
        ct.bootstrap(*frames[i])
        i += 1
    for _ in range(chunks):
        fr = frames[i:i + CHUNK]
        ct.process_chunk(torch.stack([f[0] for f in fr]),
                         torch.stack([f[1] for f in fr]))
        i += CHUNK
    ct.flush()
    return dict(hooks=hooks, system=s, chunked=ct, boot=i - chunks * CHUNK)


@pytest.fixture(scope="module")
def plain(frames, detector):
    """The run with the tracers off, profiler ranges and CUDA events
    counted."""
    made = {"range": 0, "event": 0}
    real_range = torch.profiler.record_function
    real_event = torch.cuda.Event

    def rng(*a, **kw):
        made["range"] += 1
        return real_range(*a, **kw)

    def event(*a, **kw):
        made["event"] += 1
        return real_event(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", rng)
        mp.setattr(torch.cuda, "Event", event)
        out = _run(frames, detector, on=False)
    out["made"] = made
    return out


@pytest.fixture(scope="module")
def traced(frames, detector):
    return _run(frames, detector, on=True)


def test_off_span_is_one_shared_null_context():
    m = timing.Metrics()
    assert not m.on
    a, b = m.span("x"), m.span("tracking.scan", rid=3, frames=4)
    assert a is b
    with a:
        pass
    assert m.spans == [] and m.record() == {"spans": [], "counts": {}}


def test_off_run_records_nothing(plain):
    assert plain["made"] == {"range": 0, "event": 0}
    for key in ("system", "chunked"):
        m = plain[key].metrics
        assert m.spans == [] and not m.on
    assert plain["system"].metrics.counters["frames"] == N_SYSTEM
    assert plain["chunked"].metrics.counters["frames"] == (
        plain["boot"] + 3 * CHUNK)


@pytest.mark.parametrize("hook", sorted(GOLDEN))
@pytest.mark.parametrize("run", ["plain", "traced"])
def test_hooks_receive_the_parent_marks(request, run, hook):
    got = request.getfixturevalue(run)["hooks"][hook]
    assert got == GOLDEN[hook]


def _spans(m):
    return m.record()["spans"]


def _parent(sp, s):
    return sp[s.parent].name if s.parent >= 0 else None


def test_system_spans_nest(traced):
    s = traced["system"]
    sp = _spans(s.metrics)
    assert all(x.end_ns is not None and x.end_ns >= x.start_ns for x in sp)
    frames = [x for x in sp if x.name == "runner.frame"]
    assert [x.rid for x in frames] == list(range(N_SYSTEM))
    assert all(x.parent == -1 and x.frames == 1 for x in frames)
    want = {"semantic.detector": "runner.frame",
            "front_end.extract": "runner.frame",
            "semantic.cull": "runner.frame",
            "tracking.step": "runner.frame",
            "backend.insert": "runner.frame",
            "loop.detect": "runner.frame",
            "mapping": "runner.frame",
            "tracking.local_points": "tracking.step",
            "tracking.search": "tracking.step",
            "tracking.pose_opt": "tracking.step",
            "backend.cull": "backend.insert",
            "backend.triangulate": "backend.insert",
            "backend.fuse": "backend.insert",
            "backend.ba": "backend.insert",
            "backend.kf_cull": "backend.insert",
            "backend.lm_iter": "backend.ba"}
    assert {x.name for x in sp} == set(want) | {"runner.frame"}
    for x in sp:
        if x.name != "runner.frame":
            assert _parent(sp, x) == want[x.name], x.name
            assert x.rid == sp[x.parent].rid
    steps = [x for x in sp if x.name == "tracking.step"]
    assert len(steps) == N_SYSTEM - 1          # the first frame initializes
    for x in steps:
        kids = [y.name for y in sp if y.parent == sp.index(x)]
        assert kids[:1] == ["tracking.local_points"]
        assert kids.count("tracking.search") >= 2
        assert kids.count("tracking.pose_opt") >= 2
    # one back-end pass per insertion after the first, and its marks
    inserts = [x for x in sp if x.name == "backend.insert"]
    assert len(inserts) == s.metrics.counters["keyframes"] == 5
    assert sum(x.name == "backend.ba" for x in sp) == 4
    counts = s.metrics.record()["counts"]
    assert counts["frames"] == N_SYSTEM
    assert counts["ba.lm_iters"] == sum(x.name == "backend.lm_iter"
                                        for x in sp)


def test_chunk_spans_nest(traced):
    ct = traced["chunked"]
    sp = _spans(ct.metrics)
    boot = traced["boot"]
    top = [x for x in sp if x.parent == -1]
    assert [x.name for x in top] == (["runner.frame"] * boot
                                     + ["runner.chunk"] * 3
                                     + ["runner.flush"])
    chunks = [x for x in top if x.name == "runner.chunk"]
    assert [(x.rid, x.frames) for x in chunks] == [
        (boot + CHUNK * k, CHUNK) for k in range(3)]
    for c in chunks:
        ci = sp.index(c)
        kids = [y for y in sp if y.parent == ci]
        names = [y.name for y in kids]
        assert names[:4] == ["front_end.extract", "semantic.detector",
                             "semantic.cull", "tracking.scan"]
        assert all(y.rid == c.rid for y in kids
                   if y.name not in ("tracking.scan", "backend.insert"))
        scans = [y for y in kids if y.name == "tracking.scan"]
        assert scans[0].attrs == {"pass": "track", "fallback": False}
        assert scans[0].rid == c.rid and scans[0].frames == CHUNK
        for y in scans:
            steps = [z for z in sp if z.parent == sp.index(y)]
            assert [z.name for z in steps] == ["tracking.step"] * y.frames
            assert [z.rid for z in steps] == list(range(y.rid,
                                                        y.rid + y.frames))
        for y in kids:
            if y.name == "backend.insert":
                assert c.rid <= y.rid < c.rid + CHUNK
                inner = [z.name for z in sp if z.parent == sp.index(y)]
                assert inner == ["backend.cull", "backend.triangulate",
                                 "backend.fuse", "backend.ba",
                                 "backend.kf_cull"]
    passes = [x.attrs["pass"] for x in sp if x.name == "tracking.scan"]
    assert passes == ["track", "retrack1", "track", "retrack1", "retrack2",
                      "track", "retrack1"]
    # the drain (every second chunk) holds the keyframes' loop detection
    drains = [x for x in sp if x.name == "runner.drain"]
    assert [_parent(sp, x) for x in drains] == ["runner.chunk",
                                                "runner.flush"]
    assert all(_parent(sp, x) in ("runner.drain", "runner.frame",
                                  "runner.flush")
               for x in sp if x.name == "loop.detect")
    counts = ct.metrics.record()["counts"]
    assert counts["frames"] == boot + 3 * CHUNK
    assert counts["tracking.scans"] == len(passes)
    assert counts.get("tracking.rescans", 0) == 0


def test_process_new_keyframe_spans(traced):
    s = traced["system"]
    m = timing.Metrics()
    m.start()
    marks = []
    with timing.tracing(m), m.span("backend.insert", rid=41):
        tracking.process_new_keyframe(CFG, s.tracker.map,
                                      s.tracker.last_kf_id,
                                      on_stage=marks.append)
    sp = _spans(m)
    assert marks == _PASS
    assert [(x.name, _parent(sp, x)) for x in sp
            if x.name != "backend.lm_iter"] == [
        ("backend.insert", None), ("backend.cull", "backend.insert"),
        ("backend.triangulate", "backend.insert"),
        ("backend.fuse", "backend.insert"), ("backend.ba", "backend.insert"),
        ("backend.kf_cull", "backend.insert")]
    assert {x.rid for x in sp} == {41}
    assert all(_parent(sp, x) == "backend.ba" for x in sp
               if x.name == "backend.lm_iter")


def test_stamps_meet_the_profiler_ranges():
    m = timing.Metrics()
    m.start()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for k in range(5):
            with m.span("runner.frame", rid=k), m.span("tracking.search"):
                torch.ones(64).sum()
    got = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("runner.frame", "tracking.search"):
            got.setdefault(e.name(), []).append(e.start_ns())
    for name in ("runner.frame", "tracking.search"):
        stamps = [x.start_ns for x in _spans(m) if x.name == name]
        assert len(stamps) == len(got[name]) == 5
        for a, b in zip(stamps, sorted(got[name])):
            assert abs(a - b) < 1_000_000, (name, a - b)


def _ba_problem(seed=0, n_cams=4, n_pts=128, n_obs=256):
    """A small stereo BA problem, as tests/test_torch_local_ba.py builds
    them, with the port's own geometry."""
    rng = np.random.default_rng(seed)
    cam = C.tum3_config().camera

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32)

    xi = f32(0.2 * np.arange(n_cams)[:, None]
             * np.array([[1, 0.2, 0.1, 0.05, 0.1, 0.02]]))
    poses_gt = se3.se3_exp(xi)
    pts = f32(rng.uniform([-2, -2, 2], [2, 2, 6], size=(n_pts, 3)))
    obs_pt = torch.tensor(rng.integers(0, n_pts, size=(n_cams, n_obs)),
                          dtype=torch.int32)
    uvr = camera.project_stereo(
        cam, se3.se3_apply(poses_gt[:, None, :], pts[obs_pt.long()])).clone()
    uvr[..., :2] += f32(rng.normal(scale=0.3, size=(n_cams, n_obs, 2)))
    poses0 = se3.se3_compose(
        se3.se3_exp(f32(0.03 * rng.normal(size=(n_cams, 6)))), poses_gt)
    poses0[0] = poses_gt[0]
    w = torch.ones((n_cams, n_obs))
    w[:, -16:] = 0.0
    return cam, local_ba.BAProblem(
        poses=poses0, opt_mask=torch.tensor([False] + [True] * (n_cams - 1)),
        points=pts + f32(0.05 * rng.normal(size=(n_pts, 3))),
        obs_pt=obs_pt, obs_uvr=uvr, obs_w=w)


@pytest.mark.parametrize("tol", [1e-3, 0.0])
def test_ba_lm_iters_counts_what_ran(monkeypatch, tol):
    """Each LM iteration evaluates the residuals twice, and the call twice
    more (the gating between phases and the final inlier test): the
    iterations that ran are (evaluations - 2) / 2. At tol 1e-3 a phase
    exits early; at 0 the whole budget runs."""
    cam, prob = _ba_problem()
    evals = [0]
    real = local_ba._residual_jac

    def counted(*a, **kw):
        evals[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(local_ba, "_residual_jac", counted)
    m = timing.Metrics()
    m.start()
    with timing.tracing(m):
        local_ba.bundle_adjust(cam, prob, iters1=5, iters2=10, tol=tol)
    ran = (evals[0] - 2) // 2
    counts = m.record()["counts"]
    assert counts == {"ba.calls": 1, "ba.lm_iters": ran}
    assert sum(x.name == "backend.lm_iter" for x in _spans(m)) == ran
    assert ran < 15 if tol > 0 else ran == 15


def test_rescans_count_a_forced_fallback(frames):
    """With the fallback wanted on every frame (`min_matches_motion` above
    any match count), every scan pass runs again with it selected."""
    cfg = _cfg(min_matches_motion=10 ** 6)
    ct = scan_pipeline.ChunkedTracker(cfg, chunk=CHUNK, fetch_every=2,
                                      device="cpu")
    ct.metrics.start()
    i = 0
    while ct._carry is None or i < 2:
        ct.bootstrap(*frames[i])
        i += 1
    fr = frames[i:i + CHUNK]
    ct.process_chunk(torch.stack([f[0] for f in fr]),
                     torch.stack([f[1] for f in fr]))
    ct.flush()
    counts = ct.metrics.record()["counts"]
    scans = [(x.attrs["pass"], x.attrs["fallback"], x.frames)
             for x in _spans(ct.metrics) if x.name == "tracking.scan"]
    assert counts["tracking.scans"] == len(scans)
    assert counts["tracking.rescans"] == sum(fb for _, fb, _ in scans) >= 1
    assert scans[:2] == [("track", False, CHUNK), ("track", True, CHUNK)]
    # a pass over frames runs again with the fallback; an empty one does
    # not (no frame wanted it)
    k = 0
    while k < len(scans):
        name, fb, n = scans[k]
        assert not fb
        if n:
            assert scans[k + 1] == (name, True, n)
            k += 1
        k += 1


def test_tracing_restores_the_active_tracer():
    outer, inner = timing.Metrics(), timing.Metrics()
    idle = timing.active()
    assert not idle.on
    with timing.tracing(outer):
        assert timing.active() is outer
        with pytest.raises(RuntimeError):
            with timing.tracing(inner):
                assert timing.active() is inner
                raise RuntimeError
        assert timing.active() is outer
    assert timing.active() is idle


def test_listeners_and_record():
    m = timing.Metrics()
    seen = []
    m.listeners.append(lambda name, opening: seen.append((name, opening)))
    m.count("frames", 3)
    with m.span("runner.frame"):      # off: no listener call
        pass
    m.start()
    m.count("frames", 2)
    with m.span("runner.chunk", rid=8, frames=4):
        with m.span("tracking.scan", attrs={"pass": "track"}) as s:
            assert s.rid == 8 and s.frames is None
    m.stop()
    with m.span("runner.frame"):
        pass
    assert seen == [("runner.chunk", True), ("tracking.scan", True),
                    ("tracking.scan", False), ("runner.chunk", False)]
    rec = m.record()
    assert rec["counts"] == {"frames": 2}
    assert [(x.name, x.parent, x.rid) for x in rec["spans"]] == [
        ("runner.chunk", -1, 8), ("tracking.scan", 0, 8)]
    n, med, p90 = m.span_stats()["runner.chunk"]
    assert n == 1 and 0 <= med <= p90
    assert "runner.chunk" in m.report() and "frames" in m.report()
