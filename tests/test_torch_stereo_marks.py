"""The stereo front end's stage marks, span and counters, on the CPU at
320x240.

  * the stereo chunk marks each frame's two halves: "begin", then
    ("extract", "stereo") per frame, then "detector" and on as an RGB-D
    chunk; the golden lists below are the parent tree's marks on this
    fixture (one torch thread), with its one "extract" per chunk expanded;
  * the bootstrap frames and `System.track_stereo` mark what they marked
    before: no "stereo";
  * `front_end.stereo` nests in `front_end.extract`, and `stereo.calls` and
    `stereo.candidates` (keypoint slots x candidate disparities) count what
    ran;
  * with the tracer off and no hook, the path opens no profiler range and
    makes no CUDA event, and the chunk lends its hook for its extraction
    loop alone.
"""

import pytest
import torch

from sgslam_tpu_torch import config as C
from sgslam_tpu_torch.io.synthetic import SyntheticSequence
from sgslam_tpu_torch.models.detector import Detector2D
from sgslam_tpu_torch.slam import scan_pipeline, tracking
from sgslam_tpu_torch.slam.loop_closing import LoopCloser
from sgslam_tpu_torch.slam.system import System
from sgslam_tpu_torch.utils import timing

N = 14          # pairs rendered
N_SYSTEM = 3    # pairs through System.track_stereo
CHUNK = 4

CFG = C.synthetic_config(
    width=320, height=240,
    orb=C.OrbConfig(n_features=600, max_keypoints=640),
    tracker=C.TrackerConfig(max_frames_between_kf=3,
                            depth_threshold_factor=70.0),
    capacity=C.MapCapacity(max_keyframes=48, max_points=8192,
                           local_window=4, local_points=1024))

_FRAME = ["begin", "detector", "extract", "cull", "track", "loop_closing"]
_ROUNDS = ["insert1", "retrack1", "insert2", "retrack2"]


def _stereo_chunk(rounds):
    return (["begin"] + ["extract", "stereo"] * CHUNK
            + ["detector", "cull", "track"] + _ROUNDS[:rounds])


# the hooks' marks on this fixture: the parent's, whose stereo chunk marked
# "extract" once after its extraction loop
GOLDEN = {
    "system": _FRAME * N_SYSTEM,
    "chunk": _stereo_chunk(4) + _stereo_chunk(2) + _stereo_chunk(4),
    "chunk_loop": ["begin", "loop_closing"] * 5,
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    seq = SyntheticSequence(CFG.camera, n_frames=N, dynamic=True,
                            device="cpu")
    return [seq.frame_stereo(i)[:2] for i in range(N)]


@pytest.fixture(scope="module")
def detector():
    return Detector2D(CFG.detector, device="cpu")


def _run(pairs, det, on: bool):
    """System.track_stereo over N_SYSTEM pairs and a
    ChunkedSemanticStereoTracker over three chunks, every hook recording
    from before the first frame; the tracers on or off."""
    hooks = {k: [] for k in GOLDEN}
    s = System(CFG, detector=det, device="cpu")
    s.on_stage = hooks["system"].append
    if on:
        s.metrics.start()
    for gl, gr in pairs[:N_SYSTEM]:
        s.track_stereo(gl, gr, rgb=gl[..., None].expand(-1, -1, 3))
    ct = scan_pipeline.ChunkedSemanticStereoTracker(
        CFG, det, chunk=CHUNK, fetch_every=2,
        loop=LoopCloser(CFG, device="cpu"), device="cpu")
    ct.on_chunk_stage = hooks["chunk"].append
    ct.on_stage = hooks["chunk_loop"].append
    if on:
        ct.metrics.start()
    i = 0
    while ct._carry is None or i < 2:
        ct.bootstrap(*pairs[i])
        i += 1
    boot_marks = list(hooks["chunk"])
    for _ in range(3):
        fr = pairs[i:i + CHUNK]
        ct.process_chunk(torch.stack([f[0] for f in fr]),
                         torch.stack([f[1] for f in fr]))
        i += CHUNK
    ct.flush()
    return dict(hooks=hooks, system=s, chunked=ct, boot=i - 3 * CHUNK,
                boot_marks=boot_marks)


def _counting(fn):
    """fn() with torch.profiler.record_function and torch.cuda.Event
    counted: (fn's result, {"range": n, "event": n})."""
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
        out = fn()
    return out, made


@pytest.fixture(scope="module")
def plain(pairs, detector):
    """The run with the tracers off, profiler ranges and CUDA events
    counted."""
    out, made = _counting(lambda: _run(pairs, detector, on=False))
    out["made"] = made
    return out


@pytest.fixture(scope="module")
def traced(pairs, detector):
    return _run(pairs, detector, on=True)


@pytest.mark.parametrize("hook", sorted(GOLDEN))
@pytest.mark.parametrize("run", ["plain", "traced"])
def test_hooks_receive_the_golden_marks(request, run, hook):
    got = request.getfixturevalue(run)["hooks"][hook]
    assert got == GOLDEN[hook]


@pytest.mark.parametrize("run", ["plain", "traced"])
def test_bootstrap_and_system_mark_no_stereo(request, run):
    out = request.getfixturevalue(run)
    assert out["boot"] >= 2 and out["boot_marks"] == []
    assert "stereo" not in out["hooks"]["system"]
    # the hook is lent for the extraction loop alone
    assert out["chunked"].metrics.on_stage is None
    assert out["system"].metrics.on_stage is None
    assert timing.active() is timing._IDLE and timing._IDLE.on_stage is None


def _spans(m):
    return m.record()["spans"]


def _parent(sp, x):
    return sp[x.parent].name if x.parent >= 0 else None


def _candidates(calls):
    return calls * CFG.orb.max_keypoints * tracking.STEREO_DISPARITIES


def test_stereo_span_nests_in_extract(traced):
    # System.track_stereo: one search a frame, inside its extraction
    sp = _spans(traced["system"].metrics)
    st = [x for x in sp if x.name == "front_end.stereo"]
    assert len(st) == N_SYSTEM
    for x in st:
        assert _parent(sp, x) == "front_end.extract"
        assert _parent(sp, sp[x.parent]) == "runner.frame"
        assert x.rid == sp[x.parent].rid
        assert not [y for y in sp if y.parent == sp.index(x)]

    # the chunk: four searches inside each chunk's extraction; the
    # bootstrap frames extract outside any `front_end.extract`
    sp = _spans(traced["chunked"].metrics)
    st = [x for x in sp if x.name == "front_end.stereo"]
    boot = [x for x in st if _parent(sp, x) == "runner.frame"]
    assert len(boot) == traced["boot"]
    chunks = [x for x in sp if x.name == "runner.chunk"]
    assert len(chunks) == 3
    for c in chunks:
        ex = [y for y in sp if y.parent == sp.index(c)
              and y.name == "front_end.extract"]
        assert len(ex) == 1
        kids = [y for y in sp if y.parent == sp.index(ex[0])]
        assert [y.name for y in kids] == ["front_end.stereo"] * CHUNK
        assert all(y.rid == c.rid for y in kids)
    # every search sits in a chunk's extraction or a bootstrap frame (a
    # seam replay takes the chunk's kept front end and searches nothing)
    assert all(_parent(sp, x) in ("front_end.extract", "runner.frame")
               for x in st)


@pytest.mark.parametrize("facade", ["system", "chunked"])
def test_stereo_counters_count_calls_and_candidates(traced, plain, facade):
    rec = traced[facade].metrics.record()
    n = sum(x.name == "front_end.stereo" for x in rec["spans"])
    assert rec["counts"]["stereo.calls"] == n
    assert rec["counts"]["stereo.candidates"] == _candidates(n)
    assert n >= rec["counts"]["frames"]
    # off, the counters count the same calls
    off = plain[facade].metrics.counters
    assert off["stereo.calls"] == n
    assert off["stereo.candidates"] == _candidates(n)


def test_off_run_without_hooks_opens_nothing(plain, pairs):
    # the whole off run, whose hooks append to lists
    assert plain["made"] == {"range": 0, "event": 0}
    assert plain["chunked"].metrics.spans == []
    # no hook at all: the tracer's stage hook None, as in every call
    # outside a stereo chunk's extraction loop
    m = timing.Metrics()
    gl, gr = pairs[0]

    def call():
        with timing.tracing(m):
            return tracking.extract_frame_stereo(CFG, gl, gr, "cpu")
    feats, made = _counting(call)
    assert made == {"range": 0, "event": 0}
    assert m.spans == [] and m.on_stage is None
    assert dict(m.counters) == {"fast.calls": 1, "stereo.calls": 1,
                                "stereo.candidates": _candidates(1)}
    assert int((feats.u_right >= 0).sum()) > 0


def test_chunk_returns_the_hook_when_extraction_fails(pairs):
    """The chunk restores the tracer's stage hook when its extraction
    raises."""
    def extract(cfg, gray, depth, device):
        assert timing.active().on_stage is hook
        raise RuntimeError("extraction failed")

    marks = []

    def hook(name):
        marks.append(name)
    fn = scan_pipeline.make_track_chunk(CFG, stereo=True, device="cpu",
                                        on_stage=hook, extract=extract)
    grays = torch.stack([p[0] for p in pairs[:CHUNK]])
    m = timing.Metrics()
    with timing.tracing(m), pytest.raises(RuntimeError):
        fn(None, None, grays, grays)
    assert m.on_stage is None and marks == ["begin"]
