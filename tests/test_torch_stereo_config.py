"""The benchmark's stereo configuration (`benchmark/configs/
stereo752_chunked.json`, ORB-SLAM2's EuRoC.yaml rig) built into the
program's configuration, its camera scaled to 376x240 as the harness's CPU
rehearsal scales a camera (`benchmark.harness.tiny`): on seeded rectified
pairs of the benchmark's traffic, the program's `extract_frame_stereo`
equals the benchmark's frozen plain copy (`benchmark/reference/orb.
extract_frame_stereo`) bit for bit in every field that `correct` compares
(`benchmark.check.FIELDS["stereo"]`). Both run as plain torch on the CPU."""

import pytest
import torch

from benchmark import check, core, harness, runners, traffic
from benchmark.reference import config as ref_config
from benchmark.reference import orb as ref_orb
from sgslam_tpu_torch.slam import tracking

CELL = "chunked.stereo_walk"
WIDTH = 376
FRAMES = (0, 7, 13)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spec():
    """The cell's configuration file with only its camera scaled, as
    `harness.tiny` scales it; every other setting as committed."""
    full = core.Spec(core.load_bench(), CELL)
    doc = dict(full.config)
    doc["camera"] = harness.tiny(full, width=WIDTH).config["camera"]
    full.config = doc
    return full


def test_configuration_is_the_euroc_rig(spec):
    doc = spec.config
    assert doc["name"] == "stereo752_chunked"
    assert doc["runner"]["kind"] == "chunked_stereo"
    assert spec.runner().Runner.views == ("gray", "gray_r")
    assert (doc["camera"]["width"], doc["camera"]["height"]) == (WIDTH, 240)
    # the baseline in metres is the rig's: bf / fx does not scale
    assert doc["camera"]["bf"] / doc["camera"]["fx"] == pytest.approx(
        47.9064 / 435.2047, rel=1e-12)
    cfg = runners.program_config(doc)
    assert (cfg.orb.n_features, cfg.orb.max_keypoints) == (1200, 1280)
    assert cfg.capacity.max_obs_per_kf == 1280
    assert cfg.tracker.depth_threshold_factor == 35.0
    assert cfg.fps == 20.0


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 2 ** 32 + 12345])
def test_stereo_front_end_equals_the_frozen_copy(spec, seed):
    cfg = runners.program_config(spec.config)
    rcfg = ref_config.from_file(spec.config)
    f = traffic.render(spec.traffic, rcfg.camera, max(FRAMES) + 1, seed,
                       "cpu", views=spec.runner().Runner.views)
    for i in FRAMES:
        gl = torch.from_numpy(f.gray[i])
        gr = torch.from_numpy(f.gray_r[i])
        prog = tracking.extract_frame_stereo(cfg, gl, gr, "cpu")
        ref = ref_orb.extract_frame_stereo(rcfg, gl, gr)
        assert torch.equal(prog.valid, ref.valid)
        for name in check.FIELDS["stereo"]:
            assert torch.equal(getattr(prog, name), getattr(ref, name)), name
        assert check.keypoints(prog, ref, "stereo") == (
            0, int(prog.valid.sum()))
        # the search accepts most keypoints at the rig's baseline
        ok = prog.u_right >= 0
        assert int(ok.sum()) > 0.8 * int(prog.valid.sum())


def _stages(marks, ms=2.0):
    """`trace.Stages.durations()` of a chunk's marks: each mark after
    "begin", the same ms each."""
    return [(n, ms, 0) for n in marks if n != "begin"]


def test_stereo_ms_reads_the_stereo_marks_alone():
    """`stereo_ms.chunked` sums the "stereo" stages per frame of the
    window, and reads nothing from an RGB-D chunk's marks, which have no
    "stereo" stage; `extract_ms.chunked` then reads the ORB half alone."""
    spec = core.Spec(core.load_bench(), CELL)
    read = spec.reader("stereo_ms.chunked")
    extract = spec.reader("extract_ms.chunked")
    stereo = (["begin"] + ["extract", "stereo"] * 4
              + ["detector", "cull", "track"])
    rgbd = ["begin", "extract", "detector", "cull", "track"]
    ctx = harness.Ctx("chunked", 1.0, {"frames": 8}, _stages(stereo * 2))
    assert read(ctx) == 2.0 and extract(ctx) == 2.0
    ctx = harness.Ctx("chunked", 1.0, {"frames": 8}, _stages(rgbd * 2))
    assert read(ctx) is None and extract(ctx) == 0.5
    assert read(harness.Ctx("chunked", 1.0, {"frames": 8})) is None
    assert read(harness.Ctx("live", 1.0, {"frames": 8},
                            _stages(stereo))) is None
    assert "stereo_ms.chunked" in spec.metric_names(True)
    assert "stereo_ms.chunked" not in core.Spec(
        core.load_bench(), "chunked.slow_walker").metric_names(True)
