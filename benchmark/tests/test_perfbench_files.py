"""Every cell, configuration, traffic mix, limits file and metric that
BENCHMARK.json names is found by name and parses, and the file keeps the
contract's shapes and character rules."""

import dataclasses
import importlib
import json

import pytest

from benchmark import core, harness

BENCH = core.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_names():
    assert set(BENCH) == TOP
    assert core.check_names(BENCH) == []
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


def runner_of_its_family(spec):
    """The runner module that the configuration names declares known views
    and the family (`Runner.kind`) that the metric readers test."""
    kind = spec.config["runner"]["kind"]
    runner = spec.runner().Runner
    if kind in ("chunked", "live"):
        # the module is itself a family
        assert runner.kind == kind
    else:
        # a runner of another module subclasses its family's runner
        family = importlib.import_module(f"benchmark.runners.{runner.kind}")
        assert issubclass(runner, family.Runner)
    assert set(runner.views) <= {"gray", "depth", "gray_r"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = core.Spec(BENCH, cell)
    assert spec.config["name"] == spec.cell["config"]
    assert spec.traffic["name"] == spec.cell["traffic"]
    assert set(spec.limits["limits"]) == set(
        harness.check.NUMBERS)
    runner_of_its_family(spec)
    e2e = spec.metric_names(False)
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.metric_names(True)
    assert layer
    for name in e2e + layer:
        assert callable(spec.reader(name))
    # every per-layer metric moves an end-to-end metric the cell reports
    moves = {m["name"]: m["moves"] for m in BENCH["per_layer"]}
    assert all(moves[m] in e2e for m in layer)


def test_every_metric_has_a_reader_and_a_valid_entry():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert (core.HERE / "metrics" / f"{m['name']}.py").exists()
    layers = {}
    for m in BENCH["per_layer"]:
        assert (core.HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


GROUPS = ("camera", "orb", "tracker", "matcher", "dynamic", "detector",
          "mapping", "capacity", "loop", "mesh")
# the configurations that run the port's synthetic Kinect preset as it is
SYNTHETIC = ("rgbd640_chunked", "rgbd640_live")


def _doc(cfg):
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg)
    return core.load_json(core.REPO / entry["file"])


def holds_a_deployment(doc):
    """Each group with exactly the fields of the port's dataclass, a
    program configuration that builds, a named source and a stated
    guarantee, and every assumed value a key of the file with that value."""
    from sgslam_tpu_torch import config as C

    from benchmark import runners

    built = runners.program_config(doc)
    preset = C.synthetic_config()
    for group in GROUPS:
        cls = type(getattr(preset, group))
        assert set(doc[group]) == {f.name for f in dataclasses.fields(cls)}, \
            group
        assert dataclasses.asdict(getattr(built, group)) == doc[group], group
    assert doc["source"] and doc["source_part"]
    assert doc["guarantees"]["ate_rmse_m"] > 0
    assert doc["guarantees"]["source"]
    assert doc["assumed"]["why"]
    for key, value in doc["assumed"].items():
        if key == "why":
            continue
        node = doc
        for part in key.split("."):
            assert part in node, key
            node = node[part]
        assert node == value, key


def is_the_synthetic_kinect(doc):
    """Every setting of `synthetic_config(640, 480)`, the port's defaults
    with the synthetic room's two assumed values."""
    from sgslam_tpu_torch import config as C

    ref = C.synthetic_config(640, 480)
    for group in GROUPS:
        assert doc[group] == dataclasses.asdict(getattr(ref, group)), group
    assert doc["depth_map_factor"] == ref.depth_map_factor
    assert doc["fps"] == ref.fps
    assert doc["guarantees"]["ate_rmse_m"] == 0.05


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_configuration_file_holds_a_deployment(cfg):
    """What every configuration file holds, whatever its deployment."""
    doc = _doc(cfg)
    assert doc["name"] == cfg
    holds_a_deployment(doc)


@pytest.mark.parametrize("cfg", SYNTHETIC)
def test_configuration_is_the_ports_synthetic_config(cfg):
    """The configurations named in SYNTHETIC run the port's synthetic
    Kinect preset as it is."""
    is_the_synthetic_kinect(_doc(cfg))


def test_configuration_checks_take_a_stereo_deployment():
    """A stereo camera at other widths holds what every file must hold,
    and is no synthetic Kinect."""
    from benchmark.tests.test_perfbench_stereo import stereo_doc

    doc = stereo_doc()
    holds_a_deployment(doc)
    with pytest.raises(AssertionError):
        is_the_synthetic_kinect(doc)
    doc["assumed"]["orb.max_keypoints"] = 1024
    with pytest.raises(AssertionError):
        holds_a_deployment(doc)


def test_extra_cell_loads_from_new_files_only(tmp_path):
    """A cell, a mix and a metric added as new files and entries, without
    an edit to a file that is there, load through the same code."""
    root = tmp_path
    (root / "benchmark").mkdir()
    for sub in ("configs", "traffic", "limits", "metrics"):
        (root / "benchmark" / sub).mkdir()
    bench = json.loads(json.dumps(BENCH))
    cfg = dict(core.load_json(core.HERE / "configs" / "rgbd640_chunked.json"))
    cfg["name"] = "rgbd640_extra"
    (root / "benchmark" / "configs" / "rgbd640_extra.json").write_text(
        json.dumps(cfg))
    mix = dict(core.load_json(core.HERE / "traffic" / "slow_walker.json"))
    mix["name"] = "two_walkers"
    mix["people"] = mix["people"] * 2
    (root / "benchmark" / "traffic" / "two_walkers.json").write_text(
        json.dumps(mix))
    (root / "benchmark" / "limits" / "extra.two_walkers.json").write_text(
        json.dumps({"limits": {"keypoints": 0.0}}))
    (root / "benchmark" / "metrics" / "frames_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.window['frames'])\n")
    bench["configs"].append({"name": "rgbd640_extra", "source": "x",
                             "file": "benchmark/configs/rgbd640_extra.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "extra.two_walkers",
                               "config": "rgbd640_extra",
                               "traffic": "two_walkers", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "fps",
                               "workloads": ["extra.two_walkers"]})
    spec = core.Spec(bench, "extra.two_walkers", root=root)
    assert spec.config["name"] == "rgbd640_extra"
    assert len(spec.traffic["people"]) == 2
    assert spec.metric_names(True) == ["frames_seen"]
    ctx = harness.Ctx("chunked", 1.0, {"frames": 12, "seconds": 2.0})
    assert spec.reader("frames_seen")(ctx) == 12.0
    assert spec.runner().Runner.kind == "chunked"
