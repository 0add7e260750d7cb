"""The port's measurement harnesses against the JAX package's: the
benchmark (`sgslam_tpu_torch/bench.py` against the repository's
`bench.py`), the card timers of `sgslam_tpu_torch/utils/timing.py`, and
every harness's refusal to measure on the CPU under a card's name.

- bench's schedule and JSON line: bench.py's constants (imported from
  bench.py itself) and its four keys and metric name, exactly.
- bench's `main(["--cpu"])` at a small size (the room at 320x240, one warm
  and two timed chunks): one JSON line with those four keys, and stderr
  labels the run "cpu".
- Without a card and without `--cpu`, each harness's `main` exits non-zero
  and prints nothing on stdout (decided inside the test: CUDA is made
  unavailable there).
- `event_times` on the CPU makes each call's arguments before its timing
  starts.
"""

import json

import pytest
import torch

import bench as reference_bench
from sgslam_tpu_torch import (bench, bench_dist_ba, bench_dist_ba_realmap,
                              bench_kernels, bench_sweep, entry,
                              profile_chunk)
from sgslam_tpu_torch.utils import timing

REFERENCE_KEYS = ["metric", "value", "unit", "vs_baseline"]
REFERENCE_METRIC = "full_semantic_pipeline_fps_640x480_1000feat"
HARNESSES = [bench, profile_chunk, bench_sweep, bench_kernels,
             bench_dist_ba, bench_dist_ba_realmap]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_schedule_is_bench_py_s():
    assert (bench.CHUNK, bench.FETCH_EVERY, bench.WARM_CHUNKS,
            bench.TIMED_CHUNKS) == (
        reference_bench.CHUNK, reference_bench.FETCH_EVERY,
        reference_bench.WARM_CHUNKS, reference_bench.TIMED_CHUNKS)
    assert bench.N_BOOT == 6 and bench.MIN_INLIERS == 30
    cfg = bench.make_config()
    assert (cfg.camera.width, cfg.camera.height) == (640, 480)
    assert cfg.orb.n_features == 1000


def test_json_line_is_bench_py_s():
    line = bench.result(12.3456)
    assert list(line) == REFERENCE_KEYS
    assert line == {"metric": REFERENCE_METRIC, "value": 12.35,
                    "unit": "frames/s", "vs_baseline": 0.412}


def test_bench_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench, "make_config", entry.small_config)
    monkeypatch.setattr(bench, "WARM_CHUNKS", 1)
    monkeypatch.setattr(bench, "TIMED_CHUNKS", 2)
    assert bench.main(["--cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert list(res) == REFERENCE_KEYS
    assert res["metric"] == REFERENCE_METRIC and res["unit"] == "frames/s"
    assert res["value"] > 0
    assert abs(res["vs_baseline"] - res["value"] / 30.0) < 1e-3
    assert "bench: cpu" in err


@pytest.mark.parametrize("harness", HARNESSES,
                         ids=[h.__name__.split(".")[-1] for h in HARNESSES])
def test_refuses_without_a_card(harness, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        harness.main([])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_event_times_on_the_cpu():
    made, seen = [], []
    times = timing.event_times(lambda x: seen.append(x), runs=3, warmup=2,
                               device="cpu",
                               args=lambda r: (made.append(r) or r,))
    assert len(times) == 3 and all(t >= 0 for t in times)
    assert made == [0, 0, 1, 2, 3] and seen == made
    assert timing.card("cpu") == "cpu"
