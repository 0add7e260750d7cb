"""`sgslam_tpu_torch/profile_chunk.py` (port of `tools/profile_chunk.py`)
on the CPU at a small size (the room at 320x240, 600 features, chunks of 2
frames), and both profile_chunk's and bench_sweep's schedules against the
reference tools' sources.

- The reference tools' schedules: profile_chunk's 76 warm-up frames, chunk
  4, `fetch_every=6` and its seven rows; bench_sweep's 6 bootstrap frames,
  default grid and frame count.
- `profile_chunk.main(["--cpu", "--reps", "1"])` after a 3-frame warm-up:
  one JSON line labelled "cpu" with every row's median finite and
  positive; the tool itself fails if a stage wrote into the map that the
  next rep is given, so the run also holds that no stage does.
"""

import json
import math
import os

import pytest
import torch

from sgslam_tpu_torch import bench_sweep, entry, profile_chunk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = ["chunk4_full_kf_allowed", "chunk4_no_kf", "extract4",
        "chunk4_no_kf_no_det_no_sem", "track_step_1", "insert_and_maintain",
        "local_ba_step"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool_source(name):
    with open(os.path.join(ROOT, "tools", f"{name}.py")) as f:
        return f.read()


def test_schedules_are_the_tools():
    src = _tool_source("profile_chunk")
    assert "CHUNK = 4" in src and "N_WARM = 76" in src
    assert "fetch_every=6" in src
    assert (profile_chunk.CHUNK, profile_chunk.N_WARM,
            profile_chunk.FETCH_EVERY) == (4, 76, 6)
    for row in ROWS:
        assert f'"{row}"' in src
    src = _tool_source("bench_sweep")
    assert "n_boot=6" in src and 'default="4,8"' in src
    assert 'default="0,1"' in src and "default=110" in src
    assert bench_sweep.N_BOOT == 6
    assert (bench_sweep.CHUNKS, bench_sweep.DEPTHS, bench_sweep.FRAMES) == (
        "4,8", "0,1", 110)


def test_profile_chunk_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(profile_chunk, "make_config", entry.small_config)
    monkeypatch.setattr(profile_chunk, "CHUNK", 2)
    monkeypatch.setattr(profile_chunk, "N_WARM", 3)
    assert profile_chunk.main(["--cpu", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["device"] == "cpu" and res["reps"] == 1
    assert res["map"]["keyframes"] >= 1 and res["map"]["points"] > 0
    assert list(res["ms"]) == ROWS
    assert all(math.isfinite(v) and v > 0 for v in res["ms"].values())
