"""`sgslam_tpu_torch/bench_sweep.py` (port of `tools/bench_sweep.py`) on
the CPU at a small size (the room at 320x240, 600 features, chunks of 2).

- `bench_sweep.main(["--cpu", ...])` over 12 frames: one line per (chunk,
  depth), labelled "cpu", `"hamming": "plain"` (K1 runs only on the
  card), frames/s positive and tracking kept.
- `stage_timings` with one run per stage reports the reference's four
  keys, per frame the chunk's time over its frames.
"""

import json

import pytest
import torch

from sgslam_tpu_torch import bench_sweep, entry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_sweep_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench_sweep, "make_config", entry.small_config)
    assert bench_sweep.main(["--cpu", "--chunks", "2", "--depths", "0",
                             "--frames", "12"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["chunk"] == 2 and row["depth"] == 0
    assert row["device"] == "cpu" and row["hamming"] == "plain"
    assert row["fps"] > 0 and row["min_inliers"] >= 30


def test_bench_sweep_stage_timings_on_the_cpu(monkeypatch):
    from sgslam_tpu_torch.io import synthetic
    from sgslam_tpu_torch.models.detector import Detector2D

    monkeypatch.setattr(bench_sweep, "STAGE_RUNS", 1)
    cfg = entry.small_config()
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=8, dynamic=True,
                                      device="cpu")
    frames = [seq.frame(i) for i in range(8)]
    st = bench_sweep.stage_timings(cfg, Detector2D(cfg.detector,
                                                   device="cpu"),
                                   frames, 2, torch.device("cpu"))
    assert list(st) == ["extract_batch_ms", "detector_batch_ms",
                        "chunk_total_ms", "per_frame_ms"]
    assert all(v > 0 for v in st.values())
    assert st["per_frame_ms"] == st["chunk_total_ms"] / 2
