"""The benchmark's arithmetic on hand-made inputs, and its frozen bounds
against the program's own."""

import numpy as np
import pytest
import torch

from benchmark import stats, traffic
from benchmark.harness import Ctx


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
def test_percentile_is_numpys_linear(q):
    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0]
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_percentile_hand_made():
    assert stats.percentile([10.0, 20.0], 50) == 15.0
    assert stats.percentile(list(range(11)), 90) == 9.0
    assert stats.percentile([4.0], 90) == 4.0


def test_union_and_idle_gaps():
    iv = [(0, 10), (5, 15), (20, 25), (24, 30), (40, 41)]
    assert stats.union_ns(iv) == 15 + 10 + 1
    assert stats.idle_gaps(iv, 0, 50) == [(15, 20), (30, 40), (41, 50)]
    assert stats.idle_gaps([], 3, 8) == [(3, 8)]
    # idle share of a 50 ns window busy 26 ns
    assert 1 - stats.union_ns(iv) / 50 == pytest.approx(0.48)


def test_idle_metric_reads_the_share():
    from benchmark import core

    spec = core.Spec(core.load_bench(), "chunked.slow_walker")
    ctx = Ctx("chunked", 1.0, {"frames": 8, "seconds": 2.0},
              summary={"busy_s": 0.25, "window_s": 2.0, "kernels": 80,
                       "span_device_s": {"bench.k1s": 0.001}},
              bounds=(0.5, 0.0))
    assert spec.reader("device_idle.chunked")(ctx) == pytest.approx(87.5)
    assert spec.reader("launches.chunked")(ctx) == 10.0
    assert spec.reader("k1s_roofline.chunked")(ctx) == pytest.approx(50.0)
    # no device time inside the segment sums' ranges: nothing to read
    assert spec.reader("segsum_roofline.chunked")(ctx) is None
    assert spec.reader("fps")(ctx) == 4.0


def test_frame_percentiles_read_all_frames():
    from benchmark import core

    spec = core.Spec(core.load_bench(), "live.walkers_fastrot")
    ms = [100.0] * 90 + [300.0] * 10
    ctx = Ctx("live", 1.0, {"frames": 100, "seconds": 9.0, "frame_ms": ms,
                            "keyframe": [False] * 100, "first": 0})
    assert spec.reader("frame_ms_p50")(ctx) == 100.0
    assert spec.reader("frame_ms_p95")(ctx) == 300.0
    ctx.window["frame_ms"] = [float(i) for i in range(201)]
    assert spec.reader("frame_ms_p95")(ctx) == 190.0


def test_frozen_bounds_equal_the_programs():
    from sgslam_tpu_torch.ops import hamming_search, segment

    for q, n, mutual, window, cand in [(4096, 1024, False, True, 5797),
                                       (1024, 1024, True, False, None),
                                       (16, 128, False, True, None)]:
        assert stats.search_bound(q, n, mutual, window, cand) == \
            hamming_search.search_bound(q, n, mutual, window, cand)[0]
    values = torch.zeros(100, 30)
    index = torch.tensor([i % 7 if i % 5 else -1 for i in range(100)])
    for init in (None, torch.zeros(7, 30)):
        kept = int(((index >= 0) & (index < 7)).sum())
        assert stats.segment_bound(kept, 100, 30, 7, 4, 8,
                                   init is not None) == \
            segment.segment_bound(values, index, 7, init)[0]


def _mix():
    from benchmark import core

    return core.load_json(core.HERE / "traffic" / "walkers_fastrot.json")


def test_same_seed_same_walk_and_frames():
    from benchmark import core
    from benchmark.reference.camera import Camera

    mix = _mix()
    a = traffic.walk(mix, 40, 2 ** 33 + 5)
    b = traffic.walk(mix, 40, 2 ** 33 + 5)
    c = traffic.walk(mix, 40, 2 ** 33 + 6)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    # tex_seed_range 0: every seed walks and dresses the walkers alike
    assert np.array_equal(a[0], c[0]) and np.array_equal(a[1], c[1])
    # a mix with a range: the camera walks alike, the seed draws the looks
    slow = core.load_json(core.HERE / "traffic" / "slow_walker.json")
    a = traffic.walk(slow, 40, 2 ** 33 + 5)
    c = traffic.walk(slow, 40, 2 ** 33 + 6)
    assert np.array_equal(a[0], c[0])
    assert np.array_equal(a[1][..., :4], c[1][..., :4])
    assert not np.array_equal(a[1][..., 4], c[1][..., 4])
    cam = Camera(fx=65.625, fy=65.625, cx=39.5, cy=29.5, bf=5.0, width=80,
                 height=60)
    f1 = traffic.render(mix, cam, 6, 11, "cpu")
    f2 = traffic.render(mix, cam, 6, 11, "cpu")
    assert np.array_equal(f1.gray, f2.gray)
    assert np.array_equal(f1.depth, f2.depth)
    assert f1.gray.shape == (6, 60, 80)
    assert (f1.depth > 0).mean() > 0.9


def test_motion_per_frame_does_not_depend_on_length():
    mix = _mix()
    short = traffic.walk(mix, 50, 123)
    long = traffic.walk(mix, 700, 123)
    assert np.allclose(short[0], long[0][:50], atol=1e-6)
    assert np.array_equal(short[1], long[1][:50])
    # the walk repeats, it does not stretch: the step stays bounded
    steps = np.abs(np.diff(long[0][:, 4:], axis=0)).max()
    assert steps < 0.05


def test_frames_needed_covers_the_cap_rate():
    mix = _mix()
    assert traffic.frames_needed(mix, 10, 54, 4) == 54 + 300
    assert traffic.frames_needed(mix, 10.1, 54, 4) == 54 + 304
