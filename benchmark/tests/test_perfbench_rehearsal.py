"""A CPU rehearsal of whole runs at 320x240 (`harness.tiny`): set-up, a
short window, the check. The measured command itself refuses to run
without a card. With the timed path broken underneath, `correct` comes out
false: a step that returns its state unchanged (tracking's pose, local
BA's poses and points), half of the detector's batch left out, and an
answer altered where it is produced (a descriptor bit, a pose). The
exchange between chips is no fault of these cells: each runs on one."""

import time

import pytest
import torch

from benchmark import core, harness, run

SEED = 2 ** 32 + 12345


def _run(cell, trace=False, seconds=2.5, traffic=None):
    spec = harness.tiny(core.Spec(core.load_bench(), cell))
    if traffic is not None:
        spec.traffic = core.load_json(core.HERE / "traffic"
                                      / f"{traffic}.json")
    torch.set_num_threads(4)
    return harness.run(spec, SEED, seconds, trace, torch.device("cpu"),
                       time.perf_counter())


def test_the_command_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "chunked.slow_walker", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_chunked_rehearsal_is_correct():
    result, lines, extra = _run("chunked.slow_walker")
    assert result["correct"], lines
    assert set(result["metrics"]) == {"fps", "setup_s"}
    assert result["attempted"] == extra["window"]["frames"] > 0
    assert list(result)[-1] == "checks"
    assert all(c["value"] is not None for c in result["checks"].values())


def test_live_rehearsal_traced_is_correct():
    result, lines, _ = _run("live.walkers_fastrot", trace=True)
    assert result["correct"], lines
    assert {"extract_ms.live", "track_ms.live"} <= set(result["metrics"])


def _broken(monkeypatch, module, name, make):
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, make(orig))


def test_fault_pose_returned_unchanged(monkeypatch):
    from sgslam_tpu_torch.slam import tracking

    def make(orig):
        def f(cfg, m, feats, Tcw_pred, device="cuda", fallback="host"):
            out = orig(cfg, m, feats, Tcw_pred, device, fallback=fallback)
            return (Tcw_pred.clone(),) + tuple(out[1:])
        return f
    _broken(monkeypatch, tracking, "track_step", make)
    result, lines, _ = _run("chunked.slow_walker")
    assert not result["correct"]
    assert result["checks"]["pose"]["value"] > \
        result["checks"]["pose"]["limit"], lines


def test_fault_local_ba_returns_its_input(monkeypatch):
    from sgslam_tpu_torch.optim import local_ba

    def make(orig):
        def f(cam, prob, **kw):
            out = orig(cam, prob, **kw)
            return prob.poses.clone(), prob.points.clone(), out[2]
        return f
    _broken(monkeypatch, local_ba, "bundle_adjust", make)
    result, lines, _ = _run("chunked.slow_walker")
    assert not result["correct"]
    assert result["checks"]["ba"]["value"] > \
        result["checks"]["ba"]["limit"], lines


def test_fault_half_the_detector_batch_left_out(monkeypatch):
    from sgslam_tpu_torch.models import detector
    from sgslam_tpu_torch.semantic.dynamic import Boxes

    def make(orig):
        def f(self, grays, w, h):
            n = grays.shape[0]
            outs = orig(self, grays[: n // 2], w, h)
            empty = Boxes.empty(self.cfg.max_boxes, grays.device)
            return tuple(Boxes(*(torch.cat([getattr(b, k)] + [
                getattr(empty, k)[None]] * (n - n // 2))
                for k in ("xyxy", "cls", "score", "valid"))) for b in outs)
        return f
    _broken(monkeypatch, detector.Detector2D, "detect_batch", make)
    # three walkers: person boxes in every frame
    result, lines, _ = _run("chunked.slow_walker", traffic="walkers_fastrot")
    assert not result["correct"]
    assert result["checks"]["boxes_px"]["value"] > \
        result["checks"]["boxes_px"]["limit"], lines


def test_fault_descriptor_bit_altered(monkeypatch):
    import dataclasses

    from sgslam_tpu_torch.slam import tracking

    def make(orig):
        def f(cfg, gray, depth, device="cuda"):
            out = orig(cfg, gray, depth, device)
            desc = out.desc.clone()
            desc[0, 0] ^= 1
            return dataclasses.replace(out, desc=desc)
        return f
    _broken(monkeypatch, tracking, "extract_frame", make)
    result, lines, _ = _run("chunked.slow_walker")
    assert not result["correct"]
    assert result["checks"]["keypoints"]["value"] > \
        result["checks"]["keypoints"]["limit"], lines


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    """The TF32 control on the card at the rehearsal's size reads above
    the limits where the program reads under them."""
    spec = harness.tiny(core.Spec(core.load_bench(), "chunked.slow_walker"))
    result, lines, extra = harness.run(spec, SEED, 4.0, False, card,
                                       time.perf_counter(), control=True)
    assert result["correct"], lines
    limits = spec.limits["limits"]
    assert any(v is not None and v > limits[k]
               for k, v in extra["control"].items()), extra
