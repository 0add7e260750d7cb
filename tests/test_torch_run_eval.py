"""The port's evaluation suite (`sgslam_tpu_torch/run_eval.py`) against the
JAX package's (`tools/run_eval.py`, loaded by path): the seven sequences
(full and `--quick`), the configuration, the TUM1-distorted rendering, the
ATE, the row verdicts and the artifact's rows, and one short end-to-end
System run on the distorted camera through both packages.

Tolerances: trajectories and walker tracks 2e-6: `jnp.linspace` and
`torch.linspace` put a few samples one ulp apart (6 of 150, 18 of 200), and
the sines of the long sequences move fast per unit of the sample (a
walker's x up to 0.9 * 2 pi * 2.2 m; the 2.15-lap circuit's quaternion over
6.75 rad); measured at most 1.71e-6 (walkers, 50 and 200 frames) and
1.37e-6 (the stress circuit). Rendering as tests/test_torch_synthetic.py
holds it, every pixel valid in both; ATE 1e-6.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.geometry import se3 as jse3
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch import run_eval as tre
from sgslam_tpu_torch.io import synthetic as tsyn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jre = _load_tool("run_eval")

TOL_POSE = 2e-6
TOL_DEPTH = 1e-4        # m, as tests/test_torch_synthetic.py
TOL_GRAY = 2.5e-3       # one ulp of sin times 43758
MAX_FLIP_SHARE = 1e-4   # share of pixels beyond TOL_GRAY
TOL_ATE = 1e-6
NAMES = list(jre._sequences(True))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequences():
    return {q: (jre._sequences(q), tre._sequences(q)) for q in (False, True)}


def test_suite_has_the_reference_sequences():
    assert list(tre._sequences(False)) == NAMES == list(jre._sequences(False))


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_sequence_matches_reference(sequences, name, quick):
    js, ts = (s[name] for s in sequences[quick])
    assert set(js) == set(ts)
    for k in ("kind", "distort", "n"):
        assert js[k] == ts[k], k
    assert js.get("stress") == ts.get("stress")
    assert [dataclasses.astuple(p) for p in js["planes"]] == \
        [dataclasses.astuple(p) for p in ts["planes"]]
    np.testing.assert_allclose(ts["poses"].numpy(), np.asarray(js["poses"]),
                               atol=TOL_POSE, rtol=0)
    assert ts["poses"].shape == (ts["n"], 7)
    if js["people"] is None:
        assert ts["people"] is None
    else:
        np.testing.assert_allclose(ts["people"].numpy(),
                                   np.asarray(js["people"]), atol=TOL_POSE,
                                   rtol=0)


@pytest.mark.parametrize("distort", [True, False])
def test_make_cfg_matches_reference(distort):
    j, t = jre._make_cfg(distort), tre._make_cfg(distort)
    assert dataclasses.asdict(t.camera) == dataclasses.asdict(j.camera)
    assert dataclasses.asdict(t.tracker) == dataclasses.asdict(j.tracker)
    assert dataclasses.asdict(t.orb) == dataclasses.asdict(j.orb)
    assert dataclasses.asdict(t.capacity) == dataclasses.asdict(j.capacity)
    assert t.camera.has_distortion() == distort


@pytest.mark.parametrize("i", [0, 60])
def test_distorted_frame_matches_reference(sequences, i):
    """static_640_tum1_distortion at 640x480: pixel (u, v) sees the ray of
    the undistorted coordinates, in both packages."""
    name = "static_640_tum1_distortion"
    js, ts = (s[name] for s in sequences[False])
    cam = jre._make_cfg(True).camera
    gj, dj = (np.asarray(x) for x in jsyn.SyntheticSequence(
        cam, n_frames=js["n"], planes=js["planes"],
        poses=js["poses"]).frame(i))
    gt, dt = (x.numpy() for x in tsyn.SyntheticSequence(
        tre._make_cfg(True).camera, n_frames=ts["n"], planes=ts["planes"],
        poses=ts["poses"], device="cpu").frame(i))
    assert gt.shape == gj.shape == (480, 640) and dt.dtype == np.float32
    # valid masks: equal, with no edge pixel excepted; even the undistorted
    # rays of the outer corners hit the room (measured at frames 0, 60, 119)
    assert (dj > 0).all() and (dt > 0).all()
    np.testing.assert_allclose(dt, dj, atol=TOL_DEPTH, rtol=0)
    diff = np.abs(gt - gj)
    assert (diff > TOL_GRAY).mean() <= MAX_FLIP_SHARE, (
        (diff > TOL_GRAY).sum(), diff.max())
    assert diff.mean() < 1e-4


@pytest.mark.parametrize("n_est", [120, 100])
def test_ate_matches_reference(sequences, n_est):
    """A noisy trajectory (the ground truth inverted, moved by a seeded
    normal), whole and cut short."""
    name = "static_640_tum1_distortion"
    js, ts = (s[name] for s in sequences[False])
    rng = np.random.default_rng(0)
    cw = np.asarray(jse3.se3_inverse(js["poses"]))[:n_est].copy()
    cw[:, 4:] += rng.normal(0, 0.01, (n_est, 3)).astype(np.float32)
    traj = list(cw)
    jseq = jsyn.SyntheticSequence(jre._make_cfg(True).camera,
                                  n_frames=js["n"], planes=js["planes"],
                                  poses=js["poses"])
    tseq = tsyn.SyntheticSequence(tre._make_cfg(True).camera,
                                  n_frames=ts["n"], planes=ts["planes"],
                                  poses=ts["poses"], device="cpu")
    a, b = jre._ate(traj, jseq, js["n"]), tre._ate(traj, tseq, ts["n"])
    assert 0.005 < a < 0.05
    assert abs(a - b) <= TOL_ATE, (a, b)


# (sequence, system ATE, chunked ATE, chunked lost frames, expected pass):
# each gate at, just over and just under; the parity rule's absolute floor
# and its relative term at their edges; the stress row's lossless rule
ROW_CASES = [
    ("static_640_walk_fastrot", 0.03, 0.03, 0, True),
    ("static_640_walk_fastrot", 0.0301, 0.03, 0, False),
    ("static_640_tum1_distortion", 0.0299, 0.0301, 0, False),
    ("static_640_circuit_revisit", 0.005, 0.015, 0, True),
    ("static_640_circuit_revisit", 0.005, 0.0151, 0, False),
    ("dynamic_640_3walkers_fastrot", 0.05, 0.0499, 0, True),
    ("dynamic_640_3walkers_fastrot", 0.0501, 0.05, 0, False),
    ("dynamic_640_walkers_circuit", 0.04, 0.05, 0, True),
    ("dynamic_640_walkers_circuit", 0.035, 0.0451, 0, False),
    ("stereo_640_walk", 0.04, 0.035, 0, True),
    ("stereo_640_walk", 0.0401, 0.035, 0, False),
    ("static_640_circuit_2laps_stress", 0.04, 0.05, 0, True),
    ("static_640_circuit_2laps_stress", 0.04, 0.05, 1, False),
    ("static_640_circuit_2laps_stress", 0.0501, 0.05, 0, False),
]


def _canned(monkeypatch, mod, a, b, lost):
    system = {"ate": a, "state": "OK", "keyframes": 17, "loops_closed": 1,
              "wall_s": 12.3}
    chunked = {"ate": b, "keyframes": 16, "loops_closed": 0,
               "relocalizations": 0, "lost_frames": lost, "wall_s": 4.5}
    cov = {"mean_person_coverage": 0.21, "max_person_coverage": 0.6,
           "frames_with_person_pct": 96.7,
           "frames_over_30pct_coverage_pct": 20.0}
    monkeypatch.setattr(mod, "_render", lambda *a, **k: (None, None))
    monkeypatch.setattr(mod, "_coverage_stats", lambda *a, **k: dict(cov))
    monkeypatch.setattr(mod, "_run_system", lambda *a, **k: dict(system))
    monkeypatch.setattr(mod, "_run_chunked", lambda *a, **k: dict(chunked))


@pytest.mark.parametrize("name,a,b,lost,expect", ROW_CASES)
def test_rows_match_reference(monkeypatch, tmp_path, name, a, b, lost,
                              expect):
    import sgslam_tpu.models.detector as jdet
    import sgslam_tpu_torch.models.detector as tdet

    for mod in (jdet, tdet):
        monkeypatch.setattr(mod, "Detector2D", lambda *a, **k: None)
    _canned(monkeypatch, jre, a, b, lost)
    _canned(monkeypatch, tre, a, b, lost)
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["run_eval.py", "--only", name,
                                      "--out", str(ref_out)])
    jre.main()
    res = tre.main(["--only", name, "--out", str(port_out), "--cpu"])
    ref, port = json.loads(ref_out.read_text()), json.loads(
        port_out.read_text())
    assert port == res
    assert port.pop("device")["type"] == "cpu"
    assert list(port["sequences"]) == [name]
    assert port["sequences"][name] == ref["sequences"][name]
    assert port == ref
    row = port["sequences"][name]
    assert row["pass"] is expect
    assert row == {**row, **tre.row_verdict(
        row["kind"], row["stress"], row["system"], row["chunked"])}


def _small(mod_cfg, dist):
    """The TUM1-distorted camera at 320x240 and the port tests' small
    widths, with run_eval's keyframe cadence."""
    cfg = mod_cfg.synthetic_config(
        width=320, height=240,
        orb=mod_cfg.OrbConfig(n_features=600, max_keypoints=640),
        capacity=mod_cfg.MapCapacity(max_keyframes=64, max_points=8192,
                                     local_window=4, local_points=1024),
        tracker=mod_cfg.TrackerConfig(max_frames_between_kf=6,
                                      depth_threshold_factor=70.0))
    return dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, **dist))


def test_short_distorted_system_run():
    """The first 24 frames of static_640_tum1_distortion's walk on the
    distorted camera at 320x240 through each package's `_run_system`: both
    under the static gate and within the parity rule of each other."""
    n = 24
    jspec = dict(jre._sequences(False)["static_640_tum1_distortion"], n=n)
    jspec["poses"] = jspec["poses"][:n]
    tspec = dict(tre._sequences(False)["static_640_tum1_distortion"], n=n)
    tspec["poses"] = tspec["poses"][:n]
    jc, tc = _small(jcfg, jre.TUM1_DIST), _small(tcfg, tre.TUM1_DIST)
    assert jc.camera.has_distortion() and tc.camera.has_distortion()
    jseq, jframes = jre._render(jc, jspec)
    tseq, tframes = tre._render(tc, tspec, "cpu")
    rj = jre._run_system(jc, jspec, jframes, jseq, None)
    rt = tre._run_system(tc, tspec, tframes, tseq, None, "cpu")
    a, b = rj["ate"], rt["ate"]
    assert rt["state"] == rj["state"] == "OK"
    assert a < tre.STATIC_GATE and b < tre.STATIC_GATE, (a, b)
    assert abs(a - b) <= max(tre.PARITY_REL * max(a, b), tre.PARITY_ABS), (
        a, b)


def test_one_ulp_move_as_parity_spread():
    """debug_stress.moved_frames moves frame i's images by the signs of
    default_rng(2000 s + i) and default_rng(3000 s + i), each element times
    1 +- 2**-23, as tools/parity_spread.py moves the reference's."""
    from sgslam_tpu_torch.debug_stress import moved_frames

    rng = np.random.default_rng(5)
    frames = [tuple(rng.uniform(0.5, 3.0, (6, 9)).astype(np.float32)
                    for _ in range(2)) for _ in range(3)]
    moved = moved_frames([tuple(map(torch.from_numpy, f)) for f in frames], 2)
    for i, ((g, d), (mg, md)) in enumerate(zip(frames, moved)):
        for x, mx, seed in ((g, mg, 4000 + i), (d, md, 6000 + i)):
            signs = np.random.default_rng(seed).choice([-1, 1], size=x.shape)
            want = (x * (1 + signs * 2.0 ** -23)).astype(np.float32)
            assert mx.dtype == torch.float32
            np.testing.assert_array_equal(mx.numpy(), want)
            assert (mx.numpy() != x).mean() > 0.9


def test_kf_ate_matches_reference(sequences):
    """debug_stress.kf_ate: the valid keyframes' poses against the ground
    truth of their frames, as tests/test_torch_loop_closing.py's reference
    keyframe ATE computes it."""
    from types import SimpleNamespace

    from sgslam_tpu.eval import ate as jate
    from sgslam_tpu_torch.debug_stress import kf_ate

    js = sequences[False][0]["static_640_circuit_2laps_stress"]
    gt = np.asarray(js["poses"])
    rng = np.random.default_rng(1)
    fid = np.sort(rng.choice(len(gt), 40, replace=False))
    cw = np.asarray(jse3.se3_inverse(gt[fid])).copy()
    cw[:, 4:] += rng.normal(0, 0.02, (40, 3)).astype(np.float32)
    valid = rng.uniform(size=40) < 0.8
    m = SimpleNamespace(kf_pose=torch.from_numpy(cw),
                        kf_valid=torch.from_numpy(valid),
                        kf_frame_id=torch.from_numpy(fid.astype(np.int32)))
    est = np.asarray(jse3.se3_inverse(cw[valid]))
    want = jate.ate_rmse(est, gt[fid[valid]])[0]
    assert 0.005 < want < 0.05
    assert abs(kf_ate(m, gt) - want) <= TOL_ATE
