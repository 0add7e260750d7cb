"""Room for a stereo configuration: the right view the traffic renders, the
stereo front end that the capture samples and `correct` judges against
the frozen SAD search (`reference/stereo.py`), and a stereo cell added as
new files only, rehearsed on the CPU at 320 pixels wide. An RGB-D run
renders and hands over what it did before the right view existed."""

import dataclasses
import hashlib
import json
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark import check, core, harness, traffic
from benchmark.reference import config as ref_config
from benchmark.reference import stereo as ref_stereo

SEED = 2 ** 32 + 12345
CELL = "chunked.stereo_walk"

# sha256 of gray, depth and T_wc of the first 8 frames of each mix at the
# rehearsal's 320x240, seed SEED, as the renderer gave them before it could
# render a right view
RGBD_HASHES = {
    "slow_walker":
        "c36277c9a9ad600862a4cfdcbadfe8d98bd82ffbfddbebd54e7ee08e74ffa5ce",
    "walkers_fastrot":
        "37fdca1192d6a46d30fc3946c5a50f5067a83f506faf46634f4f4c258798f552",
}


def stereo_doc() -> dict:
    """A stereo deployment's configuration file: ORB-SLAM2's
    Examples/Stereo/EuRoC.yaml camera and ORB settings, the rest as
    `rgbd640_chunked`."""
    doc = core.load_json(core.HERE / "configs" / "rgbd640_chunked.json")
    doc.update(
        name="stereo752_chunked",
        source="https://github.com/raulmur/ORB_SLAM2",
        source_part="Examples/Stereo/EuRoC.yaml: the rectified EuRoC MAV "
                    "pair at 752x480, 20 Hz, bf 47.9064; ORB 1200 features, "
                    "8 levels at 1.2, FAST 20/7; ThDepth 35",
        entry="ChunkedSemanticStereoTracker(cfg, Detector2D, chunk=4, "
              "fetch_every=6, loop=LoopCloser(cfg)): process_chunk on "
              "(lefts, rights), then flush",
        fps=20.0,
        assumed={"orb.max_keypoints": 1280,
                 "capacity.max_obs_per_kf": 1280,
                 "why": "the static capacities raised to hold 1200 features"},
        guarantees={"ate_rmse_m": 0.04,
                    "source": "sgslam_tpu_torch/run_eval.py STEREO_GATE"})
    doc["runner"]["kind"] = "chunked_stereo"
    doc["camera"].update(fx=435.2047, fy=435.2047, cx=367.4517, cy=252.2009,
                         bf=47.9064, width=752, height=480)
    doc["orb"].update(n_features=1200, max_keypoints=1280)
    doc["capacity"]["max_obs_per_kf"] = 1280
    doc["tracker"]["depth_threshold_factor"] = 35.0
    return doc


def stereo_root(tmp_path):
    """A checkout whose benchmark holds the present data files and, as new
    files and entries only, a stereo configuration, its limits and a cell
    under `slow_walker`. Returns (root, benchmark file)."""
    root = tmp_path
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(core.HERE / sub, root / "benchmark" / sub)
    doc = stereo_doc()
    (root / "benchmark" / "configs" / f"{doc['name']}.json").write_text(
        json.dumps(doc))
    shutil.copy(core.HERE / "limits" / "chunked.slow_walker.json",
                root / "benchmark" / "limits" / f"{CELL}.json")
    bench = json.loads(json.dumps(core.load_bench()))
    bench["configs"].append({
        "name": doc["name"], "source": doc["source"],
        "file": f"benchmark/configs/{doc['name']}.json",
        "reduced": ["tracker", "depth_map_factor"], "why": "x"})
    bench["workloads"].append({"name": CELL, "config": doc["name"],
                               "traffic": "slow_walker", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "fps":
            m["workloads"].append(CELL)
    return root, bench


def _stereo_run(tmp_path, seconds=2.5):
    root, bench = stereo_root(tmp_path)
    spec = harness.tiny(core.Spec(bench, CELL, root=root))
    torch.set_num_threads(4)
    return harness.run(spec, SEED, seconds, False, torch.device("cpu"),
                       time.perf_counter())


@pytest.mark.parametrize("cell", ["chunked.slow_walker",
                                  "live.walkers_fastrot"])
def test_rgbd_render_is_the_parents(cell):
    """The RGB-D runners' views render the frames, bit for bit, that the
    renderer gave before the right view, and no right view, at the
    rehearsal camera `harness.tiny` gave before it scaled a camera's own
    intrinsics."""
    spec = harness.tiny(core.Spec(core.load_bench(), cell))
    assert {k: spec.config["camera"][k]
            for k in ("fx", "fy", "cx", "cy", "bf", "width", "height")} == \
        dict(fx=262.5, fy=262.5, cx=159.5, cy=119.5, bf=20.0, width=320,
             height=240)
    views = spec.runner().Runner.views
    assert views == ("gray", "depth")
    cam = ref_config.from_file(spec.config).camera
    f = traffic.render(spec.traffic, cam, 8, SEED, "cpu", views=views)
    h = hashlib.sha256()
    for a in (f.gray, f.depth, f.T_wc):
        h.update(a.tobytes())
    assert h.hexdigest() == RGBD_HASHES[spec.traffic["name"]]
    assert f.gray_r is None


def test_right_view_is_the_rectified_pair(tmp_path):
    """The right view: the left frames unchanged, the right camera at the
    left pose moved by bf / fx along its +x axis, so that the SAD search
    finds the rendered depth of the left view's keypoints."""
    from benchmark.reference import orb, se3

    root, bench = stereo_root(tmp_path)
    spec = harness.tiny(core.Spec(bench, CELL, root=root))
    cfg = ref_config.from_file(spec.config)
    cam = cfg.camera
    rgbd = traffic.render(spec.traffic, cam, 4, SEED, "cpu")
    pair = traffic.render(spec.traffic, cam, 4, SEED, "cpu",
                          views=("gray", "gray_r"))
    assert np.array_equal(pair.gray, rgbd.gray)
    assert np.array_equal(pair.depth, rgbd.depth)
    T = torch.from_numpy(rgbd.T_wc)
    T_r = traffic.right_poses(cam, T)
    assert torch.equal(T_r[:, :4], T[:, :4])
    moved = se3.quat_rotate(se3.quat_conj(T[:, :4]), T_r[:, 4:] - T[:, 4:])
    assert torch.allclose(moved, torch.tensor([cam.bf / cam.fx, 0.0, 0.0])
                          .expand_as(moved), atol=1e-6)
    feats = orb.extract_frame_stereo(cfg, torch.from_numpy(pair.gray[0]),
                                     torch.from_numpy(pair.gray_r[0]))
    ok = feats.u_right >= 0
    assert int(ok.sum()) > 0.8 * int(feats.valid.sum())
    xy = torch.round(feats.xy_raw[ok]).long()
    truth = torch.from_numpy(pair.depth[0])[xy[:, 1], xy[:, 0]]
    err = ((feats.depth[ok] - truth).abs() / truth).median()
    assert float(err) < 0.05


def test_stereo_runner_keeps_the_chunked_family(tmp_path):
    """The stereo runner's module is `chunked_stereo`, its family the
    chunked runner's, which it subclasses."""
    from benchmark.tests.test_perfbench_files import runner_of_its_family

    root, bench = stereo_root(tmp_path)
    spec = core.Spec(bench, CELL, root=root)
    runner_of_its_family(spec)
    assert spec.runner().Runner.kind == "chunked"
    assert spec.runner().Runner.views == ("gray", "gray_r")


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 7])
def test_reference_stereo_is_the_programs(seed):
    """The frozen SAD search equals the program's, bit for bit, on seeded
    pairs: a textured left image, its right image shifted by a disparity
    ramp, keypoints at every level, some invalid or near the border."""
    from sgslam_tpu_torch.geometry.camera import Camera as ProgCamera
    from sgslam_tpu_torch.ops import stereo as prog_stereo

    g = torch.Generator().manual_seed(seed)
    H, W, N = 60, 160, 96
    left = torch.rand(H, W, generator=g)
    left = (left + torch.roll(left, 1, 1) + torch.roll(left, 1, 0)) / 3
    shift = (4 + 20 * torch.rand(1, generator=g)).item()
    cols = torch.arange(W, dtype=torch.float32) + shift
    x0 = torch.clamp(cols.floor(), 0, W - 2).long()
    fx = cols - cols.floor()
    right = left[:, x0] * (1 - fx) + left[:, x0 + 1] * fx
    right = right + 0.01 * torch.rand(H, W, generator=g)
    xy = torch.stack([torch.rand(N, generator=g) * (W - 1),
                      torch.rand(N, generator=g) * (H - 1)], -1)
    level = torch.randint(0, 8, (N,), generator=g, dtype=torch.int32)
    valid = torch.rand(N, generator=g) > 0.2
    kw = dict(fx=100.0, fy=100.0, cx=79.5, cy=29.5, bf=12.5, width=W,
              height=H)
    for args in ({}, {"max_disparity": 32}, {"step": 2}):
        a = prog_stereo.stereo_match(ProgCamera(**kw), left, right, xy,
                                     level, valid, **args)
        b = ref_stereo.stereo_match(ref_config.Camera(**kw), left, right, xy,
                                    level, valid, **args)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert bool(a[2].any()) and not bool(a[2].all())


def test_stereo_cell_from_new_files_rehearses_correct(tmp_path,
                                                      monkeypatch):
    """A stereo configuration, its limits and its cell added as new files
    and entries run through the harness; `correct` judges stereo samples
    of the front end, u_right among their fields."""
    compared = []
    orig = check.keypoints

    def keypoints(prog, ref, kind):
        compared.append(kind)
        return orig(prog, ref, kind)
    monkeypatch.setattr(check, "keypoints", keypoints)
    result, lines, extra = _stereo_run(tmp_path)
    # no timing decides whether BA is judged: the window runs at least the
    # chunk it begins (frames 8-11 after `tiny`'s 4 + 4 set-up frames), and
    # `tiny`'s keyframe at most every 3 frames puts a keyframe, and its
    # local BA, in that chunk
    assert extra["window"]["first"] == 8
    assert extra["window"]["keyframes"] >= 1
    assert result["correct"], lines
    assert set(result["metrics"]) == {"fps", "setup_s"}
    assert all(c["value"] is not None for c in result["checks"].values())
    assert compared and set(compared) == {"stereo"}
    assert "u_right" in check.FIELDS["stereo"]


def _fault(monkeypatch, change):
    """Break the program's SAD search underneath: `change(d, step)` gives,
    from the disparity d it found, the one the broken search reports."""
    from sgslam_tpu_torch.ops import stereo as prog_stereo

    orig = prog_stereo.stereo_match

    def f(cam, gray_l, gray_r, xy, level, valid, *, max_disparity=96,
          patch=5, step=1):
        u_right, depth, ok = orig(cam, gray_l, gray_r, xy, level, valid,
                                  max_disparity=max_disparity, patch=patch,
                                  step=step)
        d = change(xy[:, 0] - u_right, step)
        return (torch.where(ok, xy[:, 0] - d, u_right),
                torch.where(ok, cam.bf / torch.clamp(d, min=1e-6), depth), ok)
    monkeypatch.setattr(prog_stereo, "stereo_match", f)


@pytest.mark.parametrize("fault", ["disparity_moved_one_step",
                                   "subpixel_refinement_dropped"])
def test_stereo_fault_fails_correct(tmp_path, monkeypatch, fault):
    # the parabola's vertex lies within half a step of the best candidate,
    # so the nearest whole step is the disparity without the refinement
    change = {"disparity_moved_one_step": lambda d, step: d + step,
              "subpixel_refinement_dropped":
                  lambda d, step: torch.round(d / step) * step}[fault]
    _fault(monkeypatch, change)
    result, lines, _ = _stereo_run(tmp_path)
    assert not result["correct"]
    assert result["checks"]["keypoints"]["value"] > \
        result["checks"]["keypoints"]["limit"], lines


def test_u_right_alone_altered_fails_correct(tmp_path, monkeypatch):
    """u_right is compared: moving it alone, depth kept, fails."""
    from sgslam_tpu_torch.ops import stereo as prog_stereo

    orig = prog_stereo.attach_stereo

    def f(cam, feats, gray_l, gray_r):
        out = orig(cam, feats, gray_l, gray_r)
        return dataclasses.replace(
            out, u_right=torch.where(out.u_right >= 0, out.u_right + 0.25,
                                     out.u_right))
    monkeypatch.setattr(prog_stereo, "attach_stereo", f)
    result, lines, _ = _stereo_run(tmp_path)
    assert not result["correct"]
    assert result["checks"]["keypoints"]["value"] > \
        result["checks"]["keypoints"]["limit"], lines
