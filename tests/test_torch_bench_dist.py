"""`sgslam_tpu_torch/bench_dist_ba.py` against `tools/bench_dist_ba.py`.

- The problem (the tum3 camera, 32 cameras, 16384 points, 6 observations
  per point, numpy seed 0 in the tool's order) made here through the JAX
  package as the tool makes it: integer tables exactly, floats within
  1e-5 relative, or 1e-6 of the array's largest magnitude where a value
  is the small difference of large ones (a projection's u = fx x / z + cx
  near 0 px carries the rounding of cx = 319.5: measured 3.2e-5 px on 20
  of 294912 entries). The poses come from each package's `se3_exp`, the
  observations from its projection: f32 rounding.
- A small problem (512 points, 8 cameras, 2 LM steps) at 1 and at 2 gloo
  ranks (spawned processes, the worker's untimed run) against the JAX
  distributed step on a 1 x 1 and a 1 x 2 mesh of the virtual CPU devices
  from the same start: poses and points within tests/test_torch_dist_ba.py's
  1e-4, the damping equal.
- `main(["--cpu", ...])` at that size: one JSON line per layout with the
  tool's keys, labelled "cpu (gloo)".
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.geometry import camera as jcam
from sgslam_tpu.geometry import se3 as jse3
from sgslam_tpu.parallel import dist_ba as jdist
from sgslam_tpu_torch import bench_dist_ba

TOL = 1e-4                    # tests/test_torch_dist_ba.py
TOL_PROBLEM = 1e-5
TOL_PROBLEM_SCALE = 1e-6
SMALL = dict(points=512, cams=8, obs_per=6, iters=2)
SPAWN_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_problem(points, cams, obs_per):
    """tools/bench_dist_ba.py's problem, as the tool builds it."""
    cam = jcfg.tum3_config().camera
    rng = np.random.default_rng(0)
    C, P, O_per = cams, points, obs_per
    xi = (0.02 * rng.standard_normal((C, 6))).astype(np.float32)
    poses = jax.vmap(jse3.se3_exp)(jnp.asarray(xi))
    pts = jnp.asarray(rng.uniform([-3, -2, 1.5], [3, 2, 8],
                                  size=(P, 3)).astype(np.float32))
    obs_pt_g = np.repeat(np.arange(P), O_per)
    obs_cam = jnp.asarray((obs_pt_g * 7919 + np.tile(np.arange(O_per), P))
                          % C, jnp.int32)
    uvr = jcam.project_stereo(
        cam, jse3.se3_apply(poses[obs_cam], pts[jnp.asarray(obs_pt_g)]))
    opt_mask = jnp.asarray([False] + [True] * (C - 1))
    obs_w = jnp.ones(len(obs_pt_g), jnp.float32)
    return cam, poses, pts + 0.02, obs_cam, obs_pt_g, uvr, opt_mask, obs_w


def test_problem_matches_the_tool():
    ref = _reference_problem(16384, 32, 6)
    got = bench_dist_ba.problem(16384, 32, 6)
    for name, a, b in zip(("poses", "points", "obs_cam", "obs_pt", "obs_uvr",
                           "opt_mask", "obs_w"), got[1:], ref[1:]):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(
                a, b, rtol=TOL_PROBLEM,
                atol=TOL_PROBLEM_SCALE * np.abs(b).max(), err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _jax_run(n_pt, points, cams, obs_per, iters):
    """The tool's SPMD steps on a 1 x n_pt mesh from the untimed start."""
    cam, poses, pts, obs_cam, obs_pt_g, uvr, opt_mask, obs_w = \
        _reference_problem(points, cams, obs_per)
    mesh = jdist.make_mesh(1, n_pt, devices=jax.devices()[:n_pt])
    sh = jdist.make_shardings(mesh)
    per = points // n_pt
    step = jdist.make_distributed_ba_step(cam, mesh, cams)
    put = jax.device_put
    p = put(poses, sh["replicated"])
    x = put(pts, sh["pt"])
    args = (put(opt_mask, sh["replicated"]),
            put(obs_cam, sh["pt"]),
            put(jnp.asarray(obs_pt_g % per, jnp.int32), sh["pt"]),
            put(uvr, sh["pt"]), put(obs_w, sh["pt"]))
    lam = put(jnp.asarray(1e-3), sh["replicated"])
    for _ in range(iters):
        p, x, lam = step(p, args[0], x, *args[1:], lam)
    return np.asarray(p), np.asarray(x), float(lam)


@pytest.mark.parametrize("n_pt", [1, 2])
def test_layout_matches_the_jax_step(n_pt, tmp_path):
    bench_dist_ba.run_layout(n_pt, SMALL["points"], SMALL["cams"],
                             SMALL["obs_per"], SMALL["iters"], "cpu",
                             str(tmp_path), reps=1, timeout=SPAWN_TIMEOUT_S)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n_pt)]
    p_ref, x_ref, lam_ref = _jax_run(n_pt, **SMALL)
    for r in ranks:
        np.testing.assert_allclose(r["poses"], p_ref, atol=TOL, rtol=0)
        assert float(r["lam"]) == lam_ref
    x_port = np.concatenate([r["points"] for r in ranks])
    np.testing.assert_allclose(x_port, x_ref, atol=TOL, rtol=0)
    # the steps moved the points by more than the tolerance (the poses
    # start exact and move by ~2e-4)
    start = np.asarray(_reference_problem(SMALL["points"], SMALL["cams"],
                                          SMALL["obs_per"])[2])
    assert np.abs(x_ref - start).max() > 5 * TOL


def test_main_on_the_cpu(capsys):
    assert bench_dist_ba.main([
        "--cpu", "--devices", "1", "--points", str(SMALL["points"]),
        "--cams", str(SMALL["cams"]), "--iters", str(SMALL["iters"])]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert {"pt_shards", "points", "cams", "obs", "iters", "wall_s",
            "speedup_vs_1shard"} <= set(row)
    assert row["pt_shards"] == 1 and row["speedup_vs_1shard"] == 1.0
    assert row["obs"] == SMALL["points"] * SMALL["obs_per"]
    assert row["device"] == "cpu (gloo)" and row["wall_s"] > 0
    assert row["segment_sum_launches"] is None
