"""`sgslam_tpu_torch/bench_dist_ba_realmap.py` against
`tools/bench_dist_ba_realmap.py`.

- The cost before: the tracked eval map moved by the reference's own noise
  (`0.01 * jax.random.normal(PRNGKey(3))`, handed to the port's `noisy`)
  gives the JAX tool's `cost_before` within 1e-4 relative.
- One LM iteration at (1, 1) through the port's `solve` (a gloo group of
  one) against the reference's `distributed_global_ba` on a 1 x 1 mesh,
  on the reference's synthetic map (`dryrun.synthetic_mapstate`, the
  small configuration; on the eval map the first three LM steps are
  rejected at the default damping, so one iteration leaves the cost where
  it was) with the reference's PRNGKey(3) noise: the cost falls, the poses
  agree within tests/test_torch_map_partition.py's 1e-3 and the costs
  within 1e-3 relative.
- `main(["--cpu", "--devices", "1", ...])` on the eval map with the tool's
  4 iterations: the table labelled "cpu (gloo)" with the map's size, one
  (1, 1) layout whose cost fell, and one JSON line naming the file.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sgslam_tpu import config as jcfg
from sgslam_tpu.io import checkpoint as jckpt
from sgslam_tpu.parallel import dist_ba as jdist
from sgslam_tpu.parallel import map_partition as jmp
import __graft_entry__ as graft
from sgslam_tpu_torch import bench_dist_ba_realmap as realmap
from sgslam_tpu_torch import convert
from sgslam_tpu_torch.io import checkpoint
from sgslam_tpu_torch.parallel import dist_ba, dryrun, map_partition

ASSET = dryrun.EVAL_MAP
TOL_COST0 = 1e-4
TOL_POSE = 1e-3               # tests/test_torch_map_partition.py
TOL_COST1 = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_noise(shape):
    return 0.01 * jax.random.normal(jax.random.PRNGKey(3), shape)


def test_cost_before_matches_the_tool():
    m_ref, _ = jckpt.load_map(ASSET)
    noise = _jax_noise(m_ref.pt_pos.shape)
    c_ref = jmp.map_reprojection_cost(
        jcfg.synthetic_config(width=640, height=480),
        dataclasses.replace(m_ref, pt_pos=m_ref.pt_pos + noise))
    m, _ = checkpoint.load_map(ASSET, device="cpu")
    c_port = map_partition.map_reprojection_cost(
        realmap.make_config(), realmap.noisy(m, np.array(noise)))
    assert c_port == pytest.approx(c_ref, rel=TOL_COST0)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        yield dist_ba.make_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_one_iteration_matches_the_reference(world_of_one):
    jc = jcfg.tum3_config(
        capacity=jcfg.MapCapacity(max_keyframes=16, max_points=1024),
        orb=jcfg.OrbConfig(max_keypoints=256))
    m_ref = graft._synthetic_mapstate(jc, n_kf=6, n_pt=384)
    noise = _jax_noise(m_ref.pt_pos.shape)
    ref_noisy = dataclasses.replace(m_ref, pt_pos=m_ref.pt_pos + noise)
    ref = jmp.distributed_global_ba(
        jc, ref_noisy, jdist.make_mesh(1, 1, devices=jax.devices()[:1]),
        iters=1)
    c_ref0 = jmp.map_reprojection_cost(jc, ref_noisy)
    c_ref1 = jmp.map_reprojection_cost(jc, ref)

    cfg = dryrun.small_config()
    m = convert.map_from_numpy({f.name: np.asarray(getattr(m_ref, f.name))
                                for f in dataclasses.fields(m_ref)})
    m_noisy = realmap.noisy(m, np.array(noise))
    out, wall, c1 = realmap.solve(cfg, m_noisy, world_of_one, 1)
    c0 = map_partition.map_reprojection_cost(cfg, m_noisy)
    assert c0 == pytest.approx(c_ref0, rel=TOL_COST0)
    assert c1 < c0 and wall > 0
    assert c1 == pytest.approx(c_ref1, rel=TOL_COST1)
    np.testing.assert_allclose(out.kf_pose.numpy(), np.asarray(ref.kf_pose),
                               atol=TOL_POSE)


def test_main_on_the_cpu(capsys, tmp_path):
    out = tmp_path / "multichip.json"
    assert realmap.main(["--cpu", "--devices", "1", "--iters", "4",
                         "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip())
    assert line == {"out": str(out), "device": "cpu (gloo)", "layouts": 1,
                    "all_converged": True}
    res = json.loads(out.read_text())
    assert res["device"] == "cpu (gloo)" and res["iters"] == 4
    assert res["map"]["keyframes"] == 140 and res["map"]["source"] == \
        os.path.join("sgslam_tpu", "assets", "eval_map.npz")
    (row,) = res["layouts"]
    assert row["mesh"] == "kf=1 x pt=1" and row["devices"] == 1
    assert row["cost_after"] < res["cost_before"] and row["converged"]
    assert row["wall_s"] > 0 and row["segment_sum_launches"] is None
