"""`sgslam_tpu_torch/parallel/map_partition.py` and `parallel/dryrun.py`
against the reference's `map_partition.py` and `__graft_entry__.py`.

- `partition_map` runs the reference's numpy on the same map: every table
  (slabs, shard-local indices, padding, weights) must be identical, at 1, 2
  and 4 shards, on the tracked eval map and on the reference's synthetic
  map; the port's own synthetic map (the same numpy seed) agrees with the
  reference's within 1e-6 relative.
- `map_reprojection_cost` sums 55.7k float32 terms in another order than
  XLA: within 1e-5 relative.
- `distributed_global_ba` at 8 LM iterations on the synthetic map, through
  four spawned gloo ranks (a 2 x 2 grid), under tests/test_map_partition.py
  's gates: the cost below 0.1 of its start, and within 3x of the port's
  single-device `global_ba_step`; its poses within 1e-3 of the reference's
  2 x 2 result (both LM runs converge on exact projections; 1e-3 leaves
  room for accept decisions taken on float32 costs that tie).
- the dryrun end to end at world size 1 on the synthetic map: the same
  noisy start cost as the reference's, and a lower cost after.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sgslam_tpu import config as jcfg
from sgslam_tpu.io import checkpoint as jckpt
from sgslam_tpu.parallel import dist_ba as jdist
from sgslam_tpu.parallel import map_partition as jmp
from sgslam_tpu_torch import config, convert
from sgslam_tpu_torch.io import checkpoint
from sgslam_tpu_torch.optim.global_ba import global_ba_step
from sgslam_tpu_torch.parallel import dryrun, map_partition, multihost

import torch_dist_workers

ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "sgslam_tpu", "assets", "eval_map.npz")
SPAWN_TIMEOUT_S = 120
NOISE_M = 0.03


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_small_config():
    return jcfg.tum3_config(
        capacity=jcfg.MapCapacity(max_keyframes=16, max_points=1024),
        orb=jcfg.OrbConfig(max_keypoints=256))


@pytest.fixture(scope="module")
def eval_maps():
    m_ref, _ = jckpt.load_map(ASSET)
    m_port, _ = checkpoint.load_map(ASSET, device="cpu")
    return (jcfg.synthetic_config(width=640, height=480), m_ref,
            config.synthetic_config(width=640, height=480), m_port)


def _numpy_fields(m):
    return {f.name: np.asarray(getattr(m, f.name))
            for f in dataclasses.fields(m)}


@pytest.fixture(scope="module")
def small_maps():
    """The reference's synthetic map and the same arrays as a port map."""
    jc = _jax_small_config()
    m_ref = graft._synthetic_mapstate(jc, n_kf=6, n_pt=384)
    m_port = convert.map_from_numpy(_numpy_fields(m_ref))
    return jc, m_ref, dryrun.small_config(), m_port


def test_synthetic_mapstate_matches_reference(small_maps):
    """The port's own synthetic map: integer tables identical, floats
    within 1e-6 relative (a few float32 ulps: its se3_exp and projection
    round differently from the reference's)."""
    _, m_ref, pc, _ = small_maps
    ref = _numpy_fields(m_ref)
    got = convert.map_to_numpy(dryrun.synthetic_mapstate(pc, n_kf=6,
                                                         n_pt=384))
    for k, v in ref.items():
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _assert_same_partition(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_partition_tables_identical_eval_map(eval_maps, n_shards):
    jc, m_ref, pc, m_port = eval_maps
    _assert_same_partition(map_partition.partition_map(pc, m_port, n_shards),
                           jmp.partition_map(jc, m_ref, n_shards))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_partition_tables_identical_synthetic_map(small_maps, n_shards):
    jc, m_ref, pc, m_port = small_maps
    _assert_same_partition(map_partition.partition_map(pc, m_port, n_shards),
                           jmp.partition_map(jc, m_ref, n_shards))


def test_reprojection_cost_matches(eval_maps):
    jc, m_ref, pc, m_port = eval_maps
    noise = dryrun.point_noise(tuple(m_port.pt_pos.shape))
    c_ref = jmp.map_reprojection_cost(jc, dataclasses.replace(
        m_ref, pt_pos=m_ref.pt_pos + jnp.asarray(noise)))
    c_port = map_partition.map_reprojection_cost(pc, dataclasses.replace(
        m_port, pt_pos=m_port.pt_pos + torch.from_numpy(noise)))
    assert c_port == pytest.approx(c_ref, rel=1e-5)


def test_writeback_drops_padding(small_maps):
    _, _, pc, m = small_maps
    part = map_partition.partition_map(pc, m, 4)
    pad = int((part.pt_ids < 0).sum())
    assert pad > 0
    out = map_partition.writeback(m, part, part.poses + 1.0,
                                  part.points + 1.0)
    live = torch.from_numpy(part.pt_ids[part.pt_ids >= 0])
    assert torch.equal(out.pt_pos[live], m.pt_pos[live] + 1.0)
    others = torch.ones(m.max_pt, dtype=torch.bool)
    others[live] = False
    assert torch.equal(out.pt_pos[others], m.pt_pos[others])
    assert torch.equal(out.kf_pose[torch.from_numpy(part.kf_ids)],
                       torch.from_numpy(part.poses) + 1.0)


def test_distributed_gba_2x2(small_maps, tmp_path):
    jc, m_ref, pc, m_port = small_maps
    noise = dryrun.point_noise(tuple(m_port.pt_pos.shape), seed=3) \
        * (NOISE_M / dryrun.NOISE_M)
    noisy = dataclasses.replace(m_port,
                                pt_pos=m_port.pt_pos + torch.from_numpy(noise))
    np.savez(tmp_path / "map.npz", **convert.map_to_numpy(noisy))
    multihost.spawn(torch_dist_workers.global_ba, 4,
                    (str(tmp_path / "map.npz"), 2, 8, str(tmp_path)),
                    device="cpu", timeout=SPAWN_TIMEOUT_S)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["pt_pos"], ranks[0]["pt_pos"])
        np.testing.assert_array_equal(r["kf_pose"], ranks[0]["kf_pose"])
    out = dataclasses.replace(noisy,
                              kf_pose=torch.from_numpy(ranks[0]["kf_pose"]),
                              pt_pos=torch.from_numpy(ranks[0]["pt_pos"]))
    c0 = map_partition.map_reprojection_cost(pc, noisy)
    c_dist = map_partition.map_reprojection_cost(pc, out)
    c_single = map_partition.map_reprojection_cost(
        pc, global_ba_step(pc, noisy, iters=8))
    assert c_dist < 0.1 * c0, (c0, c_dist)
    assert c_dist < 3.0 * max(c_single, 1.0), (c_dist, c_single)

    ref_noisy = dataclasses.replace(m_ref,
                                    pt_pos=m_ref.pt_pos + jnp.asarray(noise))
    ref = jmp.distributed_global_ba(
        jc, ref_noisy, jdist.make_mesh(2, 2, devices=jax.devices()[:4]),
        iters=8)
    np.testing.assert_allclose(ranks[0]["kf_pose"], np.asarray(ref.kf_pose),
                               atol=1e-3)


def test_dryrun_world_of_one(small_maps):
    jc, m_ref, pc, m_port = small_maps
    report = dryrun.dryrun_multichip(1, device="cpu", use_asset=False,
                                     timeout=SPAWN_TIMEOUT_S)
    noise = dryrun.point_noise(tuple(m_port.pt_pos.shape), seed=1)
    c0_ref = jmp.map_reprojection_cost(jc, dataclasses.replace(
        m_ref, pt_pos=m_ref.pt_pos + jnp.asarray(noise)))
    assert report["ok"] and report["mesh"] == {"kf": 1, "pt": 1}
    assert report["cost0"] == pytest.approx(c0_ref, rel=1e-5)
    assert report["cost1"] < 0.1 * report["cost0"]
    assert report["C"] == 6 and len(report["step_ms"]) == dryrun.ITERS
