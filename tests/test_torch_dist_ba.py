"""`sgslam_tpu_torch/parallel/dist_ba.py` against `sgslam_tpu/parallel/
dist_ba.py`: one SPMD Gauss-Newton step on tests/test_dist_ba.py's problem.

The port runs as four gloo ranks in spawned processes (a 2 x 2 grid,
`multihost.spawn`, joined within a deadline); the reference runs on a 2 x 2
mesh of the virtual CPU devices that tests/conftest.py makes. Poses and
points must agree within 1e-4, tests/test_dist_ba.py's own tolerance for
its sharded step against the unsharded one: the collectives sum partial
Schur complements in another order than XLA's psum, so the two differ in
float32 rounding. C = 4 divides into the 'kf' size; C = 5 does not, and
then the reference's clamped row slice shifts the last rank's rows, which
the port must reproduce.

`distributed_ba` runs in this process at world size 1 (gloo, a file
rendezvous under tmp_path) and must recover tests/test_dist_ba.py's
perturbed problem as that test demands of the reference. The `--procs`
demo refuses more NCCL ranks than the machine has cards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sgslam_tpu.geometry import se3 as jse3
from sgslam_tpu.parallel import dist_ba as jdist
from sgslam_tpu_torch import config
from sgslam_tpu_torch.geometry import se3
from sgslam_tpu_torch.parallel import dist_ba, multihost

import torch_dist_workers
from test_dist_ba import make_problem

TOL = 1e-4
SPAWN_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(C):
    """tests/test_dist_ba.py's problem with C cameras, every camera seen
    (obs_per_pt = C), perturbed points; observations grouped by point, so
    that contiguous slabs keep each observation with its point."""
    rng = np.random.default_rng(C)
    cam, poses_gt, pts_gt, obs_cam, obs_pt_g, obs_uvr = make_problem(
        rng, C=C, obs_per_pt=C)
    P = pts_gt.shape[0]
    per = P // 2
    pts0 = np.asarray(pts_gt) + 0.05 * rng.normal(
        size=(P, 3)).astype(np.float32)
    return {"poses": np.asarray(poses_gt, np.float32),
            "opt_mask": np.array([False] + [True] * (C - 1)),
            "points": pts0.astype(np.float32),
            "obs_cam": obs_cam.astype(np.int32),
            "obs_pt": (obs_pt_g % per).astype(np.int32),
            "obs_uvr": np.asarray(obs_uvr, np.float32),
            "obs_w": np.ones(len(obs_cam), np.float32)}


def _jax_step(g):
    mesh = jdist.make_mesh(2, 2, devices=jax.devices()[:4])
    sh = jdist.make_shardings(mesh)
    step = jdist.make_distributed_ba_step(_jax_cam(), mesh,
                                          g["poses"].shape[0])
    put = jax.device_put
    p, x, lam = step(put(jnp.asarray(g["poses"]), sh["replicated"]),
                     put(jnp.asarray(g["opt_mask"]), sh["replicated"]),
                     put(jnp.asarray(g["points"]), sh["pt"]),
                     put(jnp.asarray(g["obs_cam"]), sh["pt"]),
                     put(jnp.asarray(g["obs_pt"]), sh["pt"]),
                     put(jnp.asarray(g["obs_uvr"]), sh["pt"]),
                     put(jnp.asarray(g["obs_w"]), sh["pt"]),
                     put(jnp.asarray(1e-3, jnp.float32), sh["replicated"]))
    return np.asarray(p), np.asarray(x), float(lam)


def _jax_cam():
    from sgslam_tpu import config as jcfg

    return jcfg.tum3_config().camera


@pytest.fixture(scope="module")
def spawned_steps(tmp_path_factory):
    """The port's step on both cases, from four spawned gloo ranks."""
    tmp = tmp_path_factory.mktemp("dist_ba")
    cases = {C: _case(C) for C in (4, 5)}
    np.savez(tmp / "cases.npz", **{f"C{C}/{k}": v for C, g in cases.items()
                                   for k, v in g.items()})
    multihost.spawn(torch_dist_workers.ba_step, 4,
                    (str(tmp / "cases.npz"), str(tmp)), device="cpu",
                    timeout=SPAWN_TIMEOUT_S)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return cases, ranks


@pytest.mark.parametrize("C", [4, 5])
def test_step_matches_reference_2x2(spawned_steps, C):
    cases, ranks = spawned_steps
    g = cases[C]
    p_ref, x_ref, lam_ref = _jax_step(g)
    key = f"C{C}"
    # every rank holds the same poses; rank (kf, pt) holds slab pt
    for r in range(4):
        np.testing.assert_allclose(ranks[r][f"{key}/poses"], p_ref, atol=TOL)
        assert float(ranks[r][f"{key}/lam"]) == lam_ref
    x_port = np.concatenate([ranks[0][f"{key}/points"],
                             ranks[1][f"{key}/points"]])
    np.testing.assert_array_equal(ranks[2][f"{key}/points"],
                                  ranks[0][f"{key}/points"])
    np.testing.assert_allclose(x_port, x_ref, atol=TOL)
    # the step moved the poses by more than the tolerance, so that the
    # comparison is not vacuous
    assert np.abs(p_ref - g["poses"]).max() > 5 * TOL


def test_clamped_rows_differ_from_padded_rows(spawned_steps):
    """C = 5 on two 'kf' ranks: the clamped slice is a different function
    from a padded one (the reference's step with one more, unobserved
    camera), and the port computes the clamped one."""
    cases, ranks = spawned_steps
    g = dict(cases[5])
    g6 = dict(g, poses=np.concatenate([g["poses"], g["poses"][:1]]),
              opt_mask=np.concatenate([g["opt_mask"], [False]]))
    p6, _, _ = _jax_step(g6)
    assert np.abs(p6[:5] - ranks[0]["C5/poses"]).max() > TOL


def test_collective_bytes():
    b = dist_ba.collective_bytes(140, 1, 1)
    assert b == {"all_reduce_pt": 140 * 36 * 140 * 4 + 140 * 24 + 140 * 144
                 + 8, "all_gather_kf": 0}
    b = dist_ba.collective_bytes(5, 2, 2)
    assert b["all_gather_kf"] == 2 * (3 * 36 * 5 * 4 + 3 * 24)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        yield dist_ba.make_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_distributed_ba_converges_world_of_one(world_of_one):
    """tests/test_dist_ba.py::test_distributed_ba_converges' problem and
    gates, at world size 1."""
    rng = np.random.default_rng(0)
    cam, poses_gt, pts_gt, obs_cam, obs_pt_g, obs_uvr = make_problem(rng)
    C, P = poses_gt.shape[0], pts_gt.shape[0]
    poses_gt = torch.from_numpy(np.array(poses_gt))
    pts_gt = torch.from_numpy(np.array(pts_gt))
    poses0 = se3.se3_compose(se3.se3_exp(torch.from_numpy(
        0.05 * rng.normal(size=(C, 6)).astype(np.float32))), poses_gt)
    poses0[0] = poses_gt[0]
    pts0 = pts_gt + torch.from_numpy(0.05 * rng.normal(
        size=(P, 3)).astype(np.float32))
    poses, points = dist_ba.distributed_ba(
        config.tum3_config().camera, world_of_one, poses0,
        torch.tensor([False] + [True] * (C - 1)), pts0,
        torch.from_numpy(obs_cam.astype(np.int32)),
        torch.from_numpy(obs_pt_g.astype(np.int32)),
        torch.from_numpy(np.asarray(obs_uvr)), torch.ones(len(obs_cam)),
        iters=15)
    err = se3.se3_log(se3.se3_compose(poses, se3.se3_inverse(poses_gt)))
    assert float(torch.linalg.vector_norm(err, dim=1).max()) < 5e-3
    assert float(torch.median(torch.linalg.vector_norm(points - pts_gt,
                                                       dim=1))) < 2e-2
    # the same problem through the reference's step reaches the same poses
    jp = jnp.asarray(poses0.numpy())
    mesh = jdist.make_mesh(1, 1, devices=jax.devices()[:1])
    sh = jdist.make_shardings(mesh)
    ref, _ = jdist.distributed_ba(
        _jax_cam(), mesh, jax.device_put(jp, sh["replicated"]),
        jax.device_put(jnp.asarray([False] + [True] * (C - 1)),
                       sh["replicated"]),
        jax.device_put(jnp.asarray(pts0.numpy()), sh["pt"]),
        jax.device_put(jnp.asarray(obs_cam, jnp.int32), sh["pt"]),
        jax.device_put(jnp.asarray(obs_pt_g, jnp.int32), sh["pt"]),
        jax.device_put(obs_uvr, sh["pt"]),
        jax.device_put(jnp.ones(len(obs_cam)), sh["pt"]), iters=15)
    ref_err = jax.vmap(lambda a, b: jse3.se3_log(jse3.se3_compose(
        a, jse3.se3_inverse(b))))(ref, jnp.asarray(poses.numpy()))
    assert float(jnp.abs(ref_err).max()) < 1e-3


def test_demo_refuses_more_ranks_than_cards(monkeypatch):
    """`python -m sgslam_tpu_torch.parallel.multihost --procs N` on NCCL
    needs N cards (NCCL refuses two ranks on one): it stops before it
    spawns anything."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    spawned = []
    monkeypatch.setattr(multihost, "spawn", lambda *a, **k: spawned.append(a))
    with pytest.raises(SystemExit, match="--procs 2 needs as many GPUs"):
        multihost.main(["--procs", "2"])
    assert not spawned
