"""The port's loop-closing building blocks against the JAX package's, on the
same numpy-seeded inputs: Sim(3) algebra, the BoW vocabulary, Horn and
RANSAC Sim(3), the Sim(3) GN, RANSAC PnP, the essential graph and global BA.

Integer outputs (word ids, edge lists) must be identical. RANSAC draws are
the reference's, replayed (`jax.random.randint` under the reference's key).
Tolerances are stated per test; the global-BA one is the reference's own
spread under one-ulp input moves (`python tools/parity_spread.py loop`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.geometry import camera as jcam
from sgslam_tpu.geometry import se3 as jse3
from sgslam_tpu.mapstate import mapstate as jms
from sgslam_tpu.models import vocab as jvoc
from sgslam_tpu.optim import global_ba as jgba
from sgslam_tpu.optim import pnp as jpnp
from sgslam_tpu.optim import pose_graph as jpg
from sgslam_tpu.optim import sim3 as jsim3
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch import convert
from sgslam_tpu_torch.geometry import se3 as tse3
from sgslam_tpu_torch.models import vocab as tvoc
from sgslam_tpu_torch.optim import global_ba as tgba
from sgslam_tpu_torch.optim import pnp as tpnp
from sgslam_tpu_torch.optim import pose_graph as tpg
from sgslam_tpu_torch.optim import sim3 as tsim3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CAM_J = jcfg.tum3_config().camera
CAM_T = tcfg.tum3_config().camera


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _replay(seed, n_valid, iters, k):
    r = jax.random.randint(jax.random.PRNGKey(seed), (iters, k), 0,
                           max(int(n_valid), k))
    return torch.from_numpy(np.asarray(r).astype(np.int64))


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def _twists(rng, n=64):
    xi = rng.normal(0, 0.5, (n, 7)).astype(np.float32)
    xi[:8, 3:6] *= 1e-6          # the theta -> 0 guards
    xi[8:16, 6] *= 1e-7          # the sigma -> 0 guards
    xi[16:20, 3:7] *= 1e-7       # both
    return xi


def test_sim3_ops_match(rng):
    """exp, log, compose, inverse, apply, from_se3 within 1e-5."""
    xa, xb = _twists(rng), _twists(rng)
    pts = rng.normal(0, 2.0, (64, 3)).astype(np.float32)
    Sa_j, Sb_j = jse3.sim3_exp(jnp.asarray(xa)), jse3.sim3_exp(jnp.asarray(xb))
    Sa_t, Sb_t = tse3.sim3_exp(_t(xa)), tse3.sim3_exp(_t(xb))
    pairs = [
        (Sa_j, Sa_t),
        (jse3.sim3_log(Sa_j), tse3.sim3_log(Sa_t)),
        (jse3.sim3_compose(Sa_j, Sb_j), tse3.sim3_compose(Sa_t, Sb_t)),
        (jse3.sim3_inverse(Sa_j), tse3.sim3_inverse(Sa_t)),
        (jse3.sim3_apply(Sa_j, jnp.asarray(pts)),
         tse3.sim3_apply(Sa_t, _t(pts))),
        (jse3.sim3_from_se3(Sa_j[:, :7]), tse3.sim3_from_se3(Sa_t[:, :7])),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(_np(t), _np(j), atol=1e-5, rtol=1e-5)
    # exp(log(S)) == S
    np.testing.assert_allclose(_np(tse3.sim3_exp(tse3.sim3_log(Sa_t))),
                               _np(Sa_t), atol=1e-5)
    assert tse3.sim3_identity().tolist() == [1, 0, 0, 0, 0, 0, 0, 1]


# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------

def _descs(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, 8),
                        dtype=np.uint64).astype(np.uint32)


@pytest.fixture(scope="module")
def vocabs():
    return jvoc.default_vocab(), tvoc.default_vocab()


def test_default_vocab_is_the_asset(vocabs):
    vj, vt = vocabs
    assert vt.n_words == vj.n_words and vt.depth == vj.depth
    for a, b in zip(vj.level_desc, vt.level_desc):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy())
    np.testing.assert_array_equal(np.asarray(vj.word_idf),
                                  vt.word_idf.numpy())


def test_quantize_bow_score_match(vocabs, rng):
    """Word ids identical; BoW vectors and L1 scores within 1e-6."""
    vj, vt = vocabs
    d = _descs(rng, 1024)
    valid = rng.random(1024) > 0.1
    wj = np.asarray(jvoc.quantize(vj, jnp.asarray(d), jnp.asarray(valid)))
    wt = tvoc.quantize(vt, _t(d.view(np.int32)), _t(valid)).numpy()
    np.testing.assert_array_equal(wt, wj)
    assert (wt[~valid] == -1).all() and len(np.unique(wt[valid])) > 100
    bj = jvoc.bow_vector(vj, jnp.asarray(wj))
    bt = tvoc.bow_vector(vt, _t(wt))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6)
    dbj = jnp.stack([bj, jnp.roll(bj, 7), jnp.zeros_like(bj)])
    dbt = torch.stack([bt, torch.roll(bt, 7), torch.zeros_like(bt)])
    np.testing.assert_allclose(tvoc.l1_score(bt, dbt).numpy(),
                               np.asarray(jvoc.l1_score(bj, dbj)), atol=1e-6)


def test_train_and_random_vocab_match(rng, tmp_path):
    d = _descs(rng, 600)
    vj = jvoc.train_vocab(d, branching=4, depth=2, seed=3)
    vt = tvoc.train_vocab(d, branching=4, depth=2, seed=3)
    for a, b in zip(vj.level_desc, vt.level_desc):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy())
    np.testing.assert_allclose(vt.word_idf.numpy(), np.asarray(vj.word_idf),
                               rtol=1e-6)
    tvoc.save_vocab(str(tmp_path / "v.npz"), vt)
    back = jvoc.load_vocab(str(tmp_path / "v.npz"))
    np.testing.assert_array_equal(np.asarray(back.level_desc[1]),
                                  np.asarray(vj.level_desc[1]))
    rj, rt = jvoc.random_vocab(4, 3), tvoc.random_vocab(4, 3)
    np.testing.assert_array_equal(np.asarray(rj.level_desc[2]).view(np.int32),
                                  rt.level_desc[2].numpy())


# ---------------------------------------------------------------------------
# Horn, RANSAC Sim3, Sim3 GN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_alignment_action(rng, fix_scale):
    """Horn's Sim(3) acts on points within 1e-5 of the reference's (the
    eigenvector's sign is not compared: both make w >= 0)."""
    src = rng.normal(size=(50, 3)).astype(np.float32)
    S_gt = jse3.sim3_exp(jnp.asarray([0.1, 0.0, 0.2, 0.1, -0.2, 0.05, 0.4]))
    dst = np.asarray(jse3.sim3_apply(S_gt[None], jnp.asarray(src)))
    dst = dst + rng.normal(0, 0.01, dst.shape).astype(np.float32)
    w = (rng.random(50) > 0.2).astype(np.float32)
    Sj = jsim3.horn_alignment(jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(w), fix_scale)
    St = tsim3.horn_alignment(_t(src), _t(dst), _t(w), fix_scale)
    probe = rng.normal(0, 2.0, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.sim3_apply(St, _t(probe)).numpy(),
        np.asarray(jse3.sim3_apply(Sj, jnp.asarray(probe))), atol=1e-5)


def _sim3_problem(rng, n=128, n_bad=30):
    T12 = jse3.se3_exp(jnp.asarray([0.2, -0.1, 0.1, 0.05, 0.1, 0.02]))
    S12 = jse3.sim3_from_se3(T12)
    pts2 = rng.uniform([-1, -1, 1.5], [1, 1, 4], size=(n, 3)).astype(
        np.float32)
    pts1 = np.asarray(jse3.sim3_apply(S12[None], jnp.asarray(pts2)))
    uv1 = np.asarray(jcam.project(CAM_J, jnp.asarray(pts1)))
    uv2 = np.asarray(jcam.project(CAM_J, jnp.asarray(pts2)))
    pts2 = pts2.copy()
    pts2[:n_bad] += rng.uniform(0.5, 1.5, size=(n_bad, 3))
    pts1 = pts1 + rng.normal(0, 0.003, pts1.shape)
    valid = rng.random(n) > 0.1
    return (S12, pts1.astype(np.float32), pts2.astype(np.float32),
            uv1, uv2, valid)


def test_ransac_sim3_replayed(rng):
    """The reference's draws replayed: inliers within max(2, 2%), the Sim3
    within 1e-3 m on probe points."""
    S12, p1, p2, uv1, uv2, valid = _sim3_problem(rng)
    key_seed = 5
    Sj, inl_j, nj = jsim3.ransac_sim3(
        CAM_J, *map(jnp.asarray, (p1, p2, uv1, uv2, valid)),
        jax.random.PRNGKey(key_seed), iters=128)
    St, inl_t, nt = tsim3.ransac_sim3(
        CAM_T, *map(_t, (p1, p2, uv1, uv2, valid)),
        samples=_replay(key_seed, valid.sum(), 128, 3), iters=128)
    assert abs(int(nt) - int(nj)) <= max(2, 0.02 * int(nj)), (nt, nj)
    assert int(nj) > 60
    probe = np.random.default_rng(1).normal(0, 2.0, (32, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        tse3.sim3_apply(St, _t(probe)).numpy(),
        np.asarray(jse3.sim3_apply(Sj, jnp.asarray(probe))), atol=1e-3)
    # default draws: a generator, no replay; still finds the transform
    gen = torch.Generator().manual_seed(0)
    Sg, _, ng = tsim3.ransac_sim3(CAM_T, *map(_t, (p1, p2, uv1, uv2, valid)),
                                  gen, iters=128)
    assert int(ng) > 60


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3_matches(rng, fix_scale):
    """Sim3 GN from the same start: within 1e-4, inlier masks equal."""
    S12, p1, p2, uv1, uv2, valid = _sim3_problem(rng, n=160, n_bad=32)
    S0 = jse3.sim3_compose(jse3.sim3_exp(jnp.asarray(
        [0.05, -0.03, 0.04, 0.02, -0.02, 0.01, 0.05 * (not fix_scale)])), S12)
    Sj, inl_j, nj = jsim3.optimize_sim3(
        CAM_J, S0, *map(jnp.asarray, (p1, p2, uv1, uv2, valid)), rounds=3,
        iters=6, fix_scale=fix_scale)
    St, inl_t, nt = tsim3.optimize_sim3(
        CAM_T, _t(S0), *map(_t, (p1, p2, uv1, uv2, valid)), rounds=3,
        iters=6, fix_scale=fix_scale)
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), atol=1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(nt) == int(nj) > 100


# ---------------------------------------------------------------------------
# PnP
# ---------------------------------------------------------------------------

def test_ransac_pnp_replayed(rng):
    """DLT RANSAC + pose polish with the reference's draws: inliers within
    max(2, 2%), poses within 1e-3 m (the SVD's signs are not compared)."""
    n = 200
    Tcw = jse3.se3_exp(jnp.asarray([0.1, -0.2, 0.3, 0.1, 0.2, -0.1]))
    pc = rng.uniform([-1.5, -1.2, 1.5], [1.5, 1.2, 4.0], (n, 3)).astype(
        np.float32)
    pw = np.asarray(jse3.se3_apply(jse3.se3_inverse(Tcw)[None],
                                   jnp.asarray(pc)))
    uv = np.asarray(jcam.project(CAM_J, jnp.asarray(pc)))
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    uv[:40] = rng.uniform([0, 0], [640, 480], (40, 2))
    valid = rng.random(n) > 0.05
    Tj, inl_j, nj = jpnp.ransac_pnp(CAM_J, jnp.asarray(pw), jnp.asarray(uv),
                                    jnp.asarray(valid),
                                    jax.random.PRNGKey(9), iters=256)
    Tt, inl_t, nt = tpnp.ransac_pnp(CAM_T, _t(pw), _t(uv), _t(valid),
                                    samples=_replay(9, valid.sum(), 256, 6),
                                    iters=256)
    assert abs(int(nt) - int(nj)) <= max(2, 0.02 * int(nj)), (nt, nj)
    assert int(nj) > 120
    np.testing.assert_allclose(Tt[4:].numpy(), np.asarray(Tj)[4:], atol=1e-3)
    q = np.asarray(Tj)[:4]
    assert abs(abs(float(np.dot(Tt[:4].numpy(), q))) - 1.0) < 1e-6
    # the DLT alone on six exact correspondences
    uv_exact = np.asarray(jcam.project(CAM_J, jnp.asarray(pc)))
    T6 = tpnp.dlt_pose(_t(pw[50:56]), _t(uv_exact[50:56]), CAM_T)
    np.testing.assert_allclose(T6[4:].numpy(), np.asarray(Tcw)[4:],
                               atol=1e-3)


# ---------------------------------------------------------------------------
# Essential graph
# ---------------------------------------------------------------------------

def test_build_essential_edges_identical(rng):
    K = 24
    c = rng.integers(0, 200, (K, K)).astype(np.float32)
    cov = np.triu(c, 1) + np.triu(c, 1).T
    poses = np.asarray(jse3.sim3_exp(jnp.asarray(_twists(rng, K))))
    parent = np.array([-1] + [int(rng.integers(0, k)) for k in range(1, K)])
    parent[5] = -1
    li, lj = np.array([20, 17]), np.array([2, 3])
    lm = [np.asarray(poses[0]), np.asarray(poses[1])]
    ej = jpg.build_essential_edges(cov, poses, parent, li, lj, lm,
                                   max_edges=512)
    et = tpg.build_essential_edges(cov, poses, parent, li, lj, lm,
                                   max_edges=512)
    for a, b in zip((0, 1, 3), (0, 1, 3)):
        np.testing.assert_array_equal(et[b].numpy(), np.asarray(ej[a]))
    np.testing.assert_allclose(et[2].numpy(), np.asarray(ej[2]), atol=1e-6)


@pytest.fixture(scope="module")
def loop_graph():
    """test_loop_components.py's drifted 12-pose circle with a loop edge."""
    K = 12
    gt = [jse3.sim3_identity()]
    step = jse3.sim3_exp(jnp.asarray([0.5, 0, 0, 0, 0, 2 * np.pi / K, 0],
                                     jnp.float32))
    for _ in range(1, K):
        gt.append(jse3.sim3_compose(step, gt[-1]))
    gt = jnp.stack(gt)
    noise = jse3.sim3_exp(jnp.asarray([0.02, 0.01, 0, 0, 0, 0.015, 0],
                                      jnp.float32))
    meas_step = jse3.sim3_compose(noise, step)
    poses = [np.asarray(gt[0])]
    for _ in range(1, K):
        poses.append(np.asarray(jse3.sim3_compose(meas_step,
                                                  jnp.asarray(poses[-1]))))
    poses = np.stack(poses)
    ei = list(range(K - 1)) + [K - 1]
    ej = list(range(1, K)) + [0]
    meas = [np.asarray(jse3.sim3_compose(jnp.asarray(poses[a]),
                                         jse3.sim3_inverse(
                                             jnp.asarray(poses[b]))))
            for a, b in zip(ei[:-1], ej[:-1])]
    meas.append(np.asarray(jse3.sim3_compose(gt[K - 1],
                                             jse3.sim3_inverse(gt[0]))))
    pad = 4
    ei, ej = ei + [0] * pad, ej + [0] * pad
    meas = np.concatenate([np.stack(meas), np.tile(np.asarray(
        jse3.sim3_identity())[None], (pad, 1))]).astype(np.float32)
    w = np.array([1.0] * (K - 1) + [5.0] + [0.0] * pad, np.float32)
    valid = np.ones(K, bool)
    fixed = np.array([True] + [False] * (K - 1))
    return (poses, valid, fixed, np.array(ei, np.int32),
            np.array(ej, np.int32), meas, w, np.asarray(gt))


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_pose_graph_matches(loop_graph, fix_scale):
    """40 GN iterations on the seeded loop graph: poses within 1e-4, and the
    Jacobians of one edge (the reference's jacfwd, the port's float64
    central differences) within 1e-5."""
    args = loop_graph[:7]
    oj = jpg.optimize_pose_graph(*map(jnp.asarray, args), iters=40,
                                 fix_scale=fix_scale)
    ot = tpg.optimize_pose_graph(*map(_t, args), iters=40,
                                 fix_scale=fix_scale)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-4)
    poses, meas = loop_graph[0], loop_graph[5]
    z7 = jnp.zeros(7)
    Ji = jpg._jac_i(z7, z7, jnp.asarray(poses[3]), jnp.asarray(poses[4]),
                    jnp.asarray(meas[3]))
    Jt, _ = tpg.edge_jacobians(_t(poses[3:4]), _t(poses[4:5]),
                               _t(meas[3:4]))
    np.testing.assert_allclose(Jt[0].numpy(), np.asarray(Ji), atol=1e-5)
    # the loop edge's residual vanishes, as in the reference's test
    r = tpg.edge_residual(ot[11], ot[0], _t(meas[11]))
    assert float(torch.linalg.vector_norm(r)) < 0.02


# ---------------------------------------------------------------------------
# Global BA
# ---------------------------------------------------------------------------

GBA_CFG_J = jcfg.synthetic_config(
    width=320, height=240, orb=jcfg.OrbConfig(n_features=600,
                                               max_keypoints=640),
    capacity=jcfg.MapCapacity(max_keyframes=64, max_points=8192,
                              local_window=4, local_points=1024))
GBA_CFG_T = tcfg.synthetic_config(
    width=320, height=240, orb=tcfg.OrbConfig(n_features=600,
                                               max_keypoints=640),
    capacity=tcfg.MapCapacity(max_keyframes=64, max_points=8192,
                              local_window=4, local_points=1024))
# the reference's own spread (python tools/parity_spread.py loop, CPU, 3
# seeds): with the map's points moved by one ulp its pinned 10-iteration
# GBA moves poses by 0.21-0.34 mm (quaternions 3.6-5.7e-5) and points by a
# median 0.25-0.35 mm, at most 1.6-2.1 mm; the port: 0.27 mm, 4.4e-5,
# 0.26 mm, 1.8 mm. Tolerances: the largest seed's, rounded up.
TOL_GBA_T = 4e-4
TOL_GBA_Q = 6e-5
TOL_GBA_P_MEDIAN = 4e-4
TOL_GBA_P_MAX = 2.5e-3


def _perturbed_map(C=6, P=400):
    """tests/test_global_ba.py's exactly consistent map, poses and points
    perturbed, as numpy."""
    cam = GBA_CFG_J.camera
    rng = np.random.default_rng(11)
    m = jms.empty_map(GBA_CFG_J.capacity, GBA_CFG_J.orb.max_keypoints)
    xi = (0.15 * np.arange(C)[:, None]
          * np.array([[1, 0.2, 0.1, 0.05, 0.1, 0.02]])).astype(np.float32)
    poses = jax.vmap(jse3.se3_exp)(jnp.asarray(xi))
    pts = jnp.asarray(rng.uniform([-1.5, -1.2, 2.0], [1.5, 1.2, 5.0],
                                  size=(P, 3)).astype(np.float32))
    N = m.n_feat
    obs = np.full((m.max_kf, N), -1, np.int32)
    for c in range(C):
        obs[c, :P] = rng.permutation(P)
    obs = jnp.asarray(obs)
    pc = jax.vmap(lambda T, ids: jse3.se3_apply(T[None], pts[ids]))(
        poses, obs[:C])
    uvr = jax.vmap(lambda x: jcam.project_stereo(cam, x))(pc)
    noise = rng.normal(0, 0.02, (C, 6)).astype(np.float32)
    noise[0] = 0.0
    poses_n = jax.vmap(lambda T, d: jse3.se3_compose(jse3.se3_exp(d), T))(
        poses, jnp.asarray(noise))
    m = dataclasses.replace(
        m, kf_pose=m.kf_pose.at[:C].set(poses_n),
        kf_valid=m.kf_valid.at[:C].set(True),
        kf_feat_xy=m.kf_feat_xy.at[:C].set(uvr[..., :2]),
        kf_feat_uvr=m.kf_feat_uvr.at[:C].set(uvr[..., 2]),
        kf_feat_valid=m.kf_feat_valid.at[:C, :P].set(True),
        kf_obs_point=obs,
        pt_pos=m.pt_pos.at[:P].set(
            pts + rng.normal(0, 0.02, (P, 3)).astype(np.float32)),
        pt_valid=m.pt_valid.at[:P].set(True),
        next_kf=jnp.asarray(C, jnp.int32), next_pt=jnp.asarray(P, jnp.int32))
    return {k: np.asarray(v) for k, v in dataclasses.asdict(m).items()}


def test_global_ba_step_matches():
    """One pinned global-BA pass (10 iterations, tol 0): poses and points
    within the reference's own one-ulp spread (TOL_GBA_*)."""
    arrays = _perturbed_map()
    mj = jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    mt = convert.map_from_numpy(arrays)
    fixed = np.zeros(64, bool)
    fixed[3] = True
    oj = jgba.global_ba_step(GBA_CFG_J, mj, iters=10,
                             fixed_extra=jnp.asarray(fixed))
    ot = tgba.global_ba_step(GBA_CFG_T, mt, iters=10, fixed_extra=_t(fixed))
    pj, pt = np.asarray(oj.kf_pose)[:6], ot.kf_pose[:6].numpy()
    np.testing.assert_allclose(pt[:, 4:], pj[:, 4:], atol=TOL_GBA_T)
    np.testing.assert_allclose(pt[:, :4], pj[:, :4], atol=TOL_GBA_Q)
    np.testing.assert_array_equal(pt[[0, 3]], arrays["kf_pose"][[0, 3]])
    d = np.linalg.norm(ot.pt_pos[:400].numpy() - np.asarray(oj.pt_pos)[:400],
                       axis=1)
    assert np.median(d) < TOL_GBA_P_MEDIAN and d.max() < TOL_GBA_P_MAX
    # the pass moved the perturbed map toward its consistent optimum
    moved = np.abs(pt - arrays["kf_pose"][:6]).max()
    assert moved > 1e-3
