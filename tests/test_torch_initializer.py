"""The port's monocular two-view initializer (`optim/initializer.py`)
against the JAX package's, on tests/test_mono_stereo.py's three problems
(general motion, a planar scene, garbage matches) with the reference's
RANSAC draws replayed, and each helper on numpy-seeded inputs.

Scores are f32 sums over ~500 matches and the winning hypothesis is their
argmax, so rounding can change the winner among near-ties; the motion
candidates then come from batched SVDs. The yardstick is the reference's
own spread under one-ulp moves of the match coordinates, `python
tools/parity_spread.py init` (CPU, seeds 0-5): `ok` and `used_H` never
change; on the accepted problems (both won by H) `rh` moves by up to
7.9e-6, T21 by up to 2.2e-5 (general) and 5.3e-5 (planar), no `good` flag
flips, and the good points move by up to 5.5e-4 (general) and 2.7e-3
(planar) of their distance; on the garbage problem (rejected) `rh` moves
by up to 0.032, T21 arbitrarily (its E is noise) and 0-2 `good` flags
flip. The port: `ok` and `used_H` identical, `rh` within 7.2e-7 / 3.7e-6
/ 2.2e-6, T21 within 1.9e-5 / 2.1e-5, points within 4.7e-4 / 1.5e-3 of
their distance, `good` flips 0 / 0 / 2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.geometry import se3 as jse3
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.matching import search as jsearch
from sgslam_tpu.ops import orb as jorb
from sgslam_tpu.optim import initializer as jinit
from sgslam_tpu_torch.geometry.camera import Camera as TCamera
from sgslam_tpu_torch.optim import initializer as tinit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = jcfg.synthetic_config(width=320, height=240)
ORB = jcfg.OrbConfig(n_features=500, max_keypoints=512)
JCAM = CFG.camera
TCAM = TCamera(**dataclasses.asdict(JCAM))
ITERS = 200

# the reference's own spread (module docstring), rounded up, per problem:
# (rh, T21 entries, good flips, good points relative to their distance)
SPREAD = {"general": (1e-5, 3e-5, 0, 6e-4),
          "planar": (1e-5, 6e-5, 0, 3e-3),
          "garbage": (0.04, None, 2, None)}
TOL = dict(rtol=1e-4, atol=1e-5)   # helpers: f32 on unit-scale values


def _t(x):
    return torch.from_numpy(np.array(x))


def _matched_pairs(g1, g2):
    f1 = jorb.extract(g1, ORB, JCAM)
    f2 = jorb.extract(g2, ORB, JCAM)
    idx, ok, _ = jsearch.match_by_descriptor(
        f1.desc, f1.valid, f2.desc, f2.valid, jcfg.MatcherConfig(),
        mutual=True)
    return (np.asarray(f1.xy_raw), np.asarray(f2.xy_raw[idx]),
            np.asarray(ok & f1.valid))


def problems():
    """tests/test_mono_stereo.py's three problems: name -> (p1, p2, valid,
    key seed)."""
    out = {}
    T1 = jse3.se3_identity()
    xi = jnp.asarray([0.25, 0.04, 0.05, 0.01, 0.06, 0.005], jnp.float32)
    g1, _ = jsyn.render_frame(JCAM, T1)
    g2, _ = jsyn.render_frame(JCAM, jse3.se3_exp(xi))
    out["general"] = _matched_pairs(g1, g2) + (0,)
    wall = (jsyn.ROOM[0],)
    xi = jnp.asarray([0.18, 0.02, 0.0, 0.0, 0.03, 0.0], jnp.float32)
    g1, _ = jsyn.render_frame(JCAM, T1, planes=wall)
    g2, _ = jsyn.render_frame(JCAM, jse3.se3_exp(xi), planes=wall)
    out["planar"] = _matched_pairs(g1, g2) + (1,)
    rng = np.random.default_rng(0)
    p1 = rng.uniform([0, 0], [320, 240], size=(300, 2)).astype(np.float32)
    p2 = rng.uniform([0, 0], [320, 240], size=(300, 2)).astype(np.float32)
    out["garbage"] = (p1, p2, np.ones(300, bool), 2)
    return out


def replay_samples(seed, valid, iters=ITERS):
    """The reference's draws inside `initialize_mono(..., PRNGKey(seed))`:
    split once, randint over max(n_valid, 8) for F (8) and H (4)."""
    n = max(int(np.sum(valid)), 8)
    kf, kh = jax.random.split(jax.random.PRNGKey(seed))
    return tuple(torch.from_numpy(np.asarray(
        jax.random.randint(k, (iters, m), 0, n)).astype(np.int64))
        for k, m in ((kf, 8), (kh, 4)))


def jax_init(p1, p2, valid, seed):
    out = jinit.initialize_mono(JCAM, jnp.asarray(p1), jnp.asarray(p2),
                                jnp.asarray(valid), jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in out.items()}


def port_init(p1, p2, valid, seed):
    out = tinit.initialize_mono(TCAM, _t(p1), _t(p2), _t(valid),
                                samples=replay_samples(seed, valid))
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def probs():
    return problems()


@pytest.mark.parametrize("name,accepted,used_H", [
    ("general", True, True), ("planar", True, True),
    ("garbage", False, False)])
def test_initialize_mono_matches_reference(probs, name, accepted, used_H):
    p1, p2, valid, seed = probs[name]
    j, t = jax_init(p1, p2, valid, seed), port_init(p1, p2, valid, seed)
    assert bool(j["ok"]) == accepted and bool(j["used_H"]) == used_H
    assert bool(t["ok"]) == bool(j["ok"])
    assert bool(t["used_H"]) == bool(j["used_H"])
    tol_rh, tol_T21, max_flips, tol_pts = SPREAD[name]
    assert abs(float(t["rh"]) - float(j["rh"])) <= tol_rh
    assert int((t["good"] != j["good"]).sum()) <= max_flips
    if accepted:
        np.testing.assert_allclose(t["T21"], j["T21"], atol=tol_T21, rtol=0)
        g = t["good"] & j["good"]
        assert g.sum() > 60
        # triangulated points of the good matches (unit baseline)
        gap = np.abs(t["points"][g] - j["points"][g]).max(-1)
        assert (gap / np.linalg.norm(j["points"][g], axis=-1)).max() <= (
            tol_pts)


def test_default_draws_initialize(probs):
    """Without replayed draws the port draws its own ranks from a
    generator; the general problem still initializes."""
    p1, p2, valid, _ = probs["general"]
    gen = torch.Generator().manual_seed(0)
    out = tinit.initialize_mono(TCAM, _t(p1), _t(p2), _t(valid), gen)
    assert bool(out["ok"]) and int(out["good"].sum()) > 60
    with pytest.raises(ValueError):
        tinit.initialize_mono(TCAM, _t(p1), _t(p2), _t(valid))


def test_sample_order_is_a_stable_argsort():
    """The ranks index the valid-first order of the matches: a stable
    sort of ~valid, as `jnp.argsort` gives (an unstable sort permutes the
    tied entries and so the sampled ids)."""
    valid = np.random.default_rng(3).uniform(size=700) < 0.6
    ref = np.asarray(jnp.argsort(~jnp.asarray(valid)))
    port = torch.argsort((~_t(valid)).to(torch.uint8), stable=True).numpy()
    np.testing.assert_array_equal(port, ref)


def test_normalize_pts():
    p = np.random.default_rng(4).uniform(0, 320, size=(300, 2)).astype(
        np.float32)
    jpn, jT = jinit._normalize_pts(jnp.asarray(p))
    tpn, tT = tinit._normalize_pts(_t(p))
    np.testing.assert_allclose(tpn.numpy(), np.asarray(jpn), **TOL)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), **TOL)


def _unit(M):
    """Matrices [..., 3, 3] scaled to unit norm with the sign fixed by the
    largest entry: DLT null vectors are defined up to scale and sign."""
    M = M / np.linalg.norm(M.reshape(len(M), -1), axis=1)[:, None, None]
    flat = M.reshape(len(M), -1)
    s = np.sign(flat[np.arange(len(M)), np.abs(flat).argmax(1)])
    return M * s[:, None, None]


@pytest.fixture(scope="module")
def normalized(probs):
    p1, p2, valid, _ = probs["general"]
    rng = np.random.default_rng(5)
    pick = np.stack([rng.choice(np.flatnonzero(valid), 8, replace=False)
                     for _ in range(16)])
    p1n = np.asarray(jinit._normalize_pts(jnp.asarray(p1))[0])
    p2n = np.asarray(jinit._normalize_pts(jnp.asarray(p2))[0])
    return p1, p2, valid, p1n[pick], p2n[pick]


def test_dlt_fundamental_and_homography(normalized):
    _, _, _, a, b = normalized
    jF = np.stack([np.asarray(jinit._dlt_fundamental(jnp.asarray(x),
                                                     jnp.asarray(y)))
                   for x, y in zip(a, b)])
    tF = tinit._dlt_fundamental(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(_unit(tF), _unit(jF), rtol=0, atol=1e-4)
    assert np.abs(np.linalg.det(tF)).max() < 1e-5     # rank 2
    jH = np.stack([np.asarray(jinit._dlt_homography(jnp.asarray(x[:4]),
                                                    jnp.asarray(y[:4])))
                   for x, y in zip(a, b)])
    tH = tinit._dlt_homography(_t(a[:, :4]), _t(b[:, :4])).numpy()
    np.testing.assert_allclose(_unit(tH), _unit(jH), rtol=0, atol=1e-4)


def test_errors_and_scores(normalized):
    """The transfer and epipolar errors and the truncated scores of the
    same F and H matrices (the reference's), batched in the port."""
    p1, p2, valid, a, b = normalized
    Fs = np.stack([np.asarray(jinit._dlt_fundamental(jnp.asarray(x),
                                                     jnp.asarray(y)))
                   for x, y in zip(a, b)])
    Hs = np.stack([np.asarray(jinit._dlt_homography(jnp.asarray(x[:4]),
                                                    jnp.asarray(y[:4])))
                   for x, y in zip(a, b)])
    for fn, th, mats in ((jinit._epi_err_F, jinit.TH_F, Fs),
                         (jinit._sym_transfer_err_H, jinit.TH_H, Hs)):
        tfn = getattr(tinit, fn.__name__)
        te1, te2 = (x.numpy() for x in tfn(_t(mats), _t(p1), _t(p2)))
        ts, tin = tinit._score(_t(te1), _t(te2), th, _t(valid))
        for k, M in enumerate(mats):
            je1, je2 = (np.asarray(x) for x in fn(
                jnp.asarray(M), jnp.asarray(p1), jnp.asarray(p2)))
            np.testing.assert_allclose(te1[k], je1, rtol=1e-3, atol=1e-3)
            np.testing.assert_allclose(te2[k], je2, rtol=1e-3, atol=1e-3)
            js, jin = jinit._score(jnp.asarray(te1[k]), jnp.asarray(te2[k]),
                                   th, jnp.asarray(valid))
            np.testing.assert_allclose(float(ts[k]), float(js), rtol=1e-5)
            np.testing.assert_array_equal(tin[k].numpy(), np.asarray(jin))


def test_triangulation_and_check_rt(probs):
    """Midpoint triangulation and the cheirality vote of the same (R, t)
    candidates: counts and masks identical, points within f32."""
    p1, p2, valid, seed = probs["general"]
    j = jinit.initialize_mono(JCAM, jnp.asarray(p1), jnp.asarray(p2),
                              jnp.asarray(valid), jax.random.PRNGKey(seed))
    T21 = np.asarray(j["T21"])
    jpw, jcos = jinit._triangulate_midpoint(JCAM, jnp.asarray(T21),
                                            jnp.asarray(p1), jnp.asarray(p2))
    tpw, tcos = tinit._triangulate_midpoint(TCAM, _t(T21)[None], _t(p1),
                                            _t(p2))
    np.testing.assert_allclose(tpw[0].numpy(), np.asarray(jpw), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tcos[0].numpy(), np.asarray(jcos), rtol=0,
                               atol=1e-6)
    R = np.asarray(jse3.quat_to_mat(jnp.asarray(T21[:4])))
    flip = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    Rs, ts = np.stack([R, flip @ R]), np.stack([T21[4:], -T21[4:]])
    inl = np.asarray(j["good"]) | valid
    tc, tT, _, tg = tinit._check_rt(TCAM, _t(Rs), _t(ts), _t(p1), _t(p2),
                                    _t(inl))
    for k in range(2):
        jc, jT, _, jg = jinit._check_rt(JCAM, jnp.asarray(Rs[k]),
                                        jnp.asarray(ts[k]), jnp.asarray(p1),
                                        jnp.asarray(p2), jnp.asarray(inl))
        assert abs(int(tc[k]) - int(jc)) <= 1
        assert int((tg[k].numpy() != np.asarray(jg)).sum()) <= 1
        np.testing.assert_allclose(tT[k].numpy(), np.asarray(jT), rtol=0,
                                   atol=1e-5)
    assert int(tc[0]) > 60 and int(tc[1]) < int(tc[0])
