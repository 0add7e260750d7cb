"""Map insertion and local-point selection parity, on a map built by the
JAX package and carried across with `convert.py`."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.geometry import se3 as jse3
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.mapstate import local_map as jlm
from sgslam_tpu.mapstate import mapstate as jms
from sgslam_tpu.slam import tracking as jtr
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch import convert
from sgslam_tpu_torch.mapstate import local_map as tlm
from sgslam_tpu_torch.mapstate import mapstate as tms


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the test workers share
    the host's cores (with torch's default threads, test_torch_tracking.py
    took 524 s in the 6-worker suite; with one, 39 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# f32 positions of ~1-4 m from backprojection and a pose inverse computed
# in another order: a few ulps of 4 m.
TOL_POS = 1e-5
# unit normals and distance bands, relative
RTOL = 1e-5


def _cfg(c):
    return c.synthetic_config(
        width=320, height=240,
        orb=c.OrbConfig(n_features=600, max_keypoints=640),
        capacity=c.MapCapacity(max_keyframes=64, max_points=8192,
                               local_window=4, local_points=1024))


JCFG, TCFG = _cfg(jcfg), _cfg(tcfg)


def _np(obj):
    return {f.name: np.array(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def scene():
    """A JAX map with one keyframe (frame 0), the JAX features of frame 6,
    its ground-truth pose, and matched ids for half the new frame's
    features drawn from the map's points."""
    seq = jsyn.SyntheticSequence(JCFG.camera, n_frames=30)
    feats = []
    for i in (0, 6):
        g, d = seq.frame(i)
        feats.append(jtr.extract_frame(JCFG, g, d))
    cap = feats[0].capacity
    m0 = jms.empty_map(JCFG.capacity, cap)
    m1 = jms.insert_keyframe(JCFG.camera, 1.2, m0, feats[0],
                             jse3.se3_identity(), 0,
                             jnp.full((cap,), -1, jnp.int32),
                             JCFG.close_depth_threshold)
    rng = np.random.default_rng(0)
    n_pt = int(m1.next_pt)
    matched = np.full(cap, -1, np.int32)
    slots = rng.choice(np.nonzero(np.asarray(feats[1].valid))[0],
                       size=n_pt // 2, replace=False)
    matched[slots] = rng.choice(n_pt, size=n_pt // 2, replace=False)
    Tcw = np.array(seq.gt_pose_cw(6))
    return m1, feats[1], Tcw, matched


def test_insert_keyframe(scene):
    m1, f6, Tcw, matched = scene
    ref = jms.insert_keyframe(JCFG.camera, 1.2, m1, f6, jnp.asarray(Tcw), 6,
                              jnp.asarray(matched),
                              JCFG.close_depth_threshold)
    out = tms.insert_keyframe(
        TCFG.camera, 1.2, convert.map_from_numpy(_np(m1)),
        convert.features_from_numpy(_np(f6)), torch.from_numpy(Tcw), 6,
        torch.from_numpy(matched), TCFG.close_depth_threshold)
    ref, out = _np(ref), convert.map_to_numpy(out)
    assert int(ref["next_pt"]) > int(np.asarray(m1.next_pt))   # new points
    for name, r in ref.items():
        o = out[name]
        assert o.shape == r.shape and o.dtype == r.dtype, name
        if name in ("pt_pos", "kf_pose"):
            np.testing.assert_allclose(o, r, atol=TOL_POS, rtol=0,
                                       err_msg=name)
        elif r.dtype.kind == "f":
            np.testing.assert_allclose(o, r, rtol=RTOL, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(o, r, err_msg=name)


@pytest.mark.parametrize("frame", [3, 12])
def test_select_local_points(scene, frame):
    m1, f6, Tcw6, matched = scene
    m2 = jms.insert_keyframe(JCFG.camera, 1.2, m1, f6, jnp.asarray(Tcw6), 6,
                             jnp.asarray(matched),
                             JCFG.close_depth_threshold)
    Tcw = jsyn.SyntheticSequence(JCFG.camera, n_frames=30).gt_pose_cw(frame)
    ref = jlm.select_local_points(JCFG.camera, m2, Tcw, scale_factor=1.2,
                                  capacity=1024)
    out = tlm.select_local_points(TCFG.camera, convert.map_from_numpy(_np(m2)),
                                  torch.from_numpy(np.array(Tcw)),
                                  scale_factor=1.2, capacity=1024)
    ref, out = _np(ref), convert.local_points_to_numpy(out)
    assert ref["valid"].sum() > 100
    for name in ("ids", "valid", "pred_level", "desc", "radius"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    np.testing.assert_allclose(out["pos"], ref["pos"], atol=TOL_POS, rtol=0)
    # predicted pixels: f32 at ~1e2 px
    np.testing.assert_allclose(out["proj_uv"], ref["proj_uv"], rtol=1e-5,
                               atol=1e-3)


# `_log_f32` (the port's copy of XLA's CPU logf) and XLA's own log differ
# by one ulp on ~0.03% of f32 inputs, so a ratio on a level boundary can
# land on the other level. Measured over the ratios below: one at scale
# factor 1.2 (2.48832, the f32 nearest 1.2**5: port 6, reference 5), none at
# 1.5. XLA's CPU code depends on the host's vector units, hence a bound
# rather than the list.
MAX_LEVEL_GAPS = 2


@pytest.mark.parametrize("scale_factor", [1.2, 1.5])
def test_pred_level_matches_reference(scale_factor):
    """The port's threshold lookup against its own log rule (equal) and the
    reference's (sgslam_tpu/mapstate/local_map.py:66-69; equal but for at
    most MAX_LEVEL_GAPS ratios): every f32 ratio within 2**16 ulps of each
    level boundary, and 2**18 log-uniform ratios."""
    import jax

    bounds = tlm._level_thresholds(scale_factor, torch.device("cpu"))
    near = (bounds.view(torch.int32)[:, None]
            + torch.arange(-2 ** 16, 2 ** 16, dtype=torch.int32)[None])
    rng = np.random.default_rng(0)
    far = np.exp(rng.uniform(np.log(1e-7), np.log(1e3), 2 ** 18))
    ratio = torch.cat([near.reshape(-1).view(torch.float32),
                       torch.from_numpy(far.astype(np.float32))])

    @jax.jit
    def ref_level(r):
        return jnp.clip(jnp.ceil(jnp.log(jnp.maximum(r, 1e-6))
                                 / np.log(scale_factor)).astype(jnp.int32),
                        0, 7)

    ref = np.asarray(ref_level(jnp.asarray(ratio.numpy())))
    out = tlm._pred_level(ratio, scale_factor).numpy()
    own = tlm._level_of_ratio(torch.clamp(ratio, min=1e-6),
                              scale_factor).numpy()
    assert set(np.unique(ref)) == set(range(8))
    np.testing.assert_array_equal(out, own)
    gaps = ratio.numpy()[out != ref]
    assert len(gaps) <= MAX_LEVEL_GAPS, gaps


def test_empty_map_layout():
    ref = _np(jms.empty_map(JCFG.capacity, 640))
    out = convert.map_to_numpy(tms.empty_map(TCFG.capacity, 640))
    for name, r in ref.items():
        assert out[name].dtype == r.dtype, name
        np.testing.assert_array_equal(out[name], r, err_msg=name)
