"""Foundations parity: config presets, SE(3) and the camera model of the
port against the JAX package on the same random inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.geometry import camera as jcam
from sgslam_tpu.geometry import se3 as jse3
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch.geometry import camera as tcam
from sgslam_tpu_torch.geometry import se3 as tse3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the test workers share
    the host's cores (with torch's default threads, test_torch_tracking.py
    took 524 s in the 6-worker suite; with one, 39 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# f32 functions of unit-scale values: a few ulps of 1 plus the reordering
# of sums between XLA and torch.
TOL = 1e-5
# log near theta = pi: the rotation axis is v/|v| with |v| -> 0 in the
# quaternion's w-small regime; f32 rounding of the two formulations is
# ~1e-3 there (the f32 Lie-group rounding floor).
TOL_NEAR_PI = 1e-3


def _as_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _as_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj


@pytest.mark.parametrize("name", ["synthetic_config", "tum1_config",
                                  "tum2_config", "tum3_config", "bonn_config",
                                  "openloris_config", "astra_pro_config"])
def test_presets_equal_field_for_field(name):
    a = getattr(jcfg, name)()
    b = getattr(tcfg, name)()
    assert _as_dict(a) == _as_dict(b)
    assert a.close_depth_threshold == b.close_depth_threshold
    # dataclass layouts themselves match (same field names, same order)
    for ca, cb in [(type(a), type(b)), (type(a.orb), type(b.orb)),
                   (type(a.camera), type(b.camera))]:
        assert ([f.name for f in dataclasses.fields(ca)]
                == [f.name for f in dataclasses.fields(cb)])


def _rand_pose(rng, n, ang=1.0):
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi[:, 3:] *= ang / np.sqrt(3)
    return xi


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=0)


def test_se3_exp_log_compose_inverse_apply(rng):
    xi = _rand_pose(rng, 256)
    xi[:8, 3:] *= 1e-4          # exercise the Taylor branches
    x = rng.normal(size=(256, 3)).astype(np.float32)
    Tj = jax.vmap(jse3.se3_exp)(jnp.asarray(xi))
    Tt = tse3.se3_exp(torch.from_numpy(xi))
    _close(Tt, Tj)
    _close(tse3.se3_log(Tt), jax.vmap(jse3.se3_log)(Tj))
    Tt2 = torch.roll(Tt, 1, 0)
    Tj2 = jnp.roll(Tj, 1, 0)
    _close(tse3.se3_compose(Tt, Tt2), jse3.se3_compose(Tj, Tj2))
    _close(tse3.se3_inverse(Tt), jse3.se3_inverse(Tj))
    _close(tse3.se3_apply(Tt, torch.from_numpy(x)),
           jse3.se3_apply(Tj, jnp.asarray(x)))
    _close(tse3.se3_to_matrix(Tt), jse3.se3_to_matrix(Tj))
    _close(tse3.se3_from_matrix(tse3.se3_to_matrix(Tt)),
           jse3.se3_from_matrix(jse3.se3_to_matrix(Tj)))


def test_so3_near_pi(rng):
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w = w / np.linalg.norm(w, axis=1, keepdims=True) * (np.pi - 1e-3)
    qj = jse3.so3_exp_quat(jnp.asarray(w))
    qt = tse3.so3_exp_quat(torch.from_numpy(w))
    _close(qt, qj)
    _close(tse3.so3_log(qt), jse3.so3_log(qj), TOL_NEAR_PI)


def test_quaternion_helpers(rng):
    q = rng.normal(size=(128, 4)).astype(np.float32)
    q2 = rng.normal(size=(128, 4)).astype(np.float32)
    qt, qj = torch.from_numpy(q), jnp.asarray(q)
    _close(tse3.quat_normalize(qt), jse3.quat_normalize(qj))
    _close(tse3.quat_mul(qt, torch.from_numpy(q2)),
           jse3.quat_mul(qj, jnp.asarray(q2)))
    un_t, un_j = tse3.quat_normalize(qt), jse3.quat_normalize(qj)
    _close(tse3.quat_to_mat(un_t), jse3.quat_to_mat(un_j))
    _close(tse3.mat_to_quat(tse3.quat_to_mat(un_t)),
           jse3.mat_to_quat(jse3.quat_to_mat(un_j)))


def test_camera_functions(rng):
    cam_args = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, k1=0.262383,
                    k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314)
    cj, ct = jcam.Camera(**cam_args), tcam.Camera(**cam_args)
    pc = rng.uniform([-1, -1, 0.5], [1, 1, 4], size=(500, 3)).astype(
        np.float32)
    uv = rng.uniform([0, 0], [640, 480], size=(500, 2)).astype(np.float32)
    z = rng.uniform(0.5, 4, size=500).astype(np.float32)
    pt, pj = torch.from_numpy(pc), jnp.asarray(pc)
    # pixel outputs are ~1e2-1e3: compare with f32 relative rounding
    np.testing.assert_allclose(tcam.project(ct, pt).numpy(),
                               np.asarray(jcam.project(cj, pj)), rtol=1e-6)
    np.testing.assert_allclose(tcam.project_stereo(ct, pt).numpy(),
                               np.asarray(jcam.project_stereo(cj, pj)),
                               rtol=1e-6, atol=1e-4)
    _close(tcam.backproject(ct, torch.from_numpy(uv), torch.from_numpy(z)),
           jcam.backproject(cj, jnp.asarray(uv), jnp.asarray(z)))
    # 8 fixed-point iterations on pixel coordinates: f32 at ~1e2 px
    np.testing.assert_allclose(
        tcam.undistort_points(ct, torch.from_numpy(uv)).numpy(),
        np.asarray(jcam.undistort_points(cj, jnp.asarray(uv))), atol=1e-3)
    np.testing.assert_array_equal(
        tcam.in_image(ct, torch.from_numpy(uv), 19.0).numpy(),
        np.asarray(jcam.in_image(cj, jnp.asarray(uv), 19.0)))


def test_distort_normalized(rng):
    """`distort_normalized` on normalized coordinates within the TUM1
    camera's field of view: the same polynomial, f32 rounding of ~1."""
    cam_args = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, k1=0.262383,
                    k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314)
    xy = rng.uniform([-0.6, -0.5], [0.6, 0.5], size=(500, 2)).astype(
        np.float32)
    _close(tcam.distort_normalized(tcam.Camera(**cam_args),
                                   torch.from_numpy(xy)),
           jcam.distort_normalized(jcam.Camera(**cam_args), jnp.asarray(xy)))
    # no distortion: the identity
    _close(tcam.distort_normalized(tcam.Camera(fx=1, fy=1, cx=0, cy=0),
                                   torch.from_numpy(xy)), xy)
