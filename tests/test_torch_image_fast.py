"""Pyramid, blur and FAST parity of the port against the JAX package.

The blur and the pyramid are f32 sums in another order than XLA's (and the
reference computes its resize weights inside jit, where XLA fuses their
arithmetic); the FAST score and NMS are subtractions, mins and maxes, so on
the same level image they must agree to f32 exactness.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.ops import fast as jfast
from sgslam_tpu.ops import image as jimage
from sgslam_tpu_torch.ops import fast as tfast
from sgslam_tpu_torch.ops import image as timage


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the test workers share
    the host's cores (with torch's default threads, test_torch_tracking.py
    took 524 s in the 6-worker suite; with one, 39 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# blur: 7+7 taps of weights summing to 1 on [0,1] values; XLA may fuse a
# multiply-add where torch rounds twice: a few ulps of 1.
TOL_BLUR = 1e-6
# pyramid: measured at most 2.6e-6 over 7 levels on random and rendered
# 640x480 and 320x240 images (per-level weights within a few f32 ulps of the
# reference's jitted ones, plus sum order); 1e-5 leaves a margin without
# reaching the 1.7e-5 gap that unfused weights would give at level 1.
TOL_PYRAMID = 1e-5
# FAST/NMS on the same level image: exact arithmetic (sub, min, max).
TOL_FAST = 1e-6

@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    rand = rng.random((480, 640)).astype(np.float32)
    from sgslam_tpu import config as jcfg

    cam = jcfg.synthetic_config(320, 240).camera
    poses = jsyn.make_trajectory(30)
    rendered = np.array(jsyn.render_frame(cam, poses[7])[0])
    return {"random": rand, "rendered": rendered}


@pytest.mark.parametrize("kind", ["random", "rendered"])
def test_blur(images, kind):
    img = images[kind]
    ref = np.asarray(jax.jit(jimage.gaussian_blur)(jnp.asarray(img)))
    out = timage.gaussian_blur(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL_BLUR, rtol=0)


@pytest.mark.parametrize("kind", ["random", "rendered"])
def test_pyramid_levels(images, kind):
    img = images[kind]
    ref = jax.jit(jimage.build_pyramid, static_argnums=(1, 2))(
        jnp.asarray(img), 8, 1.2)
    out = timage.build_pyramid(torch.from_numpy(img), 8, 1.2)
    assert len(out) == len(ref) == 8
    for lv, (o, r) in enumerate(zip(out, ref)):
        assert o.shape == r.shape, lv
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=TOL_PYRAMID,
                                   rtol=0, err_msg=f"level {lv}")


def test_pyramid_shapes_and_patches(images, rng):
    img = images["rendered"]
    assert timage.pyramid_shapes(240, 320, 8, 1.2) == jimage.pyramid_shapes(
        240, 320, 8, 1.2)
    centers = rng.integers(-5, 330, size=(64, 2)).astype(np.int32)
    ref = np.asarray(jimage.gather_patches(jnp.asarray(img),
                                           jnp.asarray(centers), 15))
    out = timage.gather_patches(torch.from_numpy(img),
                                torch.from_numpy(centers).long(), 15).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("level", [0, 1, 3])
def test_fast_and_nms_on_same_level_image(images, level):
    img = images["rendered"]
    lv_img = np.array(jax.jit(jimage.build_pyramid, static_argnums=(1, 2))(
        jnp.asarray(img), 8, 1.2)[level])
    thr = 7.0 / 255.0
    ref_s = np.array(jax.jit(jfast.fast_score_map, static_argnums=1)(
        jnp.asarray(lv_img), thr))
    out_s = tfast.fast_score_map(torch.from_numpy(lv_img), thr).numpy()
    np.testing.assert_allclose(out_s, ref_s, atol=TOL_FAST, rtol=0)
    np.testing.assert_array_equal(out_s > 0, ref_s > 0)
    ref_n = np.asarray(jax.jit(jfast.nms_3x3)(jnp.asarray(ref_s)))
    out_n = tfast.nms_3x3(torch.from_numpy(ref_s)).numpy()
    np.testing.assert_allclose(out_n, ref_n, atol=TOL_FAST, rtol=0)
    np.testing.assert_array_equal(out_n > 0, ref_n > 0)
    assert (ref_n > 0).sum() > 50   # the level really has corners
    h, w = lv_img.shape
    np.testing.assert_array_equal(
        tfast.border_mask(h, w, 19).numpy(),
        np.asarray(jfast.border_mask(h, w, 19)))


@pytest.mark.parametrize("kind", ["random", "rendered"])
def test_max_pool_3x3(images, kind):
    """The 3x3 max filter: maxima of the same values, so exact; the border
    is padded with -inf as the reference's reduce_window pads it."""
    img = images[kind]
    np.testing.assert_array_equal(
        timage.max_pool_3x3(torch.from_numpy(img)).numpy(),
        np.asarray(jimage.max_pool_3x3(jnp.asarray(img))))
