"""ORB parity: the port's `extract_frame` (extract + attach_rgbd) against the
JAX package's on JAX-rendered frames.

Level 0 is bit-exact. Pyramid levels 1-7 differ from the reference's by up
to 2.6e-6 (test_torch_image_fast.py), and the synthetic scene's flat
textures give many cells whose FAST scores are mathematically tied: rounding
then reorders those keypoints within a level and, rarely, swaps one for
another. So the test compares keypoints as sets of (level, x, y) and
bounds, and reports, the share that differs; descriptors and angles are
compared on the common keypoints.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.slam import tracking as jtr
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch import convert
from sgslam_tpu_torch.slam import tracking as ttr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the test workers share
    the host's cores (with torch's default threads, test_torch_tracking.py
    took 524 s in the 6-worker suite; with one, 39 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Measured over 13 frames at 320x240 and 640x480: 0.58% of keypoints differ
# as a set, at most 0.9% in one frame; 5e-6 of descriptor bits differ on
# common keypoints; angles within 1.4e-5 rad. The bounds leave a margin.
MAX_KEYPOINT_SHARE = 0.01
MAX_BIT_SHARE = 5e-4
TOL_ANGLE = 1e-4       # rad: atan2 of 961-term f32 sums in another order
TOL_XY = 0.0           # positions are integer pixels times level scale


def _cfg(c):
    return c.synthetic_config(
        width=320, height=240,
        orb=c.OrbConfig(n_features=600, max_keypoints=640),
        capacity=c.MapCapacity(max_keyframes=64, max_points=8192,
                               local_window=4, local_points=1024))


JCFG, TCFG = _cfg(jcfg), _cfg(tcfg)


@pytest.fixture(scope="module")
def pairs():
    poses = jsyn.make_trajectory(30)
    out = []
    for i in (0, 9, 18, 27):
        gray, depth = (np.array(x) for x in jsyn.render_frame(JCFG.camera,
                                                               poses[i]))
        fj = jtr.extract_frame(JCFG, jnp.asarray(gray), jnp.asarray(depth))
        fj = {f.name: np.asarray(getattr(fj, f.name))
              for f in dataclasses.fields(fj)}
        ft = convert.features_to_numpy(
            ttr.extract_frame(TCFG, gray, depth, device="cpu"))
        out.append((fj, ft))
    return out


def _keyed(f):
    rows = np.nonzero(f["valid"])[0]
    return {(int(f["level"][i]), float(f["xy"][i, 0]),
             float(f["xy"][i, 1])): i for i in rows}


def test_shapes_and_level_counts(pairs):
    for fj, ft in pairs:
        for k in fj:
            assert ft[k].shape == fj[k].shape, k
            assert ft[k].dtype == fj[k].dtype, k
        for lv in range(TCFG.orb.n_levels):
            assert ((ft["level"] == lv) & ft["valid"]).sum() == (
                (fj["level"] == lv) & fj["valid"]).sum(), lv
        # level 0 is computed from the input image itself: exact
        l0 = np.nonzero(fj["level"] == 0)[0]
        np.testing.assert_array_equal(ft["xy"][l0], fj["xy"][l0])
        np.testing.assert_array_equal(ft["valid"][l0], fj["valid"][l0])


def test_keypoint_sets_descriptors_depth(pairs):
    n_kp = n_diff = n_bits = n_bit_diff = 0
    for fj, ft in pairs:
        kj, kt = _keyed(fj), _keyed(ft)
        n_kp += len(kj)
        n_diff += len(kj.keys() - kt.keys())
        common = sorted(kj.keys() & kt.keys())
        ij = np.array([kj[k] for k in common])
        it = np.array([kt[k] for k in common])
        x = fj["desc"][ij] ^ ft["desc"][it]
        n_bit_diff += int(np.unpackbits(x.view(np.uint8)).sum())
        n_bits += 256 * len(common)
        np.testing.assert_allclose(ft["angle"][it], fj["angle"][ij],
                                   atol=TOL_ANGLE, rtol=0)
        np.testing.assert_allclose(ft["xy_raw"][it], fj["xy_raw"][ij],
                                   atol=TOL_XY, rtol=0)
        # depth lookup and pseudo-stereo coordinate on the same pixel
        np.testing.assert_array_equal(ft["depth"][it], fj["depth"][ij])
        np.testing.assert_allclose(ft["u_right"][it], fj["u_right"][ij],
                                   rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(ft["response"][it] > 0,
                                      fj["response"][ij] > 0)
    kp_share, bit_share = n_diff / n_kp, n_bit_diff / n_bits
    print(f"ORB parity: {n_diff}/{n_kp} keypoints differ "
          f"({100 * kp_share:.2f}%), {n_bit_diff}/{n_bits} descriptor bits "
          f"differ on common keypoints ({100 * bit_share:.4f}%)")
    assert kp_share < MAX_KEYPOINT_SHARE
    assert bit_share < MAX_BIT_SHARE


def test_descriptors_bit_identical_on_same_patches(rng):
    """Given the same blurred patches and angles, rBRIEF is bit-exact."""
    from sgslam_tpu.ops import orb as jorb
    from sgslam_tpu_torch.ops import orb as torb

    patches = rng.random((300, 39, 39)).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    ref = np.asarray(jorb._descriptors(jnp.asarray(patches),
                                       jnp.asarray(angles)))
    out = torb._descriptors(torch.from_numpy(patches),
                            torch.from_numpy(angles)).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), ref)
    assert torb.level_budgets(TCFG.orb) == jorb.level_budgets(JCFG.orb)


def test_scale_factors():
    """The per-level scale factors of the default and a custom pyramid:
    the same float64 powers."""
    from sgslam_tpu.ops import orb as jorb
    from sgslam_tpu_torch.ops import orb as torb

    for kw in ({}, {"scale_factor": 1.3, "n_levels": 5}):
        assert torb.scale_factors(tcfg.OrbConfig(**kw)) == \
            jorb.scale_factors(jcfg.OrbConfig(**kw))
