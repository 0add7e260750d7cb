"""The port's bilinear sampling and pyramidal LK flow (the
`dynamic.use_lk_flow=True` correspondence source) against the JAX
package's, on frames of the dynamic synthetic sequence.

The flow's pyramid goes through the port's antialiased resize, which is
within a few f32 ulps of `jax.image.resize` (test_torch_image_fast.py), and
ten Gauss-Newton steps per level amplify that a little.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.ops import flow as jflow
from sgslam_tpu.ops import image as jimg
from sgslam_tpu.slam import tracking as jtr
from sgslam_tpu_torch.ops import flow as tflow
from sgslam_tpu_torch.ops import image as timg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = jcfg.synthetic_config(320, 240, orb=jcfg.OrbConfig(n_features=600,
                                                         max_keypoints=640))
TOL_SAMPLE = 1e-6      # [0,1] images, f32 (measured 1.2e-7)
# px, tracked points: 99th percentile (measured 3.1e-5) and maximum
# (measured 4.5e-3, one point of 422 whose Gauss-Newton steps amplify the
# pyramid's ulps)
TOL_FLOW_P99, TOL_FLOW_MAX = 1e-4, 0.01
MAX_STATUS_FLIPS = 2   # of 640 points (measured 0)


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def frames():
    seq = jsyn.SyntheticSequence(CFG.camera, n_frames=30, dynamic=True)
    g0, d0 = seq.frame(10)
    g1, _ = seq.frame(11)
    feats = jtr.extract_frame(CFG, g0, d0)
    return np.array(g0), np.array(g1), feats


def test_bilinear_sample(frames):
    g0 = frames[0]
    rng = np.random.default_rng(0)
    xy = rng.uniform([-5, -5], [330, 250], (2000, 2)).astype(np.float32)
    xy[:10] = np.floor(xy[:10])                     # integer positions
    sj = np.asarray(jimg.bilinear_sample(jnp.asarray(g0), jnp.asarray(xy)))
    st = timg.bilinear_sample(T(g0), T(xy)).numpy()
    np.testing.assert_allclose(st, sj, atol=TOL_SAMPLE, rtol=0)
    # batched coordinates keep their shape
    assert timg.bilinear_sample(T(g0), T(xy).reshape(40, 50, 2)).shape == \
        (40, 50)


def test_lk_flow(frames):
    g0, g1, feats = frames
    xy, valid = np.array(feats.xy_raw), np.array(feats.valid)
    pj, sj = (np.asarray(x) for x in jflow.lk_flow(
        jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(xy),
        jnp.asarray(valid)))
    pt, st = (x.numpy() for x in tflow.lk_flow(T(g0), T(g1), T(xy),
                                               T(valid)))
    assert st.dtype == bool and pt.shape == pj.shape
    assert int((st != sj).sum()) <= MAX_STATUS_FLIPS
    both = st & sj
    assert both.sum() > 0.5 * valid.sum()
    d = np.abs(pt[both] - pj[both]).max(1)
    assert np.percentile(d, 99) < TOL_FLOW_P99 and d.max() < TOL_FLOW_MAX, (
        np.percentile(d, 99), d.max())
