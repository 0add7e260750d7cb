"""The port's SSDLite detector against the JAX package's, with the shipped
weights (`sgslam_tpu/assets/detector.npz`): anchors, box decoding, NMS
(zero-score ties included), the network's outputs and the detections.

The convolutions and GroupNorms sum in other orders than XLA's, so the
logits agree to f32 rounding, not bit for bit (measured 1.7e-5 on logits
up to 27); the discrete outputs (valid flags, classes, the NMS picks) are
identical on these frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.models import detector as jdet
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch import convert
from sgslam_tpu_torch.models import detector as tdet


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JCFG = jcfg.synthetic_config(320, 240)
TCFG = tcfg.synthetic_config(320, 240)
TOL_LOGIT = 2e-4      # absolute, logits up to ~30 (measured 1.7e-5)
TOL_BOX = 2e-5        # normalized box coordinates (measured 3e-7)
TOL_SCORE = 2e-5      # softmax scores (measured 2e-7)


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def detectors():
    return (jdet.Detector2D(JCFG.detector),
            tdet.Detector2D(TCFG.detector, device="cpu"))


@pytest.fixture(scope="module")
def images():
    """rgb frames: people + props at 320x240, and the walkers at 640x480."""
    seq = jsyn.SyntheticSequence(JCFG.camera, n_frames=30, dynamic=True,
                                 props=True)
    out = [np.repeat(np.array(seq.frame(i)[0])[..., None], 3, -1)
           for i in (3, 16)]
    cam = jcfg.synthetic_config(640, 480).camera
    walk = jsyn.SyntheticSequence(
        cam, n_frames=30, poses=jsyn.make_walk_trajectory(30, yaw_amp=0.35),
        people=jsyn.walker_tracks(30, 3, depth0=1.6, half_h=0.62))
    out.append(np.repeat(np.array(walk.frame(9)[0])[..., None], 3, -1))
    return out


def test_anchors_and_padding():
    np.testing.assert_array_equal(tdet.make_anchors(300), jdet.make_anchors(300))
    assert tdet.make_anchors(300).shape == (2766, 4)
    # flax SAME: stride-2 3x3 pads (0, 1) on even sizes, (1, 1) on odd ones
    assert [tdet.same_padding(n, 3, 2) for n in (300, 150, 75, 38, 19)] == \
        [(0, 1), (0, 1), (1, 1), (0, 1), (1, 1)]
    assert tdet.same_padding(19, 3, 1) == (1, 1)
    assert tdet.same_padding(10, 1, 1) == (0, 0)


def test_weights_load(detectors):
    jd, td = detectors
    sd = td.model.state_dict()
    assert sum(v.numel() for v in sd.values() if v.dtype.is_floating_point) \
        == 1778508
    assert all(m.eps == 1e-6 for m in td.model.modules()
               if isinstance(m, torch.nn.GroupNorm))
    from flax import traverse_util

    flat = traverse_util.flatten_dict(jd.params)     # tuple keys
    sd2 = convert.detector_params_from_numpy(
        {k: np.asarray(v) for k, v in flat.items()})
    assert sd2.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd2[k].numpy(), sd[k].numpy())
    # a depthwise kernel: (3, 3, 1, C) -> (C, 1, 3, 3)
    assert sd["blocks.0.conv1.weight"].shape == (128, 1, 3, 3)


def test_decode_and_iou():
    rng = np.random.default_rng(0)
    anchors = jdet.make_anchors(300)
    pred = rng.normal(0, 3, anchors.shape).astype(np.float32)
    bj = np.asarray(jdet.decode_boxes(jnp.asarray(pred), jnp.asarray(anchors)))
    bt = tdet.decode_boxes(T(pred), T(anchors)).numpy()
    np.testing.assert_allclose(bt, bj, atol=1e-6, rtol=1e-6)
    a, b = bj[:50], bj[100:170]
    np.testing.assert_allclose(tdet._iou(T(a), T(b)).numpy(),
                               np.asarray(jdet._iou(jnp.asarray(a),
                                                    jnp.asarray(b))),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_topk_exact(seed):
    """Identical picks, with most scores tied at exactly 0 (the empty slots
    take the first of the pool, as `lax.top_k` orders it)."""
    rng = np.random.default_rng(seed)
    n = 2766
    anchors = jdet.make_anchors(300)
    boxes = np.asarray(jdet.decode_boxes(
        jnp.asarray(rng.normal(0, 1, (n, 4)).astype(np.float32)),
        jnp.asarray(anchors)))
    scores = rng.random(n).astype(np.float32)
    scores[rng.random(n) < (0.995 if seed < 2 else 1.0)] = 0.0
    scores[:5] = 0.7 if seed == 1 else scores[:5]           # exact ties
    cls = rng.integers(1, 21, n).astype(np.int32)
    ij, oj = (np.asarray(x) for x in jax.jit(
        lambda b, s, c: jdet.nms_topk(b, s, c, 32))(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls)))
    it, ot = tdet.nms_topk(T(boxes), T(scores), T(cls), 32)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_array_equal(ot.numpy(), oj)


def test_network_outputs(detectors, images):
    jd, td = detectors
    for rgb in images:
        img = jax.image.resize(jnp.asarray(rgb), (300, 300, 3), "linear")
        bj, lj = (np.asarray(x[0]) for x in jd.model.apply(jd.params,
                                                           img[None]))
        bt, lt = (x.numpy() for x in td.raw(T(rgb)))
        assert lt.shape == (2766, 21) and bt.shape == (2766, 4)
        np.testing.assert_allclose(lt, lj, atol=TOL_LOGIT, rtol=0)
        np.testing.assert_allclose(bt, bj, atol=TOL_LOGIT, rtol=0)


def test_detections(detectors, images):
    jd, td = detectors
    n_person = 0
    for rgb in images:
        h, w = rgb.shape[:2]
        oj = [np.asarray(x) for x in jdet._detect_jit(
            jd.model, jd.anchors, JCFG.detector, jd.params, jnp.asarray(rgb))]
        ot = [x.numpy() for x in td.detect_normalized(T(rgb))]
        np.testing.assert_array_equal(ot[3], oj[3])            # valid
        ok = oj[3]
        np.testing.assert_array_equal(ot[1][ok], oj[1][ok])    # classes
        np.testing.assert_allclose(ot[0][ok], oj[0][ok], atol=TOL_BOX, rtol=0)
        np.testing.assert_allclose(ot[2][ok], oj[2][ok], atol=TOL_SCORE,
                                   rtol=0)
        for bj, bt in zip(jd.detect(jnp.asarray(rgb), w, h),
                          td.detect(T(rgb), w, h)):
            np.testing.assert_array_equal(bt.valid.numpy(),
                                          np.asarray(bj.valid))
        n_person += int(td.detect(T(rgb), w, h)[1].valid.any())
    assert n_person >= 2


def test_random_init_is_seeded():
    a = tdet.Detector2D(TCFG.detector, pretrained=False, seed=3,
                        device="cpu").model.state_dict()
    b = tdet.Detector2D(TCFG.detector, pretrained=False, seed=3,
                        device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
