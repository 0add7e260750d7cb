"""`sgslam_tpu_torch/models/detector_train.py` and the port's trainer against
`sgslam_tpu/models/detector_train.py` and `tools/train_detector.py`.

Tolerances, and why:
- `match_anchors`: class targets and positives identical, also where two
  boxes share a best anchor (the reference's last write wins; the port
  takes the highest box index); box targets within 1e-6 (XLA's CPU `log` is
  not correctly rounded, an ulp at values ~1);
- `multibox_loss` on the same logits: within 1e-6 relative (float32 sums of
  ~2000 terms in another order); the mined negatives are the same set;
- `batched_loss` through the converted flax parameters: within 1e-5
  relative (the convolutions of XLA and of torch's CPU backend accumulate
  in different orders: logits differ by ~1e-6 relative);
- gradients: within 5e-3 of each tensor's largest entry (the same sums
  in other orders, propagated back through 20 convolutions and GroupNorms,
  whose backward cancels: measured at most 2.2e-3, at the stem);
- AdamW: given the same gradients, the port's update lands within 2.5e-7
  of optax's, two float32 ulps of the GroupNorm scales at 1 (its first step is about lr * sign(g), so gradients at float32
  noise could flip an element by 2 lr: that is why the update is compared
  on the reference's gradients, not on the port's own);
- the sampler, fed the reference's own draws (8 keys per scene, 5 for the
  props, 5 for the augmentation): labels and visibility identical, boxes
  within 1e-5, and the images within 1e-3 on all but 1% of pixels (the
  renderer's texture hash amplifies an ulp of a ray into another texture
  cell at a few pixels; tests/test_torch_synthetic.py's yardstick).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.models import detector as jdet
from sgslam_tpu.models import detector_train as jdt
from sgslam_tpu_torch import convert
from sgslam_tpu_torch import train_detector
from sgslam_tpu_torch.config import DetectorConfig
from sgslam_tpu_torch.io import synthetic as tsyn
from sgslam_tpu_torch.models import detector as tdet
from sgslam_tpu_torch.models import detector_train as dt

LR, STEPS = 3e-4, 2500


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def anchors():
    a = tdet.make_anchors(300)
    return a, torch.from_numpy(a), jnp.asarray(a)


def _gt(seed, B=2, G=7):
    """Random GT boxes [B,G,4] (normalized xyxy), labels, validity; box 1
    repeats box 0 with another label, so that both share a best anchor."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.15, 0.85, size=(B, G, 2))
    wh = rng.uniform(0.03, 0.5, size=(B, G, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]
    labels = rng.integers(1, 21, size=(B, G)).astype(np.int32)
    labels[:, 1] = labels[:, 0] % 20 + 1
    valid = rng.random((B, G)) < 0.8
    valid[:, :2] = True
    return boxes, labels, valid


def test_encode_and_match_anchors(anchors):
    a_np, a_t, a_j = anchors
    boxes, labels, valid = _gt(0, B=4)
    for b in range(4):
        ct, bt, pos = dt.match_anchors(a_t, torch.from_numpy(boxes[b]),
                                       torch.from_numpy(labels[b]),
                                       torch.from_numpy(valid[b]))
        rc, rb, rp = jdt.match_anchors(a_j, jnp.asarray(boxes[b]),
                                       jnp.asarray(labels[b]),
                                       jnp.asarray(valid[b]))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(rp))
        np.testing.assert_allclose(bt.numpy(), np.asarray(rb), atol=1e-6)
    # two small equal boxes (no anchor reaches IoU 0.5, so their shared
    # best anchor is forced): the anchor takes the higher box index's label
    small = np.array([[0.40, 0.40, 0.43, 0.46]] * 2 + [[0.1, 0.1, 0.5, 0.5]],
                     np.float32)
    lab = np.array([3, 9, 15], np.int32)
    ok = np.ones(3, bool)
    ct, _, pos = dt.match_anchors(a_t, torch.from_numpy(small),
                                  torch.from_numpy(lab), torch.from_numpy(ok))
    rc, _, rp = jdt.match_anchors(a_j, jnp.asarray(small), jnp.asarray(lab),
                                  jnp.asarray(ok))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rp))
    assert (ct == 9).sum() == 1 and (ct == 3).sum() == 0
    np.testing.assert_allclose(
        dt.encode_boxes(torch.from_numpy(boxes[0, :1]).expand(len(a_np), 4),
                        a_t).numpy(),
        np.asarray(jdt.encode_boxes(jnp.broadcast_to(boxes[0, :1],
                                                     (len(a_np), 4)), a_j)),
        atol=1e-6)


def test_multibox_loss(anchors):
    _, a_t, a_j = anchors
    boxes, labels, valid = _gt(1, B=1)
    rng = np.random.default_rng(2)
    A = a_t.shape[0]
    bp = rng.normal(size=(A, 4)).astype(np.float32)
    lg = (2 * rng.normal(size=(A, 21))).astype(np.float32)
    t = dt.match_anchors(a_t, *(torch.from_numpy(x[0])
                                for x in (boxes, labels, valid)))
    r = jdt.match_anchors(a_j, *(jnp.asarray(x[0])
                                 for x in (boxes, labels, valid)))
    loss, (cls_l, loc_l, npos) = dt.multibox_loss(
        torch.from_numpy(bp), torch.from_numpy(lg), t[0], t[1], t[2])
    rl, (rcls, rloc, rn) = jdt.multibox_loss(jnp.asarray(bp), jnp.asarray(lg),
                                             *r)
    assert int(npos) == int(rn)
    for x, y in ((loss, rl), (cls_l, rcls), (loc_l, rloc)):
        assert float(x) == pytest.approx(float(y), rel=1e-6)


def _flax_setup(batch):
    model = jdet.SSDLite(num_classes=21)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((batch, 300, 300, 3)))
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    return model, params, convert.detector_params_from_numpy(flat)


def _grads_to_port(tree):
    return convert.detector_params_from_numpy(
        {k: np.asarray(v) for k, v in
         traverse_util.flatten_dict(tree, sep="/").items()})


@pytest.fixture(scope="module")
def one_step(anchors):
    """The same initialization and batch through both packages: loss,
    gradients, and one optimizer update."""
    _, a_t, a_j = anchors
    B = 2
    model_j, params_j, state = _flax_setup(B)
    rng = np.random.default_rng(3)
    rgb = rng.random((B, 300, 300, 3)).astype(np.float32)
    boxes, labels, valid = _gt(4, B=B)
    (loss_j, npos_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jdt.batched_loss(model_j, a_j, p, jnp.asarray(rgb),
                                   jnp.asarray(boxes), jnp.asarray(labels),
                                   jnp.asarray(valid)), has_aux=True))(
        params_j)
    tx = optax.adamw(optax.cosine_decay_schedule(LR, STEPS, alpha=0.05),
                     weight_decay=1e-5)

    @jax.jit
    def update(g, p):
        u, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, u)

    new_j = update(grads_j, params_j)

    model = tdet.SSDLite(num_classes=21)
    model.load_state_dict(state)
    loss, npos = dt.batched_loss(model, a_t, None, torch.from_numpy(rgb),
                                 torch.from_numpy(boxes),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(valid))
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return dict(model=model, loss=(float(loss.detach()), float(loss_j)),
                npos=(float(npos), float(npos_j)), grads=grads,
                grads_ref=_grads_to_port(grads_j["params"]
                                         if "params" in grads_j
                                         else grads_j),
                new_ref=_grads_to_port(new_j), state=state)


def test_batched_loss(one_step):
    loss, loss_j = one_step["loss"]
    assert loss == pytest.approx(loss_j, rel=1e-5)
    assert one_step["npos"][0] == one_step["npos"][1]


def test_gradients(one_step):
    ref = one_step["grads_ref"]
    assert set(ref) == set(one_step["grads"])
    for k, g in one_step["grads"].items():
        scale = float(ref[k].abs().max())
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(),
                                   atol=5e-3 * scale + 1e-12, err_msg=k)


def test_adamw_update_given_the_same_gradients(one_step):
    model = tdet.SSDLite(num_classes=21)
    model.load_state_dict(one_step["state"])
    opt, sched = dt.make_optimizer(model, LR, STEPS)
    for k, p in model.named_parameters():
        p.grad = one_step["grads_ref"][k].clone()
    opt.step()
    sched.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(
        LR * dt.cosine_factor(1, STEPS), rel=1e-12)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   one_step["new_ref"][k].numpy(),
                                   atol=2.5e-7, rtol=0, err_msg=k)


def test_init_params_are_flax_defaults():
    _, _, state_ref = _flax_setup(1)
    model = tdet.SSDLite(num_classes=21)
    state = dt.init_params(model, seed=0)
    assert {k: v.shape for k, v in state.items()} == \
        {k: v.shape for k, v in state_ref.items()}
    for k, v in state.items():
        if k.endswith("weight") and v.dim() == 4:
            fan_in = v[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            assert float(v.abs().max()) <= 2 * std + 1e-7, k
            if v.numel() > 5000:
                # the truncated normal's own std is .8796 of the scale
                assert float(v.std()) == pytest.approx(
                    float(state_ref[k].std()), rel=0.1), k
        else:
            assert torch.equal(v, state_ref[k]), k


def test_save_load_round_trip(tmp_path):
    _, params_j, state = _flax_setup(1)
    path = str(tmp_path / "port.npz")
    dt.save_params(path, state)
    back = dt.load_params(path)
    ref = jdt.load_params(path)
    flat_ref = {k: np.asarray(v) for k, v in
                traverse_util.flatten_dict(ref, sep="/").items()}
    assert flat_ref.keys() == convert.detector_params_to_numpy(back).keys()
    for k, v in convert.detector_params_to_numpy(back).items():
        np.testing.assert_array_equal(v, flat_ref[k], err_msg=k)
        np.testing.assert_array_equal(
            v, convert.detector_params_to_numpy(state)[k].astype(
                np.float16).astype(np.float32), err_msg=k)
    # the reference's file reads the same way
    path_j = str(tmp_path / "ref.npz")
    jdt.save_params(path_j, params_j)
    for k, v in dt.load_params(path_j).items():
        assert torch.equal(v, back[k]), k
    det = tdet.Detector2D(DetectorConfig(), params=back, device="cpu")
    out = det.detect(torch.rand(240, 320, 3), 320, 240)
    assert out[0].xyxy.shape == (DetectorConfig().max_boxes, 4)


def _jax_draws(key, cam):
    """The reference's draws for one scene, in its own split structure."""
    ks = jax.random.split(key, 8)
    kp = jax.random.split(ks[6], 5)
    ka = jax.random.split(ks[7], 5)
    u = jax.random.uniform
    d = dict(pose=u(ks[0], (6,)), people_z=u(ks[2], (3,)),
             people_cx=u(ks[3], (3,)), people_cy=u(ks[4], (3,)),
             people_r=u(ks[5], (3, 3)),
             prop_cls=jax.random.randint(kp[0], (4,), 0,
                                         len(jsyn.PROP_CLASSES)),
             prop_z=u(kp[1], (4,)), prop_cx=u(kp[2], (4,)),
             prop_cy=u(kp[3], (4,)), prop_r=u(kp[4], (4, 4)),
             contrast=u(ka[0], ()), bright=u(ka[1], ()),
             sigma=u(ka[2], ()), blur_w=u(ka[3], ()),
             noise=jax.random.normal(ka[4], (cam.height, cam.width)))
    return dt.SceneDraws(**{k: torch.from_numpy(np.array(v)).to(
        torch.int64 if k == "prop_cls" else torch.float32)[None]
        for k, v in d.items()})


@pytest.mark.parametrize("cam43", [False, True])
def test_sampler_with_the_reference_draws(cam43):
    jcam = jdt.TRAIN_CAM_43 if cam43 else jdt.TRAIN_CAM
    tcam = dt.TRAIN_CAM_43 if cam43 else dt.TRAIN_CAM
    key = jax.random.PRNGKey(11 + cam43)
    g_j, b_j, l_j, v_j = jax.jit(jdt._sample_scene, static_argnums=(1, 2))(
        key, jsyn.ROOM, jcam)
    rgb, boxes, labels, vis = dt.sample_batch(_jax_draws(key, jcam), 1,
                                              tsyn.ROOM, tcam)
    assert rgb.shape == (1, 300, 300, 3)
    np.testing.assert_array_equal(labels[0].numpy(), np.asarray(l_j))
    np.testing.assert_array_equal(vis[0].numpy(), np.asarray(v_j))
    assert bool(vis[0].any())
    np.testing.assert_allclose(boxes[0].numpy(), np.asarray(b_j), atol=1e-5)
    diff = np.abs(rgb[0, ..., 0].numpy() - np.asarray(g_j))
    assert np.mean(diff > 1e-3) < 0.01, np.mean(diff > 1e-3)


def test_trainer_cli_smoke(tmp_path):
    """Two steps at batch 2 on the CPU, then the held-out report over two
    scenes: files under the given paths, a finite loss; the packaged asset
    is refused as an output."""
    out, rep = str(tmp_path / "det.npz"), str(tmp_path / "rep.json")
    assert train_detector.main(["--steps", "2", "--batch", "2", "--device",
                                "cpu", "--eval-scenes", "2", "--out", out,
                                "--report", rep]) == 0
    assert set(dt.load_params(out)) == set(tdet.SSDLite().state_dict())
    with pytest.raises(SystemExit):
        train_detector.main(["--steps", "1", "--device", "cpu", "--out",
                             tdet.DETECTOR_ASSET])


def test_trainer_loss_falls():
    """Eight steps on one fixed batch at a raised learning rate: the loss
    must fall (the optimizer, the schedule and the loss wired together)."""
    tr = train_detector.Trainer(steps=8, batch=2, lr=3e-3, device="cpu")
    batch = tr.batch_for(0)
    losses = [float(tr.step(*batch)[0]) for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
