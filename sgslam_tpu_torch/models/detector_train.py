"""SSD training for the 2-D detector: anchor matching, box encoding, the
multibox loss with hard-negative mining, and the synthetic person-scene
sampler.

Port of `sgslam_tpu/models/detector_train.py`. What differs, and why:
  * draws: `jax.random` streams cannot be reproduced in torch, so the
    sampler takes its random numbers as a `SceneDraws` of tensors (the
    uniforms in [0, 1), the prop classes, the pixel noise), which
    `draw_scenes` makes from an explicit `torch.Generator` and a test makes
    from the reference's own keys (8 per scene; 5 for the props, 5 for the
    augmentation), so that both packages render the same scenes;
  * the scenes are rendered one by one (the reference vmaps the renderer)
    on the draws' device; the 4:3 camera's 400x300 frames are resized with
    `ops.image._resize_weights`, the antialiased weights of
    `jax.image.resize(..., "linear")`;
  * `match_anchors`' `.at[best_anchor].set(...)` repeats an index when two
    boxes share a best anchor, and JAX's CPU scatter lets the last write
    win; the port takes the highest box index explicitly (a deterministic
    segment max), on every device;
  * hard-negative mining ranks with `torch.argsort(stable=True)`, since
    `jnp.argsort` is stable and most background scores tie;
  * images are NHWC at the public functions, as in the reference; the
    model (`detector.SSDLite`) is NCHW inside, and its parameters are a
    state dict (`init_params` draws flax's default initializers; the
    `.npz` layout is `convert.detector_params_{to,from}_numpy`'s).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..convert import detector_params_from_numpy, detector_params_to_numpy
from ..geometry import se3
from ..geometry.camera import Camera
from ..io import synthetic
from ..ops.image import _resize_weights
from . import detector as det_mod

# training cameras: the detector's native square input, plus a 4:3 variant
# whose horizontal squash matches runtime (640x480 frames resized to
# 300x300, the reference's NCNN preprocessing)
TRAIN_CAM = Camera(fx=246.0, fy=246.0, cx=149.5, cy=149.5, bf=20.0,
                   width=300, height=300)
TRAIN_CAM_43 = Camera(fx=246.0, fy=246.0, cx=199.5, cy=149.5, bf=20.0,
                      width=400, height=300)
MAX_PEOPLE = 3
PERSON_CLASS = 15
MAX_PROPS = 4
INPUT = 300

# size priors (half_w range, half_h range) per prop class, in meters
_PROP_PRIORS = {
    synthetic.PROP_BICYCLE: ((0.35, 0.55), (0.25, 0.40)),
    synthetic.PROP_BOTTLE: ((0.05, 0.10), (0.14, 0.30)),
    synthetic.PROP_BUS: ((0.60, 0.90), (0.35, 0.55)),
    synthetic.PROP_CAR: ((0.50, 0.80), (0.25, 0.40)),
    synthetic.PROP_CHAIR: ((0.22, 0.45), (0.28, 0.50)),
    synthetic.PROP_TABLE: ((0.50, 0.80), (0.20, 0.35)),
    synthetic.PROP_PLANT: ((0.10, 0.22), (0.15, 0.35)),
    synthetic.PROP_SOFA: ((0.50, 0.90), (0.30, 0.45)),
    synthetic.PROP_TRAIN: ((0.70, 1.00), (0.30, 0.45)),
    synthetic.PROP_TV: ((0.28, 0.50), (0.18, 0.35)),
}


# ---------------------------------------------------------------------------
# Scene sampling (a function of its draws -> image + GT boxes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SceneDraws:
    """The random numbers behind scenes, with a leading scene axis [S].
    Uniforms lie in [0, 1); the reference scales them as
    `jax.random.uniform(key, shape, lo, hi)` does."""

    pose: torch.Tensor        # [S,6]   camera jitter (ks[0])
    people_z: torch.Tensor    # [S,3]   (ks[2])
    people_cx: torch.Tensor   # [S,3]   (ks[3])
    people_cy: torch.Tensor   # [S,3]   (ks[4])
    people_r: torch.Tensor    # [S,3,3] (ks[5])
    prop_cls: torch.Tensor    # [S,4]   int64 index into PROP_CLASSES
    prop_z: torch.Tensor      # [S,4]
    prop_cx: torch.Tensor     # [S,4]
    prop_cy: torch.Tensor     # [S,4]
    prop_r: torch.Tensor      # [S,4,4]
    contrast: torch.Tensor    # [S]     augmentation (ks[7] split 5)
    bright: torch.Tensor      # [S]
    sigma: torch.Tensor       # [S]
    blur_w: torch.Tensor      # [S]
    noise: torch.Tensor       # [S,H,W] standard normal

    def __getitem__(self, i):
        return SceneDraws(*(getattr(self, f.name)[i]
                            for f in dataclasses.fields(self)))

    def __len__(self):
        return self.pose.shape[0]


def draw_scenes(generator: torch.Generator, n: int, cam: Camera = TRAIN_CAM,
                device=None) -> SceneDraws:
    """`n` scenes' draws from `generator`, on its device."""
    dev = device if device is not None else generator.device

    def u(*shape):
        return torch.rand((n,) + shape, generator=generator, device=dev)

    return SceneDraws(
        pose=u(6), people_z=u(3), people_cx=u(3), people_cy=u(3),
        people_r=u(3, 3),
        prop_cls=torch.randint(0, len(synthetic.PROP_CLASSES), (n, 4),
                               generator=generator, device=dev),
        prop_z=u(4), prop_cx=u(4), prop_cy=u(4), prop_r=u(4, 4),
        contrast=u(), bright=u(), sigma=u(), blur_w=u(),
        noise=torch.randn((n, cam.height, cam.width), generator=generator,
                          device=dev))


def _uniform(u, lo: float, hi: float):
    """`jax.random.uniform`'s scaling of [0, 1) floats into [lo, hi)."""
    lo_t = torch.tensor(lo, dtype=torch.float32, device=u.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


def _f32(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


def _sample_props(d: SceneDraws):
    """One scene's up to MAX_PROPS prop rows [Q,7] with per-class size
    priors."""
    dev = d.prop_z.device
    cls = _f32(synthetic.PROP_CLASSES, dev)[d.prop_cls]
    z = _uniform(d.prop_z, 1.2, 3.4)
    cx = _uniform(d.prop_cx, -0.42, 0.42) * z
    cy = _uniform(d.prop_cy, -0.30, 0.65)
    r = d.prop_r
    lo_w = torch.zeros(MAX_PROPS, device=dev)
    hi_w = torch.zeros(MAX_PROPS, device=dev)
    lo_h = torch.zeros(MAX_PROPS, device=dev)
    hi_h = torch.zeros(MAX_PROPS, device=dev)
    for c, ((lw, hw_), (lh, hh_)) in _PROP_PRIORS.items():
        sel = cls == c
        lo_w = torch.where(sel, lw, lo_w)
        hi_w = torch.where(sel, hw_, hi_w)
        lo_h = torch.where(sel, lh, lo_h)
        hi_h = torch.where(sel, hh_, hi_h)
    hw = lo_w + (hi_w - lo_w) * r[:, 0]
    hh = lo_h + (hi_h - lo_h) * r[:, 1]
    active = r[:, 2] < _f32([0.8, 0.6, 0.45, 0.3], dev)
    hh = torch.where(active, hh, -1.0)
    seed = 60.0 * r[:, 3]
    return torch.stack([cx, cy, z, hw, hh, cls, seed], -1)


def _augment(d: SceneDraws, gray):
    """Photometric augmentation: brightness/contrast jitter, additive
    Gaussian noise, and a probabilistic 3x3 blur."""
    contrast = _uniform(d.contrast, 0.6, 1.3)
    bright = _uniform(d.bright, -0.15, 0.15)
    g = torch.clamp((gray - 0.5) * contrast + 0.5 + bright, 0.0, 1.0)
    sigma = _uniform(d.sigma, 0.0, 0.04)
    g = g + sigma * d.noise
    # blended 3x3 box blur with random strength (0 = sharp), edge padding
    h, w = g.shape
    pad = torch.nn.functional.pad(g[None, None], (1, 1, 1, 1),
                                  mode="replicate")[0, 0]
    blur = 0
    for i in range(3):
        for j in range(3):
            blur = blur + pad[i:i + h, j:j + w]
    blur = blur / 9.0
    wgt = d.blur_w * 0.8
    return torch.clamp((1 - wgt) * g + wgt * blur, 0.0, 1.0)


def _sample_scene(d: SceneDraws, planes, cam: Camera):
    """One scene from its draws: camera jitter, up to MAX_PEOPLE person
    capsules and MAX_PROPS props, photometric augmentation.

    Returns (gray [300,300], boxes01 [G,4] xyxy normalized, labels [G] i32,
    visible [G]). Normalized boxes are invariant to the horizontal resize.
    """
    dev = d.pose.device
    lo = _f32([-0.65, -0.20, -0.40, -0.10, -0.15, -0.06], dev)
    hi = _f32([0.65, 0.20, 0.40, 0.10, 0.15, 0.06], dev)
    T_wc = se3.se3_exp(d.pose * (hi - lo) + lo)

    z = _uniform(d.people_z, 1.1, 3.4)
    cx = _uniform(d.people_cx, -0.42, 0.42) * z
    cy = _uniform(d.people_cy, -0.25, 0.45)
    r = d.people_r
    half_h = 0.25 + 0.65 * r[:, 0]
    active = r[:, 1] < _f32([0.9, 0.55, 0.3], dev)
    half_h = torch.where(active, half_h, -1.0)
    people = torch.stack([cx, cy, z, half_h, 60.0 * r[:, 2]], -1)
    props = _sample_props(d)

    gray, _ = synthetic.render_frame_scene(cam, T_wc, people, props,
                                           planes=planes)
    gray = _augment(d, gray)
    if cam.width != INPUT or cam.height != INPUT:
        wh = _resize_weights(cam.height, INPUT, gray.device)
        ww = _resize_weights(cam.width, INPUT, gray.device)
        gray = (wh.T @ gray) @ ww
    T_cw = se3.se3_inverse(T_wc)
    boxes, vis = zip(*([synthetic.person_gt_box(cam, T_cw, p) for p in people]
                       + [synthetic.prop_gt_box(cam, T_cw, q) for q in props]))
    boxes, vis = torch.stack(boxes), torch.stack(vis)
    labels = torch.cat([
        torch.full((MAX_PEOPLE,), PERSON_CLASS, dtype=torch.int32,
                   device=dev), props[:, 5].to(torch.int32)])
    scale = _f32([cam.width - 1.0, cam.height - 1.0, cam.width - 1.0,
                  cam.height - 1.0], dev)
    return gray, boxes / scale, labels, vis


def sample_batch(draws: SceneDraws, batch: int, planes, cam=TRAIN_CAM):
    """`batch` scenes from their draws -> (rgb [B,300,300,3] NHWC, boxes
    [B,G,4], labels [B,G], visible [B,G])."""
    if len(draws) != batch:
        raise ValueError(f"{len(draws)} scenes' draws for a batch of {batch}")
    gray, boxes, labels, vis = (torch.stack(x) for x in zip(*(
        _sample_scene(draws[i], planes, cam) for i in range(batch))))
    return gray[..., None].expand(-1, -1, -1, 3), boxes, labels, vis


# ---------------------------------------------------------------------------
# Anchor matching + encoding (inverse of detector.decode_boxes)
# ---------------------------------------------------------------------------

def encode_boxes(gt_xyxy, anchors, variances=(0.1, 0.2)):
    g_cxy = (gt_xyxy[..., :2] + gt_xyxy[..., 2:]) / 2.0
    g_wh = torch.clamp(gt_xyxy[..., 2:] - gt_xyxy[..., :2], min=1e-4)
    t_xy = (g_cxy - anchors[:, :2]) / (variances[0] * anchors[:, 2:])
    t_wh = torch.log(g_wh / anchors[:, 2:]) / variances[1]
    return torch.cat([t_xy, t_wh], -1)


def match_anchors(anchors, gt_boxes, gt_labels, gt_valid,
                  pos_iou: float = 0.5):
    """Per-anchor targets. anchors [A,4] cxcywh; gt [G,4] xyxy.

    Returns (cls_target [A] i32, box_target [A,4], pos_mask [A]).
    """
    A, G = anchors.shape[0], gt_boxes.shape[0]
    dev = anchors.device
    a_xyxy = torch.cat([anchors[:, :2] - anchors[:, 2:] / 2,
                        anchors[:, :2] + anchors[:, 2:] / 2], -1)
    iou = det_mod._iou(a_xyxy, gt_boxes)                 # [A,G]
    iou = torch.where(gt_valid[None, :], iou, 0.0)
    best_iou, _ = torch.max(iou, 1)
    best_gt = torch.argmax(iou, 1)                       # first maximum
    pos = best_iou >= pos_iou
    # force the best anchor of each GT positive; where two GTs share an
    # anchor, the highest GT index is the reference's last write
    best_anchor = torch.argmax(iou, 0)                   # [G]
    win = torch.full((A,), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(0, best_anchor, torch.arange(G, device=dev), "amax")
    has = win >= 0
    forced_gt = torch.where(has, win, 0)
    force = has & gt_valid[forced_gt]
    gt_of_anchor = torch.where(force & ~pos, forced_gt, best_gt)
    pos = pos | force
    cls_target = torch.where(pos, gt_labels[gt_of_anchor], 0).to(torch.int32)
    box_target = encode_boxes(gt_boxes[gt_of_anchor], anchors)
    return cls_target, box_target, pos


def multibox_loss(box_pred, logits, cls_target, box_target, pos,
                  neg_ratio: float = 3.0):
    """SSD loss: smooth-L1 on positives + CE with hard-negative mining."""
    ce = -torch.gather(torch.log_softmax(logits, -1), -1,
                       cls_target.to(torch.int64)[:, None])[:, 0]
    n_pos = torch.clamp(torch.sum(pos.to(torch.int32)), min=1)
    # hard negatives: highest-loss background anchors, 3:1
    neg_ce = torch.where(pos, -torch.inf, ce)
    rank = torch.argsort(torch.argsort(-neg_ce, stable=True), stable=True)
    neg = ~pos & (rank < neg_ratio * n_pos)
    cls_loss = torch.sum(torch.where(pos | neg, ce, 0.0)) / n_pos

    diff = box_pred - box_target
    huber = torch.where(torch.abs(diff) < 1.0, 0.5 * diff ** 2,
                        torch.abs(diff) - 0.5)
    loc_loss = torch.sum(torch.where(pos[:, None], huber, 0.0)) / n_pos
    return cls_loss + loc_loss, (cls_loss, loc_loss, n_pos)


def batched_loss(model, anchors, params, rgb, gt_boxes, gt_labels, gt_valid):
    """Mean multibox loss over a batch and the mean positives per image.
    rgb [B,300,300,3] NHWC; `params` is a state dict for `model` (None:
    the model's own parameters)."""
    x = rgb.permute(0, 3, 1, 2)
    if params is None:
        box_pred, logits = model(x)
    else:
        box_pred, logits = torch.func.functional_call(model, params, (x,))
    losses, npos = [], []
    for bp, lg, gb, gl, gv in zip(box_pred, logits, gt_boxes, gt_labels,
                                  gt_valid):
        ct, bt, pos = match_anchors(anchors, gb, gl, gv)
        loss, aux = multibox_loss(bp, lg, ct, bt, pos)
        losses.append(loss)
        npos.append(aux[2])
    return (torch.mean(torch.stack(losses)),
            torch.mean(torch.stack(npos).to(torch.float32)))


# ---------------------------------------------------------------------------
# Initialization and optimizer (the reference's flax defaults and optax)
# ---------------------------------------------------------------------------

def init_params(model, seed: int = 0) -> dict:
    """A state dict with flax's default initializers: conv kernels from a
    truncated normal (lecun_normal: std sqrt(1 / fan_in) / .8796, cut at two
    std), zero biases, GroupNorm scale 1 and bias 0. Drawn on the CPU from
    a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in model.state_dict().items():
        if name.endswith("weight") and p.dim() == 4:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            t = torch.empty(p.shape)
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=gen)
        elif name.endswith("weight"):
            t = torch.ones(p.shape)
        else:
            t = torch.zeros(p.shape)
        out[name] = t
    return out


def cosine_factor(step: int, steps: int, alpha: float = 0.05) -> float:
    """optax.cosine_decay_schedule(lr, steps, alpha) / lr at `step`."""
    t = min(step, steps) / steps
    return (1 - alpha) * 0.5 * (1 + np.cos(np.pi * t)) + alpha


def make_optimizer(model, lr: float, steps: int, weight_decay: float = 1e-5):
    """The reference trainer's optax.adamw(cosine_decay_schedule(lr, steps,
    alpha=0.05), weight_decay=1e-5) as torch's AdamW (the same defaults:
    betas 0.9 / 0.999, eps 1e-8, decay on every parameter) and a schedule.
    Returns (optimizer, scheduler)."""
    opt = torch.optim.AdamW(model.parameters(), lr=lr,
                            weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: cosine_factor(s, steps))
    return opt, sched


# ---------------------------------------------------------------------------
# Weight persistence (the layout Detector2D loads)
# ---------------------------------------------------------------------------

def save_params(path: str, params) -> None:
    """An `SSDLite` state dict -> the flattened float16 `.npz` of the
    reference (`detector.npz`'s keys and layout)."""
    np.savez_compressed(path, **{k: v.astype(np.float16) for k, v in
                                 detector_params_to_numpy(params).items()})


def load_params(path: str) -> dict:
    """A detector `.npz` -> an `SSDLite` state dict of float32 tensors."""
    with np.load(path) as z:
        flat = {k: z[k].astype(np.float32) for k in z.files}
    return detector_params_from_numpy(flat)
