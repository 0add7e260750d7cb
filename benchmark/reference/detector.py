"""The SSDLite person detector: `sgslam_tpu_torch/models/detector.py`
(network, anchors, decode, NMS, `Detector2D`) and the weight layout of
`convert.py`. The weights are read from the same `.npz` file the program
reads.

Frozen copy of the files named above as of commit 1275b16, with
their imports pointed at this folder. It imports nothing of the
program.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .cull import Boxes
from .orb import _resize_weights, topk_stable


GN_EPS = 1e-6          # flax.linen.GroupNorm's epsilon
# (ch_out, stride) of the eight blocks; the SSD heads read blocks 5 and 7
_BLOCKS = ((64, 2), (64, 1), (128, 2), (128, 1), (128, 2), (128, 1),
           (256, 2), (256, 1))


_SSD_MODULES = {"Conv_0": "stem", "GroupNorm_0": "stem_gn",
                "Conv_1": "box16", "Conv_2": "cls16",
                "Conv_3": "box32", "Conv_4": "cls32"}


def _flax_key(key) -> str:
    """'params/DWBlock_0/Conv_1/kernel' or its tuple form, without the
    leading 'params'."""
    parts = key.split("/") if isinstance(key, str) else list(key)
    return "/".join(parts[1:] if parts[0] == "params" else parts)


def detector_params_from_numpy(flat: dict) -> dict:
    """Flax-flattened SSDLite parameters (the `detector.npz` keys, or
    `flatten_dict` tuples) -> an `SSDLite` state dict of float32 tensors.
    Kernels go from HWIO to OIHW; a depthwise kernel (3, 3, 1, C) becomes
    (C, 1, 3, 3); GroupNorm `scale` is torch's `weight`."""
    out = {}
    for key, val in flat.items():
        path = _flax_key(key).split("/")
        if path[0].startswith("DWBlock_"):
            blk = path[0].split("_")[1]
            kind, j = path[1].split("_")
            module = f"blocks.{blk}.{'conv' if kind == 'Conv' else 'gn'}{j}"
        else:
            module = _SSD_MODULES[path[0]]
        x = np.array(val, np.float32)
        name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[path[-1]]
        if path[-1] == "kernel":
            x = x.transpose(3, 2, 0, 1)
        out[f"{module}.{name}"] = torch.from_numpy(np.ascontiguousarray(x))
    return out


def same_padding(size: int, k: int, stride: int):
    """TF/flax SAME padding (before, after) of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class _Conv(nn.Conv2d):
    """Conv2d with flax's SAME padding, computed from the input size."""

    def __init__(self, c_in, c_out, k, stride=1, groups=1, bias=True):
        super().__init__(c_in, c_out, k, stride=stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = same_padding(x.shape[-2], k, s)
        left, right = same_padding(x.shape[-1], k, s)
        return super().forward(F.pad(x, (left, right, top, bottom)))


def _gn(ch):
    return nn.GroupNorm(8, ch, eps=GN_EPS)


class DWBlock(nn.Module):
    """Inverted residual: 1x1 expand -> 3x3 depthwise -> 1x1 project."""

    def __init__(self, ch_in: int, ch_out: int, stride: int = 1,
                 expand: int = 4):
        super().__init__()
        mid = ch_in * expand
        self.residual = stride == 1 and ch_in == ch_out
        self.conv0 = _Conv(ch_in, mid, 1, bias=False)
        self.gn0 = _gn(mid)
        self.conv1 = _Conv(mid, mid, 3, stride=stride, groups=mid, bias=False)
        self.gn1 = _gn(mid)
        self.conv2 = _Conv(mid, ch_out, 1, bias=False)
        self.gn2 = _gn(ch_out)

    def forward(self, x):
        h = F.relu(self.gn0(self.conv0(x)))
        h = F.relu(self.gn1(self.conv1(h)))
        h = self.gn2(self.conv2(h))
        return h + x if self.residual else h


class SSDLite(nn.Module):
    """Backbone + two SSD heads. Input [B, 3, 300, 300] in [0,1]; returns
    (boxes [B, A, 4], logits [B, A, classes])."""

    def __init__(self, num_classes: int = 21, num_anchors: int = 6):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.stem = _Conv(3, 32, 3, stride=2, bias=False)        # 150
        self.stem_gn = _gn(32)
        blocks, ch = [], 32
        for out, stride in _BLOCKS:     # 75, 75, 38, 38, 19, 19, 10, 10
            blocks.append(DWBlock(ch, out, stride))
            ch = out
        self.blocks = nn.ModuleList(blocks)
        self.box16 = _Conv(128, num_anchors * 4, 3)
        self.cls16 = _Conv(128, num_anchors * num_classes, 3)
        self.box32 = _Conv(256, num_anchors * 4, 3)
        self.cls32 = _Conv(256, num_anchors * num_classes, 3)

    def forward(self, x):
        h = F.relu(self.stem_gn(self.stem(x)))
        for i, blk in enumerate(self.blocks):
            h = blk(h)
            if i == 5:
                f16 = h                                         # 19x19
        f32 = h                                                 # 10x10
        boxes, logits = [], []
        for f, box, cls in ((f16, self.box16, self.cls16),
                            (f32, self.box32, self.cls32)):
            b = f.shape[0]
            # NCHW -> the reference's NHWC anchor order
            boxes.append(box(f).permute(0, 2, 3, 1).reshape(b, -1, 4))
            logits.append(cls(f).permute(0, 2, 3, 1).reshape(
                b, -1, self.num_classes))
        return torch.cat(boxes, 1), torch.cat(logits, 1)


def make_anchors(input_size: int = 300,
                 feat_sizes: Sequence[int] = (19, 10),
                 scales: Sequence[float] = (0.16, 0.45),
                 ratios: Sequence[float] = (1.0, 2.0, 0.5)) -> np.ndarray:
    """SSD anchors (cx, cy, w, h) normalized to [0,1]. [A_total, 4]."""
    anchors = []
    for fs, scale in zip(feat_sizes, scales):
        s2 = math.sqrt(scale * min(1.0, scale * 2.0))
        for iy in range(fs):
            for ix in range(fs):
                cx = (ix + 0.5) / fs
                cy = (iy + 0.5) / fs
                for r in ratios:
                    sr = math.sqrt(r)
                    anchors.append([cx, cy, scale * sr, scale / sr])
                    anchors.append([cx, cy, s2 * sr, s2 / sr])
    return np.asarray(anchors, np.float32)


def decode_boxes(pred, anchors, variances=(0.1, 0.2)):
    """SSD box decode -> (x1, y1, x2, y2) normalized."""
    cxy = anchors[:, :2] + pred[:, :2] * variances[0] * anchors[:, 2:]
    wh = anchors[:, 2:] * torch.exp(torch.clamp(pred[:, 2:] * variances[1],
                                                -4.0, 4.0))
    return torch.cat([cxy - wh / 2, cxy + wh / 2], -1)


def _iou(a, b):
    """a [N,4], b [M,4] -> [N,M]."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / torch.clamp(area_a[:, None] + area_b[None, :] - inter,
                               min=1e-9)


def nms_topk(boxes, scores, cls, k: int, iou_thresh: float = 0.45,
             pool: int = 128):
    """Fixed-shape greedy class-aware NMS: the `pool` best candidates
    (ties toward the lower index) -> `k` picks, by k argmax+suppress steps
    on the device (no host read). Returns (out_idx [k] int64, out_ok [k])."""
    top_s, top_i = topk_stable(scores, pool)
    b = boxes[top_i]
    c = cls[top_i]
    alive = top_s > 0.0
    iou = _iou(b, b)
    suppressor = (iou > iou_thresh) & (c[:, None] == c[None, :])
    out_idx, out_ok = [], []
    for _ in range(k):
        s = torch.where(alive, top_s, -1.0)
        # a [1] index: indexing with a 0-dim tensor reads it on the host
        j = torch.argmax(s).reshape(1)
        out_ok.append(s.index_select(0, j) > 0.0)
        out_idx.append(top_i.index_select(0, j))
        alive = alive & ~suppressor.index_select(0, j)[0]
        alive = alive.index_fill(0, j, False)
    return torch.cat(out_idx), torch.cat(out_ok)


class Detector:
    """The detector from its weights file (`Detector2D`)."""

    def __init__(self, cfg, path: str, device):
        self.cfg = cfg
        self.device = torch.device(device)
        with np.load(path) as z:
            flat = {k: z[k].astype(np.float32) for k in z.files}
        self.model = SSDLite(num_classes=cfg.num_classes)
        self.model.load_state_dict(detector_params_from_numpy(flat))
        self.model = self.model.to(self.device).eval()
        self.anchors = torch.from_numpy(make_anchors(cfg.input_size)).to(
            self.device)

    @torch.no_grad()
    def raw(self, rgb):
        """rgb [H,W,3] -> (box_pred [A,4], logits [A,classes]) of the
        resized image."""
        n = self.cfg.input_size
        img = torch.as_tensor(rgb, dtype=torch.float32, device=self.device)
        wh = _resize_weights(img.shape[0], n, self.device)     # [H, n]
        ww = _resize_weights(img.shape[1], n, self.device)     # [W, n]
        chw = img.permute(2, 0, 1)
        x = (wh.T @ chw) @ ww                                  # [3, n, n]
        box_pred, logits = self.model(x[None])
        return box_pred[0], logits[0]

    @torch.no_grad()
    def detect_normalized(self, rgb):
        """(boxes [max_boxes,4] in [0,1], cls, score, ok) after NMS."""
        cfg = self.cfg
        box_pred, logits = self.raw(rgb)
        boxes = decode_boxes(box_pred, self.anchors)
        probs = torch.softmax(logits, -1)
        # best non-background class per anchor (first maximum)
        score = torch.amax(probs[:, 1:], -1)
        cls = (torch.argmax(probs[:, 1:], -1) + 1).to(torch.int32)
        low_gate = torch.where(cls == cfg.person_class,
                               cfg.dynamic_conf_threshold, cfg.conf_threshold)
        score = torch.where(score > low_gate, score, 0.0)
        idx, ok = nms_topk(boxes, score, cls, cfg.max_boxes)
        return (torch.clamp(boxes[idx], 0.0, 1.0), cls[idx], score[idx], ok)

    @torch.no_grad()
    def detect_batch(self, grays, image_w: int, image_h: int):
        """A chunk's detections (the reference's `detect_batch` of
        `scan_pipeline.make_track_chunk`): grays [n, H, W] -> the
        antialiased linear resize to the input size, one SSDLite forward
        over the batch, then per frame the decode, the person / object
        gates and `nms_topk`. Returns (cull, dynamic, objects) `Boxes` with
        [n, max_boxes] fields in pixel coordinates."""
        c = self.cfg
        s = c.input_size
        g = grays.to(device=self.device, dtype=torch.float32)
        wh = _resize_weights(g.shape[1], s, self.device)         # [H, s]
        ww = _resize_weights(g.shape[2], s, self.device)         # [W, s]
        imgs = (wh.T @ g) @ ww                                    # [n, s, s]
        box_pred, logits = self.model(imgs[:, None].expand(-1, 3, -1, -1))
        scale = torch.tensor([image_w, image_h, image_w, image_h],
                             dtype=torch.float32, device=self.device)
        out = ([], [], [])
        for bp, lg in zip(box_pred, logits):
            boxes = decode_boxes(bp, self.anchors)
            probs = torch.softmax(lg, -1)
            cls = (torch.argmax(probs[:, 1:], -1) + 1).to(torch.int32)
            score = torch.amax(probs[:, 1:], -1)
            low = torch.where(cls == c.person_class,
                              c.dynamic_conf_threshold, c.conf_threshold)
            score = torch.where(score > low, score, 0.0)
            idx, ok = nms_topk(boxes, score, cls, c.max_boxes)
            px = torch.clamp(boxes[idx], 0.0, 1.0) * scale
            k_cls, k_score = cls[idx], score[idx]
            is_person = k_cls == c.person_class
            keep = ok & (k_score > 0)
            for lst, mask in zip(out, (
                    keep & is_person
                    & (k_score > c.person_box_conf_for_culling),
                    keep & is_person,
                    keep & ~is_person & (k_score > c.conf_threshold))):
                lst.append(Boxes(px, k_cls, k_score, mask))
        return tuple(Boxes(*(torch.stack([getattr(b, f) for b in lst])
                             for f in ("xyxy", "cls", "score", "valid")))
                     for lst in out)

    def detect(self, rgb, image_w: int, image_h: int):
        """rgb [H,W,3] float in [0,1] -> (all_boxes, person_boxes_for_cull,
        dynamic_boxes_for_mapping, objects_2d) as `Boxes` in pixel coords
        (Detector2D::detect's four lists)."""
        xyxy, cls, score, valid = self.detect_normalized(rgb)
        scale = torch.tensor([image_w, image_h, image_w, image_h],
                             dtype=torch.float32, device=self.device)
        px = xyxy * scale[None, :]
        c = self.cfg
        is_person = cls == c.person_class
        keep_any = valid & ((score > c.conf_threshold)
                            | (is_person & (score > c.dynamic_conf_threshold)))
        all_boxes = Boxes(px, cls, score, keep_any)
        person_cull = Boxes(px, cls, score, keep_any & is_person
                            & (score > c.person_box_conf_for_culling))
        person_map = Boxes(px, cls, score, keep_any & is_person)
        objects2d = Boxes(px, cls, score, keep_any & ~is_person
                          & (score > c.conf_threshold))
        return all_boxes, person_cull, person_map, objects2d
