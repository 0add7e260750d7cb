"""Train the SSD detector on synthetic person scenes and write the weights.

    python -m sgslam_tpu_torch.train_detector [--steps N] [--batch B]
        [--lr LR] [--device cuda|cpu] [--out PATH] [--report PATH]

The port's counterpart of `tools/train_detector.py`: flax's default
initialization, AdamW with the reference's cosine schedule (alpha 0.05,
weight decay 1e-5), the four texture-varied rooms crossed with both
training cameras (one variant per step, in turn), then a held-out report
(per-class recall and precision at IoU 0.5 on 80 scenes of unseen
textures; person at the cull gate and at the standard gate). It runs on the
card unless `--device cpu` is given. It writes the weights to `--out`
(default `build/detector_torch.npz`, the reference's float16 layout, which
`Detector2D` and the reference's `load_params` read) and the report to
`--report` (default `build/DETECTOR_torch.json`); it never writes the
packaged asset or the reference's report.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import resolve_device
from .config import DetectorConfig
from .io import synthetic
from .models import detector as det_mod
from .models import detector_train as dt

BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build")
CLASSES = {15: "person", 2: "bicycle", 5: "bottle", 6: "bus", 7: "car",
           9: "chair", 11: "diningtable", 16: "pottedplant", 18: "sofa",
           19: "train", 20: "tvmonitor"}


def vary(planes, off):
    return tuple(synthetic.Plane(p.nx, p.ny, p.nz, p.d, p.tex_seed + off)
                 for p in planes)


def variants():
    """The four texture-varied rooms crossed with the square and the 4:3
    training camera."""
    rooms = [vary(synthetic.ROOM, o) for o in (0.0, 13.0)] + \
            [vary(synthetic.ROOM_CLOSED, o) for o in (29.0, 43.0)]
    return [(p, c) for p in rooms for c in (dt.TRAIN_CAM, dt.TRAIN_CAM_43)]


class Trainer:
    """The model, its optimizer and schedule, and the scene generator."""

    def __init__(self, steps: int, batch: int = 16, lr: float = 3e-4,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.batch = batch
        self.model = det_mod.SSDLite(num_classes=21)
        self.model.load_state_dict(dt.init_params(self.model, seed))
        self.model.to(self.device).train()
        self.anchors = torch.from_numpy(det_mod.make_anchors(300)).to(
            self.device)
        self.opt, self.sched = dt.make_optimizer(self.model, lr, steps)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.variants = variants()

    def batch_for(self, i: int):
        planes, cam = self.variants[i % len(self.variants)]
        draws = dt.draw_scenes(self.gen, self.batch, cam, self.device)
        return dt.sample_batch(draws, self.batch, planes, cam)

    def step(self, rgb, boxes, labels, vis):
        """One AdamW step on a batch; returns (loss, mean positives)."""
        loss, npos = dt.batched_loss(self.model, self.anchors, None, rgb,
                                     boxes, labels, vis)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.sched.step()
        return loss.detach(), npos

    def train(self, steps: int, log_every: int = 200):
        t0 = time.time()
        for i in range(steps):
            loss, npos = self.step(*self.batch_for(i))
            if i % log_every == 0 or i == steps - 1:
                print(f"step {i:5d}  loss {float(loss):.4f}  pos/img "
                      f"{float(npos):.1f}  {time.time() - t0:.0f}s",
                      flush=True)


def _iou(g, p):
    x1, y1 = max(g[0], p[0]), max(g[1], p[1])
    x2, y2 = min(g[2], p[2]), min(g[3], p[3])
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    u = (g[2] - g[0]) * (g[3] - g[1]) + (p[2] - p[0]) * (p[3] - p[1]) - inter
    return inter / max(u, 1e-9)


def _tally(stat, pred, gts):
    matched = set()
    for g in gts:
        best, bi = 0.0, -1
        for pi, p in enumerate(pred):
            if pi not in matched and _iou(g, p) > best:
                best, bi = _iou(g, p), pi
        if best >= 0.5:
            stat[0] += 1
            matched.add(bi)
        else:
            stat[2] += 1
    stat[1] += len(pred) - len(matched)


def held_out_report(params, device, n_scenes: int = 80, seed: int = 123,
                    steps: int = 0) -> dict:
    """Per-class recall / precision at IoU 0.5 on `n_scenes` scenes of
    unseen textures (alternating cameras): person at the cull gate (0.2)
    and the standard gate, the other classes at the standard gate."""
    cfg = DetectorConfig()
    det = det_mod.Detector2D(cfg, params=params, device=device)
    planes = vary(synthetic.ROOM, 71.0)
    gen = torch.Generator(device=det.device).manual_seed(seed)
    gates = {c: (cfg.person_box_conf_for_culling if c == 15
                 else cfg.conf_threshold) for c in CLASSES}
    stats = {c: [0, 0, 0] for c in CLASSES}
    stats_p_std = [0, 0, 0]
    for j in range(n_scenes):
        cam = dt.TRAIN_CAM if j % 2 == 0 else dt.TRAIN_CAM_43
        rgb, boxes, labels, vis = dt.sample_batch(
            dt.draw_scenes(gen, 1, cam, det.device), 1, planes, cam)
        allb, _, _, _ = det.detect(rgb[0], 300, 300)
        pb, pc = allb.xyxy.cpu().numpy(), allb.cls.cpu().numpy()
        ps, pv = allb.score.cpu().numpy(), allb.valid.cpu().numpy()
        gt_b = boxes[0].cpu().numpy() * 300.0
        gt_l, gt_v = labels[0].cpu().numpy(), vis[0].cpu().numpy()
        for c in CLASSES:
            gts = gt_b[gt_v & (gt_l == c)]
            _tally(stats[c], pb[pv & (pc == c) & (ps > gates[c])], gts)
            if c == 15:
                _tally(stats_p_std, pb[pv & (pc == c)
                                       & (ps > cfg.conf_threshold)], gts)
    report = {"steps": steps, "device": str(det.device),
              "eval": "held-out synthetic (unseen textures + photometric "
                      "augmentation), IoU 0.5; person at the 0.2 cull gate "
                      "+ the 0.5 standard gate, others at 0.5",
              "classes": {}}
    for c, name in CLASSES.items():
        tp, fp, fn = stats[c]
        report["classes"][name] = {
            "recall": tp / max(tp + fn, 1), "precision": tp / max(tp + fp, 1),
            "gate": gates[c], "tp": tp, "fp": fp, "fn": fn}
    tp, fp, fn = stats_p_std
    report["classes"]["person@0.5"] = {
        "recall": tp / max(tp + fn, 1), "precision": tp / max(tp + fp, 1),
        "gate": cfg.conf_threshold, "tp": tp, "fp": fp, "fn": fn}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="train the SSD detector on "
                                 "synthetic scenes")
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eval-scenes", type=int, default=80)
    ap.add_argument("--out", default=os.path.join(BUILD,
                                                  "detector_torch.npz"))
    ap.add_argument("--report", default=os.path.join(BUILD,
                                                     "DETECTOR_torch.json"))
    a = ap.parse_args(argv)
    for path in (a.out, a.report):
        if os.path.abspath(path) in (os.path.abspath(det_mod.DETECTOR_ASSET),
                                     os.path.join(os.path.dirname(BUILD),
                                                  "DETECTOR.json")):
            raise SystemExit(f"refusing to overwrite the reference's {path}")
    if a.device == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    tr = Trainer(a.steps, a.batch, a.lr, a.seed, a.device)
    n = sum(p.numel() for p in tr.model.parameters())
    print(f"model: {n / 1e6:.2f}M params, device={tr.device}")
    tr.train(a.steps)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    params = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    dt.save_params(a.out, params)
    print(f"saved {a.out} ({os.path.getsize(a.out) / 1e6:.2f} MB)")
    report = held_out_report(params, tr.device, a.eval_scenes,
                             steps=a.steps)
    for name, r in report["classes"].items():
        print(f"held-out {name}@{r['gate']}: recall {r['recall']:.3f} "
              f"precision {r['precision']:.3f} (tp={r['tp']} fp={r['fp']} "
              f"fn={r['fn']})")
    os.makedirs(os.path.dirname(os.path.abspath(a.report)), exist_ok=True)
    with open(a.report, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {a.report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
