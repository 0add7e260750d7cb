#!/usr/bin/env python3
"""Does a whole run of the port repeat itself on the card, and if not, which
operation diverges first?

    python tools/repeat_divergence.py [--root DIR] [--device cuda]
        [--seed 1] [--frames 240] [--small] [--out FILE.json]

Runs chip_smoke.py phase 11a's chunked stress input (run_eval's 2-lap
stress circuit at 640x480, moved by one ulp with `--seed`, through
`ChunkedTracker(chunk=4, fetch_every=6, loop=LoopCloser)`) twice in one
process, every generator reset and every object made anew before each
run. During each run a `TorchDispatchMode` fingerprints the output of every
aten operation on the run's device (a position-weighted integer sum of the
output's bits, on the device; views are skipped) and notes the operation's
name, the port's source lines that called it and the chunk stage it ran
in (`ChunkedTracker.on_chunk_stage` / `on_stage`, and the tracer's
`loop.*` spans).

The first index where the two runs' fingerprints differ names the first
operation whose output differed on identical inputs: every operation
before it computed the same bits in both runs. The report also compares
the trajectories frame by frame and the final maps. `--root` imports the
port and chip_smoke.py from another checkout (for example the parent
commit unpacked under build/), so that two versions can be compared in one
call. `--small` runs kidnap_config() at 320x240 over `--frames` frames, a
rehearsal size for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# integer views of each float type's bits
_BITS = {"float32": "int32", "float64": "int64", "float16": "int16",
         "bfloat16": "int16"}
_WEIGHTS = 1 << 24


def _recorder_class():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        """Fingerprints of every non-view aten op's outputs on `dev`."""

        def __init__(self, dev, cap=12_000_000):
            super().__init__()
            self.dev = dev
            self.fp = torch.zeros(cap, dtype=torch.int64, device=dev)
            self.cap = cap
            self.n = 0
            self.names, self.where, self.marks = [], [], []
            idx = torch.arange(_WEIGHTS, dtype=torch.int64, device=dev)
            self.w = (idx * 2654435761 + 97) % 2147483647 + 1

        def mark(self, label):
            self.marks.append((self.n, label))

        def _hash(self, t):
            name = str(t.dtype).split(".")[-1]
            x = t.detach().contiguous().reshape(-1)
            if name in _BITS:
                x = x.view(getattr(torch, _BITS[name]))
            elif t.dtype.is_complex:
                return None
            b = x.to(torch.int64)
            n = b.numel()
            h = (b[:_WEIGHTS] * self.w[:min(n, _WEIGHTS)]).sum()
            return h + b[_WEIGHTS:].sum() if n > _WEIGHTS else h

        def _site(self):
            f = sys._getframe(2)
            sites = []
            while f is not None and len(sites) < 3:
                path = f.f_code.co_filename
                if "sgslam_tpu_torch" in path:
                    rel = path.split("sgslam_tpu_torch" + os.sep)[-1]
                    sites.append(f"{rel}:{f.f_lineno} {f.f_code.co_name}")
                f = f.f_back
            return " < ".join(sites)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if self.n >= self.cap or getattr(func, "is_view", False):
                return out
            outs = out if isinstance(out, (tuple, list)) else (out,)
            fp = None
            for t in outs:
                if isinstance(t, torch.Tensor) and t.device == self.dev \
                        and t.numel():
                    h = self._hash(t)
                    if h is not None:
                        fp = h if fp is None else fp * 1000003 + h
            if fp is not None:
                self.fp[self.n] = fp
                self.names.append(func.__name__)
                self.where.append(self._site())
                self.n += 1
            return out

    return Recorder


def _clear_port_caches():
    """Empty the port's memoized tables (resize weights, level
    thresholds), so that both runs launch the same operations."""
    for name, mod in list(sys.modules.items()):
        if name.startswith("sgslam_tpu_torch"):
            for obj in list(vars(mod).values()):
                if callable(getattr(obj, "cache_clear", None)):
                    obj.cache_clear()


def _stage_of(marks, i):
    label = "before the first mark"
    for n, lab in marks:
        if n > i:
            break
        label = lab
    return label


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    out = os.path.abspath(a.out) if a.out else None
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    os.chdir(root)

    import torch

    import chip_smoke as cs
    from sgslam_tpu_torch import run_eval
    from sgslam_tpu_torch.debug_stress import moved_frames
    from sgslam_tpu_torch.io import synthetic
    from sgslam_tpu_torch.slam import scan_pipeline
    from sgslam_tpu_torch.slam.loop_closing import LoopCloser

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(a.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = cs.kidnap_config() if a.small else run_eval._make_cfg(False)
    n = a.frames or cs.STRESS_FRAMES
    seq = synthetic.SyntheticSequence(
        cfg.camera, n_frames=n, planes=synthetic.ROOM_CLOSED,
        poses=synthetic.make_circuit_trajectory(n, loops=2.15 * n
                                                / cs.STRESS_FRAMES,
                                                device=dev), device=dev)
    rendered = [seq.frame(i) for i in range(n)]
    frames = rendered if a.seed < 0 else moved_frames(rendered, a.seed)
    gt = seq.poses.cpu().numpy()
    Recorder = _recorder_class()

    def run():
        _clear_port_caches()
        torch.manual_seed(0)
        if dev.type == "cuda":
            torch.cuda.manual_seed_all(0)
        np.random.seed(0)
        loop = LoopCloser(cfg, device=dev)
        ct = scan_pipeline.ChunkedTracker(cfg, chunk=cs.BENCH_CHUNK,
                                          fetch_every=cs.BENCH_FETCH,
                                          loop=loop, device=dev)
        rec = Recorder(dev)
        chunk = [0]

        def counted(fn):
            def wrapper(*args, **kw):
                chunk[0] += 1
                return fn(*args, **kw)
            return wrapper

        ct.process_chunk = counted(ct.process_chunk)
        ct.on_chunk_stage = lambda s: rec.mark(f"chunk {chunk[0]}: {s}")
        ct.on_stage = lambda s: rec.mark(f"chunk {chunk[0]}: keyframe {s}")
        ct.metrics.listeners.append(
            lambda name, opening: name.startswith("loop.") and rec.mark(
                f"chunk {chunk[0]}: {name} {'opens' if opening else 'ends'}"))
        ct.metrics.start()
        t0 = time.perf_counter()
        with rec:
            run_eval.drive_chunked(ct, frames)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        poses = ct.poses_cw()
        m = ct.map
        return dict(rec=rec, poses=poses, kf_pose=m.kf_pose.cpu().numpy(),
                    pt_pos=m.pt_pos.cpu().numpy(),
                    kf_valid=m.kf_valid.cpu().numpy(),
                    pt_valid=m.pt_valid.cpu().numpy(),
                    loops=ct.loops_closed, ate=cs._ate_cw(poses, gt),
                    wall=wall)

    runs = [run(), run()]
    r0, r1 = (r["rec"] for r in runs)
    fp0 = r0.fp[:r0.n].cpu().numpy()
    fp1 = r1.fp[:r1.n].cpu().numpy()
    # fingerprints compare op for op only while both runs launch the same
    # operations
    k = min(r0.n, r1.n)
    name_diffs = [i for i in range(k) if r0.names[i] != r1.names[i]]
    first_name_diff = name_diffs[0] if name_diffs else None
    if first_name_diff is not None:
        k = first_name_diff
    bad = np.nonzero(fp0[:k] != fp1[:k])[0]
    # the first differing op of each call site, in order, with the count of
    # differing ops there (a write to a dropped spare slot differs without
    # consequence; the sites after it say whether anything followed)
    sites = {}
    for i in bad:
        key = (r0.names[i], r0.where[i])
        if key not in sites:
            sites[key] = {"op": int(i), "name": key[0], "where": key[1],
                          "stage": _stage_of(r0.marks, i), "count": 0}
        sites[key]["count"] += 1
    ops = list(sites.values())[:20]
    dpose = np.abs(runs[0]["poses"] - runs[1]["poses"]).max(1) \
        if runs[0]["poses"].shape == runs[1]["poses"].shape else None
    first_frame = (int(np.nonzero(dpose > 0)[0][0])
                   if dpose is not None and (dpose > 0).any() else None)
    report = {
        "root": root, "device": str(dev),
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "input": f"stress circuit, {n} frames, seed {a.seed}"
                 + (" (small)" if a.small else ""),
        "ops_recorded": [r0.n, r1.n], "walls_s": [r["wall"] for r in runs],
        "ate_m": [r["ate"] for r in runs],
        "loops_closed": [r["loops"] for r in runs],
        # the outputs repeat: the same operations launched, the same
        # trajectory and map to the bit (differing op outputs may remain
        # where they have no consequence, such as dropped spare slots)
        "repeats": bool(r0.n == r1.n and first_name_diff is None
                        and runs[0]["loops"] == runs[1]["loops"]
                        and all(np.array_equal(runs[0][k], runs[1][k],
                                               equal_nan=k in ("poses",
                                                               "kf_pose",
                                                               "pt_pos"))
                                for k in ("poses", "kf_pose", "pt_pos",
                                          "kf_valid", "pt_valid"))),
        "ops_differing": int(len(bad)),
        "first_op_name_differs_at": first_name_diff,
        "first_differing_op_per_site": ops,
        "first_frame_pose_differs": first_frame,
        "max_pose_diff": None if dpose is None else float(dpose.max()),
        "kf_pose_max_diff": float(np.abs(runs[0]["kf_pose"]
                                         - runs[1]["kf_pose"]).max()),
        "pt_pos_max_diff": float(np.nanmax(np.abs(runs[0]["pt_pos"]
                                                  - runs[1]["pt_pos"]))),
        "valid_masks_equal": bool(
            np.array_equal(runs[0]["kf_valid"], runs[1]["kf_valid"])
            and np.array_equal(runs[0]["pt_valid"], runs[1]["pt_valid"])),
    }
    text = json.dumps(report, indent=1)
    if out:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
