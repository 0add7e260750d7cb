"""Instrument the chunked path's loop closures on the 2-lap stress circuit.

    python -m sgslam_tpu_torch.debug_stress [--cpu] [--quick]
        [--modes base,fullgba,fe3] [--moved 0,1,2]

The port's counterpart of `tools/debug_stress.py`: run_eval's
`static_640_circuit_2laps_stress` sequence (240 frames at 640x480, 80 with
`--quick`) through `ChunkedTracker(chunk=4, loop=LoopCloser)` in three
modes:

  base     production settings (fetch_every=6, the post-loop global BA
           abortable when a keyframe event waits);
  fullgba  every closure runs its full global-BA budget (no abort hook);
  fe3      fetch_every=3 (half the detection lag).

Per closure it records the keyframe pair (`kf_cur`, `kf_loop`), the global-
BA iterations run at the correction (`gba_done`) and left for later
(`gba_remaining`), and the keyframe ATE of the map just before and just
after the correction (`kf_ate_before`, `kf_ate_after`, m); per run, the
ATE, loops, keyframes, lost frames, the keyframe ATE at the end and the wall
time. `--moved` runs each mode again on the sequence with its images moved
by one ulp (`moved_frames`, one run per seed): whether and where a loop
closes on this circuit is chaotic, and the rendered images close none on
the card. Prints one JSON object (mode, or "mode, seed s" -> run) on
stdout. It runs on the GPU; `--cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .run_eval import (_make_cfg, _render, _sequences, _sync, ate_cw,
                       drive_chunked)

SEQUENCE = "static_640_circuit_2laps_stress"


def one_ulp(x, seed):
    """x with every element multiplied by 1 +- 2**-23 (the signs from a
    numpy seed), as tools/parity_spread.py moves the reference's inputs."""
    signs = np.random.default_rng(seed).choice([-1, 1], size=tuple(x.shape))
    f = 1 + torch.as_tensor(signs, device=x.device,
                            dtype=torch.float64) * 2.0 ** -23
    return (x.to(torch.float64) * f).to(x.dtype)


def moved_frames(frames, seed):
    """tools/parity_spread.py's one-ulp move of a sequence: frame i's first
    image by seed 2000 s + i, its second by seed 3000 s + i."""
    return [(one_ulp(g, 2000 * seed + i), one_ulp(d, 3000 * seed + i))
            for i, (g, d) in enumerate(frames)]


def kf_ate(m, gt_wc) -> float:
    """Keyframe ATE (m): each valid keyframe's pose against the ground
    truth of the frame it was made from."""
    v = m.kf_valid
    return ate_cw(m.kf_pose[v].cpu(), gt_wc[m.kf_frame_id[v].cpu().numpy()])


def run(cfg, frames, gt_wc, device, fetch_every=6, full_gba=False):
    """One chunked run with its closures recorded."""
    from .slam import scan_pipeline
    from .slam.loop_closing import LoopCloser

    loop = LoopCloser(cfg, device=device)
    closures = []
    orig_inspect = loop._inspect

    def traced_inspect(m, kf_id, fetch):
        before = kf_ate(m, gt_wc)
        out = orig_inspect(m, kf_id, fetch)
        if out is not None:
            closures.append(dict(
                kf_cur=int(loop.loops_closed[-1][0]),
                kf_loop=int(loop.loops_closed[-1][1]),
                gba_done=int(loop.last_gba_iters),
                gba_remaining=int(loop.gba_remaining),
                kf_ate_before=round(before, 4),
                kf_ate_after=round(kf_ate(out, gt_wc), 4)))
        return out

    loop._inspect = traced_inspect
    ct = scan_pipeline.ChunkedTracker(cfg, chunk=4, fetch_every=fetch_every,
                                      loop=loop, device=device)
    if full_gba:
        ct.loop.should_abort_gba = None
    t0 = time.perf_counter()
    drive_chunked(ct, frames)
    _sync(device)
    wall = time.perf_counter() - t0
    return dict(ate=round(ate_cw(ct.poses_cw(), gt_wc), 4),
                loops=ct.loops_closed, closures=closures, kf=ct.n_kf,
                lost=int(ct.lost_mask().sum()),
                kf_ate=round(kf_ate(ct.map, gt_wc), 4), wall=round(wall, 1))


def main(argv=None):
    ap = argparse.ArgumentParser(description="per-closure instrumentation "
                                 "of the chunked stress run")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--modes", default="base,fullgba,fe3")
    ap.add_argument("--moved", default="",
                    help="seeds of one-ulp image moves to run as well")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = _make_cfg(False)
    spec = _sequences(args.quick, dev)[SEQUENCE]
    seq, frames = _render(cfg, spec, dev)
    gt_wc = seq.poses.cpu().numpy()
    settings = {"base": {}, "fullgba": {"full_gba": True},
                "fe3": {"fetch_every": 3}}
    inputs = [("", frames)] + [
        (f", seed {s}", moved_frames(frames, int(s)))
        for s in args.moved.split(",") if s]
    res = {}
    for mode in args.modes.split(","):
        for label, fr in inputs:
            res[mode + label] = run(cfg, fr, gt_wc, dev, **settings[mode])
            print(mode + label, json.dumps(res[mode + label]),
                  file=sys.stderr, flush=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
