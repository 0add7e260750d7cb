"""Stage-level profile of the chunked semantic pipeline on the card.

    python -m sgslam_tpu_torch.profile_chunk [--reps 10] [--cpu]

Port of `tools/profile_chunk.py`. It times each stage of the 640x480,
1000-feature semantic pipeline alone, so that throughput work targets
measured cost:

  chunk4_full_kf_allowed      one chunk of 4 frames as the runner calls it
                              (keyframes allowed);
  chunk4_no_kf                the same chunk with keyframe flags
                              suppressed (`n_live=0`): tracking only;
  extract4                    ORB extraction of the chunk's 4 frames;
  chunk4_no_kf_no_det_no_sem  the chunk without the detector and the
                              dynamic cull (`make_track_chunk(cfg, None,
                              semantic=False)`), `n_live=0`;
  track_step_1                one `track_step` on the warmed map;
  insert_and_maintain         one keyframe insertion and the LocalMapping
                              pass (`scan_pipeline.insert_and_maintain_body`);
  local_ba_step               the local BA at the production window.

The map comes from a warm-up: 76 frames of the walking-person scene
(rendered on the card) through `ChunkedSemanticTracker(chunk=4,
fetch_every=6)`, then a flush. Each row runs once untimed, then `--reps`
times on inputs made before its timing starts, moved per rep as the
reference moves them (grays by 1e-4 x rep, keypoints by 1e-3 px x rep,
points by 1e-5 m x rep), and reports the median in ms. On the card each
call is timed between CUDA events; these functions read the host (the
keyframe flag, the BA's exit flags), so the time includes the host's share
and graph capture does not apply. On the CPU (`--cpu`) the host clock
times each call.

Every rep is given the same map and carry: no chunk function, insertion
or BA writes into the map it is given (each update builds new tensors,
`slam/scan_pipeline.py`), which this tool checks at the end, and a rep
never feeds on a carry (nor its F-RANSAC key) that an earlier rep moved.

Output: one line per row on stderr, then one JSON line with the card's
name and power limit, the map's size and the medians in ms. Without a
card and without `--cpu` it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from . import config
from .utils import timing

CHUNK = 4
N_WARM = 76
FETCH_EVERY = 6


def make_config():
    return config.synthetic_config(width=640, height=480)


def _snapshot(m):
    return {f.name: getattr(m, f.name).clone()
            for f in dataclasses.fields(m)
            if isinstance(getattr(m, f.name), torch.Tensor)}


def _unchanged(m, snap) -> bool:
    return all(torch.equal(getattr(m, k), v) for k, v in snap.items())


def profile(device, cfg=None, reps: int = 10, n_warm: int = N_WARM) -> dict:
    """The rows' medians in ms, with the warmed map's size."""
    from .io import synthetic
    from .models.detector import Detector2D
    from .slam import scan_pipeline, tracking

    cfg = cfg or make_config()
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=n_warm + CHUNK,
                                      dynamic=True, device=device)
    frames = [seq.frame(i) for i in range(n_warm + CHUNK)]
    ct = scan_pipeline.ChunkedSemanticTracker(
        cfg, Detector2D(cfg.detector, device=device), chunk=CHUNK,
        fetch_every=FETCH_EVERY, device=device)
    i = 0
    while ct._carry is None and i < 8:
        ct.bootstrap(*frames[i])
        i += 1
    if ct._carry is None:
        raise AssertionError("profile_chunk: the tracker failed to "
                             "initialize")
    while i + CHUNK <= n_warm:
        ct.process_chunk(torch.stack([frames[j][0]
                                      for j in range(i, i + CHUNK)]),
                         torch.stack([frames[j][1]
                                      for j in range(i, i + CHUNK)]))
        i += CHUNK
    ct.flush()
    m, carry = ct._map, ct._carry
    g4 = torch.stack([frames[j][0] for j in range(i, i + CHUNK)])
    d4 = torch.stack([frames[j][1] for j in range(i, i + CHUNK)])
    feats = tracking.extract_frame(cfg, frames[i][0], frames[i][1], device)
    snap = _snapshot(m)
    timing.sync(device)
    res = {"map": {"keyframes": int(m.kf_valid.sum()),
                   "points": int(m.pt_valid.sum())}, "ms": {}}
    print(f"profile_chunk: map {res['map']['keyframes']} keyframes, "
          f"{res['map']['points']} points", file=sys.stderr, flush=True)

    def row(name, fn, args):
        ms = timing.event_ms(fn, reps, warmup=1, device=device, args=args)
        res["ms"][name] = ms
        print(f"{name}: {ms:.2f} ms", file=sys.stderr, flush=True)

    def chunk_args(r):
        return m, carry, g4 + 1e-4 * r, d4

    def moved_feats(r):
        return dataclasses.replace(feats, xy=feats.xy + 1e-3 * r)

    fn = ct._fn
    row("chunk4_full_kf_allowed",
        lambda mm, c, g, d: fn(mm, c, g, d, CHUNK), chunk_args)
    row("chunk4_no_kf", lambda mm, c, g, d: fn(mm, c, g, d, 0), chunk_args)
    row("extract4", lambda g, d: [tracking.extract_frame(
        cfg, g[j], d[j], device) for j in range(CHUNK)],
        lambda r: (g4 + 1e-4 * r, d4))
    fn_nodet = scan_pipeline.make_track_chunk(cfg, None, semantic=False,
                                              device=device)
    row("chunk4_no_kf_no_det_no_sem",
        lambda mm, c, g, d: fn_nodet(mm, c, g, d, 0), chunk_args)
    row("track_step_1", lambda f, T: tracking.track_step(
        cfg, m, f, T, device), lambda r: (moved_feats(r), carry.Tcw))
    unmatched = torch.full((feats.capacity,), -1, dtype=torch.int32,
                           device=device)
    row("insert_and_maintain",
        lambda f, T: scan_pipeline.insert_and_maintain_body(
            cfg, m, f, T, 999, unmatched),
        lambda r: (moved_feats(r), carry.Tcw))
    center = int(m.next_kf) - 1
    row("local_ba_step", lambda mm: tracking.local_ba_step(cfg, mm, center),
        lambda r: (dataclasses.replace(m, pt_pos=m.pt_pos + 1e-5 * r),))
    if not _unchanged(m, snap):
        raise AssertionError("profile_chunk: a stage wrote into the map it "
                             "was given, so later reps saw another map")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    a = ap.parse_args(argv)
    dev = timing.measurement_device(a.cpu, "profile_chunk")
    res = profile(dev, make_config(), a.reps, N_WARM)
    print(json.dumps({"device": timing.card(dev), "reps": a.reps,
                      "chunk": CHUNK, "warm_frames": N_WARM, **res}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
