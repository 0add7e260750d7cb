"""Build the bag-of-words vocabulary from a synthetic ORB corpus.

    python -m sgslam_tpu_torch.build_vocab [OUT.npz] [--cpu]

The port's counterpart of `tools/build_vocab.py`: descriptors are harvested
through `slam/tracking.extract_frame` at 320x240 (600 features, 640
keypoints) from eight synthetic scenes (both room layouts, the swept and
the circuit trajectory, texture seeds varied by 0, 11, 23 and 37, +5 for the
closed room), then `models/vocab.train_vocab(branching=10, depth=4,
seed=0)` builds the tree and `save_vocab` writes it in the reference's
layout. The self-check counts distinct words over 4096 descriptors.

Extraction runs on the GPU; `--cpu` runs it on the CPU. The default output
is `build/vocab_torch.npz`; it never writes the packaged
`sgslam_tpu/assets/vocab.npz`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import config, resolve_device
from .io import synthetic
from .models import vocab as vocab_mod
from .slam import tracking

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vary(planes, seed_offset: float):
    return tuple(synthetic.Plane(p.nx, p.ny, p.nz, p.d,
                                 p.tex_seed + seed_offset)
                 for p in planes)


def scenes(frames_per_scene: int):
    """The eight (planes, poses [n, 7] T_wc) scenes of the corpus."""
    out = []
    for off in (0.0, 11.0, 23.0, 37.0):
        out.append((_vary(synthetic.ROOM, off),
                    synthetic.make_trajectory(frames_per_scene)))
        out.append((_vary(synthetic.ROOM_CLOSED, off + 5.0),
                    synthetic.make_circuit_trajectory(frames_per_scene)))
    return out


def harvest(frames_per_scene: int = 16, device="cpu") -> np.ndarray:
    """The corpus: every valid descriptor of every frame, [N, 8] int32."""
    dev = resolve_device(device)
    cfg = config.synthetic_config(
        width=320, height=240,
        orb=config.OrbConfig(n_features=600, max_keypoints=640))
    sc = scenes(frames_per_scene)
    out = []
    for planes, poses in sc:
        seq = synthetic.SyntheticSequence(cfg.camera,
                                          n_frames=frames_per_scene,
                                          planes=planes, poses=poses,
                                          device=dev)
        for i in range(frames_per_scene):
            gray, depth = seq.frame(i)
            feats = tracking.extract_frame(cfg, gray, depth, dev)
            out.append(feats.desc[feats.valid].cpu().numpy())
    descs = np.concatenate(out)
    print(f"harvested {len(descs)} descriptors from {len(sc)} scenes")
    return descs


def main(argv=None):
    ap = argparse.ArgumentParser(description="build the BoW vocabulary")
    ap.add_argument("out", nargs="?",
                    default=os.path.join(ROOT, "build", "vocab_torch.npz"))
    ap.add_argument("--cpu", action="store_true",
                    help="extract on the CPU (default: the GPU)")
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.abspath(vocab_mod.VOCAB_ASSET):
        raise SystemExit("refusing to overwrite the reference's "
                         f"{vocab_mod.VOCAB_ASSET}")
    descs = harvest(device="cpu" if args.cpu else "cuda")
    voc = vocab_mod.train_vocab(descs, branching=10, depth=4, seed=0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    vocab_mod.save_vocab(args.out, voc)
    # self-check: quantization spreads across many words
    n = min(4096, len(descs))
    words = vocab_mod.quantize(voc, torch.from_numpy(descs[:n]),
                               torch.ones(n, dtype=torch.bool)).numpy()
    distinct = len(np.unique(words))
    print(f"saved {args.out} ({os.path.getsize(args.out)} bytes); "
          f"{distinct} distinct words over {n} descriptors")
    return {"descriptors": len(descs), "distinct_words": distinct,
            "quantized": n}


if __name__ == "__main__":
    main()
