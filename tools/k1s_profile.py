#!/usr/bin/env python3
"""Time the fused Hamming search K1s on the card beside its plain chain
and K1.

    python tools/k1s_profile.py [--calls 50]

For each call site's shape (tracking 4096x1024 with a window, the cull
1024x1024, triangulation 1024x1024 mutual, 640x640 at 320x240, the eval
map's 4096x2176; and 16x128, one block, the cost of a launch) the device
time of one call and the grid's column splits (`WAVES` blocks per SM,
where the columns allow it), by CUDA-graph replay, on seeded inputs
(`ops/search_cases.py`), checked to the bit against the plain version
first; the bound of what the input
needs (`search_bound` with its candidate count) and the dense one (every
pair's distance). One JSON line per shape, with the card's name and power
limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sgslam_tpu_torch.ops import hamming_cuda as hc  # noqa: E402
from sgslam_tpu_torch.ops import hamming_search as hs  # noqa: E402
from sgslam_tpu_torch.ops.search_cases import (search_args,  # noqa: E402
                                                search_case)
from sgslam_tpu_torch.utils import timing  # noqa: E402

SHAPES = [(4096, 1024, 1, False), (1024, 1024, 1, False),
          (1024, 1024, None, True), (640, 640, 1, False),
          (4096, 2176, 1, False), (16, 128, 1, False)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=50)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1s_profile: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = timing.card(dev)
    rng = np.random.default_rng(3)
    for q, n, lw, mutual in SHAPES:
        args = search_args(search_case(rng, q, n, edge=False), dev, lw)
        want = hs.hamming_search_reference(*args, mutual=mutual)
        row = {"q": q, "n": n, "level_window": lw, "mutual": mutual,
               "device": card}
        kern = hs.hamming_search_kernel
        got = kern(*args, mutual=mutual)
        if not all(w is None or torch.equal(g, w)
                   for g, w in zip(got, want)):
            raise AssertionError(f"K1s differs at {q}x{n}")
        row["ms"] = timing.graph_ms(lambda: kern(*args, mutual=mutual),
                                    calls=a.calls)
        row["splits"] = kern.splits(dev, q, n)
        row["chain_ms"] = timing.graph_ms(
            lambda: hs.hamming_search_reference(*args, mutual=mutual),
            calls=5)
        row["k1_ms"] = timing.graph_ms(
            lambda: hc.hamming_kernel(args[0], args[2]), calls=a.calls)
        n_cand = (int(hs.candidates(args[1], args[3], args[4]).sum())
                  if lw is not None else None)
        row["candidates"] = n_cand
        row["bound_ms"] = hs.search_bound(q, n, mutual, lw is not None,
                                          n_cand)[0]
        row["dense_bound_ms"] = hs.search_bound(q, n, mutual,
                                                lw is not None)[0]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
