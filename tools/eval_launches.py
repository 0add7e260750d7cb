#!/usr/bin/env python3
"""The port's accuracy suite with K1's and the segment sum's launches
counted per sequence and path.

    python tools/eval_launches.py [run_eval's arguments]

Runs `sgslam_tpu_torch.run_eval.main` with the arguments given (the same
artifact, at `--out`) inside `chip_smoke.launches_per_path`, which sets
both kernels' launch counts to 0 before each path and reads them after it,
then prints one JSON line per sequence: both paths' ATE, keyframes and wall
time beside their K1 and segment-sum launches. Needs the card (the counts
are the CUDA wrappers').
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from sgslam_tpu_torch import run_eval  # noqa: E402
from sgslam_tpu_torch.utils import timing  # noqa: E402


def main(argv=None) -> int:
    with chip_smoke.launches_per_path() as counts:
        res = run_eval.main(argv)
    print(timing.card(0))
    runs = iter(counts)
    for name, row in res["sequences"].items():
        line = {"sequence": name, "pass": row["pass"]}
        for path, k1, seg in (next(runs), next(runs)):
            r = row[path]
            line[path] = {"ate": round(r["ate"], 5),
                          "keyframes": r["keyframes"],
                          "wall_s": r["wall_s"], "k1_launches": k1,
                          "segment_sum_launches": seg,
                          "frames": row["n_frames"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
