#!/usr/bin/env python3
"""Run named phases of chip_smoke.py from a checkout, on the card.

    python tools/chip_phases.py [--root DIR] [--segments] PHASE [PHASE ...]

PHASE names a `phase_<PHASE>(dev)` function of the chip_smoke.py found in
`--root` (default: this checkout), for example `eval_map` (phase 5, the
back-end pass on the eval map), `semantic_system` (phase 7, whose mapping
stage runs the occupancy and point-cloud sums) or `forced_loop` (phase
11b, the loop corrections). The kernels are built first (`phase_build`),
TF32 is off as in chip_smoke.py, and each phase's wall time is printed
with the card's name and power limit. `--segments` records every segment
sum of the phases and ends with chip_smoke.py's segment phase (lengths per
site, the kernel held to the bit against its plain version, times). With
`--root` pointing at another commit unpacked under build/, two versions
run in one call on one card, in turns.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--segments", action="store_true",
                    help="record every segment sum of the phases and hold "
                    "the kernel against its plain version at the end, as "
                    "chip_smoke.py does")
    ap.add_argument("phases", nargs="+")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    os.chdir(root)

    import torch

    import chip_smoke as cs
    from sgslam_tpu_torch.utils import timing

    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"[chip_phases] {root} on {timing.card(0)}")
    cs.phase_build()
    if a.segments:
        from sgslam_tpu_torch.ops import segment

        rec = cs.SegmentInputs(segment.segment_kernel)
        segment.segment_kernel = rec
    for name in a.phases:
        fn = getattr(cs, f"phase_{name}")
        args = [dev]
        if "kernels" in inspect.signature(fn).parameters:
            args.append({"hamming_matrix": {}, "hamming_search": {},
                         "pose_opt": {}, "fast_detect": {}})
        if a.segments:
            rec.phase = name
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        print(f"[chip_phases] phase {name}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    if a.segments:
        rec.phase = "-"
        print(json.dumps(cs.phase_segment(dev, rec, rec.kernel.launches)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
