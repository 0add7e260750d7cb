"""The control of `correct`: on the card, at the cell's own size, the
reference computed with TF32 put in the program's place, beside the
program's own readings, for several seeds in one process.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3
                                 [--seconds 6]

Each seed is a whole run (set-up, a short window, the check); one JSON
line per seed gives the window's counts, the program's readings
(`program`: program against the reference) and the control's
(`control`: the TF32 reference against the reference). The limits in
`limits/<cell>.json` lie between the largest program reading and the
smallest control reading (PERF.md gives both). Without a card it exits
non-zero.
"""

import argparse
import json
import sys
import time

from . import run as _run  # noqa: F401  (sets the cache folders)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    a = ap.parse_args(argv)

    import torch

    from . import core, harness

    if not torch.cuda.is_available():
        print("benchmark.control: needs a CUDA device", file=sys.stderr)
        return 2
    spec = core.Spec(core.load_bench(), a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        _, _, extra = harness.run(spec, seed, a.seconds, False,
                                  torch.device("cuda", 0),
                                  time.perf_counter(), control=True)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "window": extra["window"],
                          "program": extra["program"],
                          "control": extra["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
