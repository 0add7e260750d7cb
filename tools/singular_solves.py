#!/usr/bin/env python3
"""How often the port's LU solves hit an exactly zero pivot on the card.

    python tools/singular_solves.py [--reps 2]

Runs chip_smoke.py's loop-closing phases (11: the 2-lap stress circuit
through `System` and the chunked runner, as rendered and moved by one ulp;
12: the forced loops) `--reps` times on the GPU, with
`geometry.linalg.solve` wrapped so that every call reports its factorization
status. Prints, per call site, the number of solves, and for each solve with
a zero pivot its shape, whether its inputs were finite and its diagonal's
range. A phase that fails is reported and the run goes on. The wrapper
reads the status back to the host, so the phases' times mean nothing here.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sgslam_tpu_torch.geometry import linalg  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("singular_solves: needs a GPU", file=sys.stderr)
        return 1

    calls, events = collections.Counter(), collections.Counter()

    def solve(A, b):
        x, info = torch.linalg.solve_ex(A, b)
        f = sys._getframe(1)
        site = f"{os.path.basename(f.f_code.co_filename)}:{f.f_code.co_name}"
        calls[site] += 1
        if bool((info != 0).any()):
            d = torch.diagonal(A, dim1=-2, dim2=-1)
            key = (site, tuple(A.shape), bool(torch.isfinite(A).all()),
                   bool(torch.isfinite(b).all()))
            events[key] += 1
            print(f"zero pivot at {site}: shape {tuple(A.shape)}, pivot "
                  f"{int(info.max())}, A finite {key[2]}, b finite "
                  f"{key[3]}, diagonal {float(d.min()):.6g} .. "
                  f"{float(d.max()):.6g}", flush=True)
        return x

    linalg.solve = solve
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    chip_smoke.phase_build()
    t0 = time.perf_counter()
    fails = []
    for rep in range(args.reps):
        for name, fn in (("loop", chip_smoke.phase_loop_closing),
                         ("forced", chip_smoke.phase_forced_loop)):
            try:
                fn(dev)
            except Exception as e:  # noqa: BLE001 - counted, not hidden
                fails.append((rep, name, repr(e)[:300]))
                print(f"phase {name} (rep {rep}) failed: {e!r}"[:400],
                      flush=True)
        print(f"rep {rep} done at {time.perf_counter() - t0:.1f} s",
              flush=True)
    print("solves per call site:", dict(calls))
    print("zero-pivot solves:", dict(events))
    print("failed phases:", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
