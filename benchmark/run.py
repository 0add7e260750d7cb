"""The benchmark's command: one run of one cell on one H100.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

It loads the cell's configuration and traffic by name (`core.py`), renders
the frames from the seed into host memory, builds and warms the program
(`sgslam_tpu_torch`), measures for `--seconds`, checks what the window
produced against the plain reference, and prints as its last line one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), `device`, with
`--trace 1` a `breakdown`, and last `checks`, each compared number with
its limit. An earlier line gives the window's counts (frames, keyframes,
loops closed, relocalizations, lost frames). The compared numbers are
also the last lines of standard error.

Without a card, or with fewer cards than the cell asks for, it exits
non-zero and prints no result. Build and kernel caches go to fixed
folders under `build/` in the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE = Path(__file__).resolve().parent.parent / "build" / "bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from . import core

    spec = core.Spec(core.load_bench(), a.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell {a.workload} needs {chips} CUDA "
              "device(s); none or fewer are available", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(f"benchmark: {card()}", file=sys.stderr, flush=True)
    from . import harness

    result, lines, extra = harness.run(spec, a.seed, a.seconds,
                                       bool(a.trace),
                                       torch.device("cuda", 0), T0)
    print(json.dumps(extra["window"]), flush=True)
    print(json.dumps(result), flush=True)
    for ln in lines:
        print(ln, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
