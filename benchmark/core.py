"""What a run is, found by name: the cell in `BENCHMARK.json`, its
configuration file, its traffic mix, its limits and the reader of each of
its metrics.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one metric sits in a file of its own under this folder:

    configs/<config>.json     the deployment as it is run (its "file")
    traffic/<mix>.json        the mix's parameters, read by traffic.py
    limits/<cell>.json        the limits of the numbers `correct` compares
    metrics/<metric>.py       read(ctx) -> the metric's value, or None
    runners/<kind>.py         the entry kind a configuration names

so that a new cell, mix or metric is new files and new entries in
`BENCHMARK.json`, and no edit. A runner declares what it hands the
program of each frame (`Runner.views`: ("gray", "depth") for RGB-D,
("gray", "gray_r") for a rectified stereo pair); the harness renders the
right view, `traffic.Frames.gray_r`, only for a runner that declares it
(`runners/__init__.py`).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# top-level module names no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "sgslam_tpu")


class Spec:
    """One cell of a benchmark file: the cell, its configuration entry and
    the files they name. `root` is the repository (the folder that holds
    the benchmark file); `bench` the parsed benchmark file."""

    def __init__(self, bench: dict, cell_name: str, root: Path = REPO):
        cells = {w["name"]: w for w in bench["workloads"]}
        if cell_name not in cells:
            raise KeyError(f"no cell named {cell_name!r}; the cells are "
                           f"{sorted(cells)}")
        self.bench = bench
        self.root = Path(root)
        self.cell = cells[cell_name]
        self.name = cell_name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.cell["config"]]
        self.config = load_json(self.root / self.config_entry["file"])
        self.folder = (self.root / self.config_entry["file"]).parent.parent
        self.traffic = load_json(self.folder / "traffic"
                                 / f"{self.cell['traffic']}.json")
        self.limits = load_json(self.folder / "limits" / f"{cell_name}.json")

    def metric_names(self, trace: bool) -> list[str]:
        """The metrics a run of this cell reports: its end-to-end metrics
        with tracing off, its per-layer metrics with tracing on. A metric
        without a "workloads" key belongs to every cell."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m["name"] for m in group
                if self.name in m.get("workloads", [self.name])]

    def units(self) -> dict:
        return {m["name"]: m["unit"]
                for m in self.bench["end_to_end"] + self.bench["per_layer"]}

    def reader(self, metric: str):
        """The `read(ctx)` of metrics/<metric>.py."""
        path = self.folder / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def runner(self):
        """The module of the entry kind the configuration names."""
        return importlib.import_module(
            f"benchmark.runners.{self.config['runner']['kind']}")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: Path = REPO) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def check_names(bench: dict) -> list[str]:
    """The names and units of a benchmark file that break the contract's
    character rules (empty when all keep them)."""
    bad = []
    names = [c["name"] for c in bench["configs"]]
    names += [w[k] for w in bench["workloads"]
              for k in ("name", "config", "traffic")]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    bad += [n for n in names if not NAME.match(n)]
    bad += [m["unit"] for m in metrics if not UNIT.match(m["unit"])]
    return bad
