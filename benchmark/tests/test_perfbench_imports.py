"""No module of benchmark/ loads JAX or the JAX package, and the
reference loads nothing of the program; top-level names compared whole
(`sgslam_tpu_torch` begins with `sgslam_tpu`)."""

import json
import subprocess
import sys

from benchmark import core

FORBIDDEN = ("jax", "jaxlib", "flax", "sgslam_tpu")


def _loaded(code: str) -> list[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=core.REPO, capture_output=True, text=True, check=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(core.REPO)})
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_top_level_names_are_compared_whole():
    assert core.forbidden_modules(["sgslam_tpu_torch", "sgslam_tpu_torch.x",
                                   "jaxtyping", "flaxen"]) == []
    assert core.forbidden_modules(["jax.numpy", "sgslam_tpu.ops"]) == [
        "jax.numpy", "sgslam_tpu.ops"]


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    mods = sorted(p.relative_to(core.REPO).with_suffix("")
                  for p in core.HERE.rglob("*.py")
                  if "tests" not in p.parts and p.parent.name != "metrics")
    names = {".".join(m.parts) for m in mods}
    assert {"benchmark.reference.stereo",
            "benchmark.runners.chunked_stereo"} <= names
    imports = "\n".join(f"import {'.'.join(m.parts)}" for m in mods)
    readers = ("from benchmark import core\n"
               "spec = core.Spec(core.load_bench(), 'chunked.slow_walker')\n"
               "[spec.reader(m['name']) for m in spec.bench['end_to_end'] + "
               "spec.bench['per_layer']]\n"
               "[core.Spec(spec.bench, w['name']).runner() "
               "for w in spec.bench['workloads']]")
    loaded = _loaded(imports + "\n" + readers)
    assert not set(loaded) & set(FORBIDDEN), loaded


def test_the_reference_loads_nothing_of_the_program():
    mods = sorted(p.stem for p in (core.HERE / "reference").glob("*.py")
                  if p.stem != "__init__")
    assert {"orb", "stereo"} <= set(mods)
    loaded = _loaded("\n".join(f"import benchmark.reference.{m}"
                               for m in mods))
    assert "sgslam_tpu_torch" not in loaded
    assert not set(loaded) & set(FORBIDDEN), loaded
