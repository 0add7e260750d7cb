"""The build, load and launch protocol that the five hand-written CUDA
kernels' bindings share (`ops/cuda_lib.py`), on the CPU: a kernel whose
library cannot be built raises and stays unloaded and uncounted; a built
library is found again by its name; `load` declares every entry point as
its source defines it and runs the binding's own check; `launch` passes
the stream, enters another card only where it must, counts a launch that
returns 0 and raises, counting nothing, on any other return. No JAX here.

The kernels themselves run only on a card: each has its `cuda` tests.
"""

import ctypes
import hashlib
import re
import types
from pathlib import Path

import pytest
import torch

from sgslam_tpu_torch.ops import (cuda_lib, fast_cuda, hamming_cuda,
                                  hamming_search, pose_opt_cuda, segment)

BINDINGS = {"K1": hamming_cuda.HammingKernel,
            "K1s": hamming_search.HammingSearchKernel,
            "S": segment.SegmentSumKernel,
            "P": pose_opt_cuda.PoseOptKernel,
            "F": fast_cuda.FastDetectKernel}
ENTRIES = [(kind, entry) for kind, cls in BINDINGS.items()
           for entry in cls.entries]
C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "int64_t": ctypes.c_int64}


class FakeLib:
    """Stands in for an opened library: each entry point a Python stub
    returning 0, but the queries that S's and K1s's checks make, which
    answer as their sources do."""

    def __init__(self, **values):
        self.values = {"sgslam_segment_sum_long": segment.LONG,
                       "sgslam_segment_sum_block": segment.BLOCK,
                       "sgslam_hamming_search_rows": 64,
                       "sgslam_hamming_search_cols": 128, **values}

    def __getattr__(self, name):
        def fn(*args):
            return self.values.get(name, 0)
        setattr(self, name, fn)
        return fn


def _open_fake(monkeypatch, lib):
    """Route `load` to `lib` without nvcc; returns the list of builds."""
    built = []

    def build(source, flags=(), verbose=False):
        built.append((source, flags))
        return Path("libfake.so")

    monkeypatch.setattr(cuda_lib, "build_library", build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: lib)
    return built


@pytest.mark.parametrize("kind", list(BINDINGS))
def test_unbuildable_kernel_raises(monkeypatch, kind):
    def no_nvcc(*a, **k):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_lib, "build_library", no_nvcc)
    kernel = BINDINGS[kind]()
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel.load()
    assert kernel.launches == 0 and kernel.fns is None


def test_built_library_is_found_by_its_name(monkeypatch, tmp_path):
    """The library's name is `libsgslam_<stem>_<tag>.so`, the tag the first
    12 hex digits of sha256(source + the flags joined by spaces): one that
    exists is returned and nvcc is not looked for."""
    kernel = pose_opt_cuda.PoseOptKernel()
    flags = " ".join((*cuda_lib.NVCC_FLAGS, *kernel.flags)).encode()
    tag = hashlib.sha256(kernel.source.read_bytes() + flags).hexdigest()
    lib = tmp_path / f"libsgslam_pose_opt_{tag[:12]}.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(cuda_lib, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: pytest.fail(
        "looked for nvcc"))
    assert kernel.build() == lib


@pytest.mark.parametrize("kind", list(BINDINGS))
def test_load_declares_every_entry_point_once(monkeypatch, kind):
    built = _open_fake(monkeypatch, FakeLib())
    kernel = BINDINGS[kind]()
    fns = kernel.load()
    assert built == [(kernel.source, kernel.flags)]
    assert set(fns) == set(kernel.entries)
    for entry, fn in fns.items():
        assert fn.argtypes == [*kernel.entries[entry], ctypes.c_void_p]
        assert fn.restype is ctypes.c_int
    assert kernel.load() is fns and len(built) == 1
    assert kernel.launches == 0


@pytest.mark.parametrize("kind,entry", ENTRIES)
def test_entry_points_match_their_sources(kind, entry):
    """Each declared entry point is an `extern "C" int` function of the
    binding's source taking the declared arguments, then the stream."""
    src = BINDINGS[kind].source.read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, f"{entry} not in {BINDINGS[kind].source.name}"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    assert params[-1] == "void* stream"
    got = [ctypes.c_void_p if "*" in p
           else C_TYPES[p.replace("const ", "").rsplit(" ", 1)[0]]
           for p in params[:-1]]
    assert got == BINDINGS[kind].entries[entry]


def test_segment_sum_refuses_another_order(monkeypatch):
    _open_fake(monkeypatch, FakeLib(sgslam_segment_sum_long=128))
    kernel = segment.SegmentSumKernel()
    with pytest.raises(RuntimeError, match="another order"):
        kernel.load()
    assert kernel.fns is None


def _stub_cards(monkeypatch, current):
    """Card `current` is the current one; returns the cards entered."""
    entered = []

    class Enter:
        def __init__(self, i):
            entered.append(i)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", Enter)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda i: (
        types.SimpleNamespace(cuda_stream=0x5000 + i)))
    return entered


class StubKernel(cuda_lib.CudaKernel):
    name = "stub kernel"
    source = cuda_lib.CSRC / "hamming.cu"


@pytest.mark.parametrize("current,entered", [(1, []), (0, [1])],
                         ids=["current_card", "other_card"])
def test_launch_counts_a_return_of_zero(monkeypatch, current, entered):
    calls = []
    kernel = StubKernel()
    kernel.fns = {"stub": lambda *args: calls.append(args) or 0}
    cards = _stub_cards(monkeypatch, current)
    kernel.launch("stub", torch.device("cuda", 1), 7, None)
    assert calls == [(7, None, 0x5001)]
    assert cards == entered and kernel.launches == 1


def test_launch_raises_on_an_error_and_counts_none(monkeypatch):
    kernel = StubKernel()
    kernel.fns = {"stub": lambda *args: 700}
    _stub_cards(monkeypatch, 0)
    with pytest.raises(RuntimeError,
                       match="stub kernel launch failed: CUDA error 700"):
        kernel.launch("stub", torch.device("cuda", 0), 7)
    assert kernel.launches == 0
