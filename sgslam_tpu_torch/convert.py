"""Carry state across from the JAX package: its pytrees, given as dicts of
numpy arrays, to the port's tensors and back.

SLAM carries a map, not weights, so this plays the role of weight loading:
one map built by either package can be fed to both. Descriptors are
bit-cast between the reference's uint32 words and the port's int32; every
other array keeps its dtype. The one set of weights, the detector's, maps
from the flax parameter tree (or its `.npz`) to an `SSDLite` state dict.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mapstate.local_map import LocalPoints
from .mapstate.mapstate import MapState
from .ops.orb import Features
from .optim.local_ba import BAProblem
from .semantic.dynamic import Boxes

_DESC_FIELDS = {"desc", "kf_feat_desc", "pt_desc"}


def _to_tensor(name, x, device):
    x = np.array(x, order="C")          # a writable copy; keeps 0-d shapes
    if name in _DESC_FIELDS:
        x = x.view(np.int32) if x.dtype == np.uint32 else x.astype(np.int32)
    return torch.as_tensor(x, device=device)


def _to_numpy(name, t):
    x = t.detach().cpu().numpy()
    return x.view(np.uint32) if name in _DESC_FIELDS else x


def _from_numpy(cls, arrays: dict, device):
    return cls(**{f.name: _to_tensor(f.name, arrays[f.name], device)
                  for f in dataclasses.fields(cls)})


def _as_numpy(obj) -> dict:
    return {f.name: _to_numpy(f.name, getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def features_from_numpy(arrays: dict, device="cpu") -> Features:
    return _from_numpy(Features, arrays, device)


def features_to_numpy(feats: Features) -> dict:
    return _as_numpy(feats)


def map_from_numpy(arrays: dict, device="cpu") -> MapState:
    return _from_numpy(MapState, arrays, device)


def map_to_numpy(m: MapState) -> dict:
    return _as_numpy(m)


def local_points_to_numpy(local: LocalPoints) -> dict:
    return _as_numpy(local)


def ba_problem_from_numpy(arrays: dict, device="cpu") -> BAProblem:
    return _from_numpy(BAProblem, arrays, device)


def ba_problem_to_numpy(prob: BAProblem) -> dict:
    return _as_numpy(prob)


def boxes_from_numpy(arrays: dict, device="cpu") -> Boxes:
    return _from_numpy(Boxes, arrays, device)


def boxes_to_numpy(boxes: Boxes) -> dict:
    return _as_numpy(boxes)


def _flax_key(key) -> str:
    """'params/DWBlock_0/Conv_1/kernel' or its tuple form, without the
    leading 'params'."""
    parts = key.split("/") if isinstance(key, str) else list(key)
    return "/".join(parts[1:] if parts[0] == "params" else parts)


# flax module names of SSDLite -> the port's; DWBlock_i/{Conv,GroupNorm}_j
# -> blocks.i.{conv,gn}j
_SSD_MODULES = {"Conv_0": "stem", "GroupNorm_0": "stem_gn",
                "Conv_1": "box16", "Conv_2": "cls16",
                "Conv_3": "box32", "Conv_4": "cls32"}


def detector_params_from_numpy(flat: dict) -> dict:
    """Flax-flattened SSDLite parameters (the `detector.npz` keys, or
    `flatten_dict` tuples) -> an `SSDLite` state dict of float32 tensors.
    Kernels go from HWIO to OIHW; a depthwise kernel (3, 3, 1, C) becomes
    (C, 1, 3, 3); GroupNorm `scale` is torch's `weight`."""
    out = {}
    for key, val in flat.items():
        path = _flax_key(key).split("/")
        if path[0].startswith("DWBlock_"):
            blk = path[0].split("_")[1]
            kind, j = path[1].split("_")
            module = f"blocks.{blk}.{'conv' if kind == 'Conv' else 'gn'}{j}"
        else:
            module = _SSD_MODULES[path[0]]
        x = np.array(val, np.float32)
        name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[path[-1]]
        if path[-1] == "kernel":
            x = x.transpose(3, 2, 0, 1)
        out[f"{module}.{name}"] = torch.from_numpy(np.ascontiguousarray(x))
    return out


def detector_params_to_numpy(state: dict) -> dict:
    """The inverse of `detector_params_from_numpy`: an `SSDLite` state dict
    -> the flax-flattened `detector.npz` keys ('params/DWBlock_0/Conv_1/
    kernel', ...) as float32 numpy arrays; kernels from OIHW back to HWIO."""
    modules = {v: k for k, v in _SSD_MODULES.items()}
    out = {}
    for key, val in state.items():
        module, name = key.rsplit(".", 1)
        if module.startswith("blocks."):
            _, blk, layer = module.split(".")
            kind = "Conv" if layer.startswith("conv") else "GroupNorm"
            path = f"DWBlock_{blk}/{kind}_{layer[-1]}"
        else:
            path = modules[module]
        x = val.detach().cpu().numpy().astype(np.float32)
        if name == "weight" and x.ndim == 4:
            leaf, x = "kernel", x.transpose(2, 3, 1, 0)
        else:
            leaf = {"weight": "scale", "bias": "bias"}[name]
        out[f"params/{path}/{leaf}"] = np.ascontiguousarray(x)
    return out


# ---------------------------------------------------------------------------
# Loop closing and the chunked pipeline
# ---------------------------------------------------------------------------

def vocab_from_numpy(level_desc, word_idf, device="cpu"):
    """The reference's `Vocabulary` fields (uint32 level arrays, idf) -> the
    port's `Vocabulary`."""
    from .models.vocab import _from_arrays

    return _from_arrays([np.asarray(d) for d in level_desc],
                        np.asarray(word_idf), device)


def vocab_to_numpy(vocab) -> dict:
    return {"level_desc": [d.cpu().numpy().view(np.uint32)
                           for d in vocab.level_desc],
            "word_idf": vocab.word_idf.cpu().numpy()}


def loop_state_to_numpy(loop) -> dict:
    """A `LoopCloser`'s database and bookkeeping (either package's) as
    numpy arrays and plain Python values."""
    return {"bow_db": np.asarray(_np(loop.bow_db)),
            "db_valid": np.asarray(_np(loop.db_valid)),
            "loop_edges": [(int(i), int(j), np.asarray(_np(s), np.float32))
                           for i, j, s in loop.loop_edges],
            "_consistency": {int(k): int(v)
                             for k, v in loop._consistency.items()},
            "loops_closed": [(int(i), int(j)) for i, j in loop.loops_closed]}


def loop_state_from_numpy(loop, state: dict):
    """Install `loop_state_to_numpy`'s output into the port's `LoopCloser`."""
    loop.bow_db = torch.as_tensor(np.array(state["bow_db"], np.float32),
                                  device=loop.device)
    loop.db_valid = torch.as_tensor(np.array(state["db_valid"], bool),
                                    device=loop.device)
    loop.loop_edges = [(i, j, np.asarray(s, np.float32))
                       for i, j, s in state["loop_edges"]]
    loop._consistency = dict(state["_consistency"])
    loop.loops_closed = list(state["loops_closed"])
    return loop


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def sim3_from_numpy(table, device="cpu") -> torch.Tensor:
    """A Sim(3) table [..., 8] (qw, qx, qy, qz, tx, ty, tz, s) as float32."""
    return torch.as_tensor(np.array(table, np.float32), device=device)


def track_carry_from_numpy(arrays: dict, device="cpu", key=None):
    """The reference's `TrackCarry` (fields as numpy; `prev_feats` and
    `prev_boxes` as dicts) -> the port's. The PRNG key is opaque to the
    port: `key` replaces it (for example with a test's replaying key), else
    the reference's key array is kept as it is."""
    from .slam.scan_pipeline import TrackCarry

    i32 = dict(dtype=torch.int32, device=device)
    return TrackCarry(
        Tcw=sim3_from_numpy(arrays["Tcw"], device),
        velocity=sim3_from_numpy(arrays["velocity"], device),
        since_kf=torch.as_tensor(np.asarray(arrays["since_kf"]), **i32),
        ref_matches=torch.as_tensor(np.asarray(arrays["ref_matches"]),
                                    **i32),
        frame_id=int(np.asarray(arrays["frame_id"])),
        prev_feats=features_from_numpy(arrays["prev_feats"], device),
        prev_boxes=boxes_from_numpy(arrays["prev_boxes"], device),
        key=arrays["key"] if key is None else key)
