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
