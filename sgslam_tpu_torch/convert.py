"""Carry state across from the JAX package: its pytrees, given as dicts of
numpy arrays, to the port's tensors and back.

SLAM carries a map, not weights, so this plays the role of weight loading:
one map built by either package can be fed to both. Descriptors are
bit-cast between the reference's uint32 words and the port's int32; every
other array keeps its dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mapstate.local_map import LocalPoints
from .mapstate.mapstate import MapState
from .ops.orb import Features
from .optim.local_ba import BAProblem

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
