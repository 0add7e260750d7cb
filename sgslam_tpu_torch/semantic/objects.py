"""Semantic object database: class-aware nearest-centroid fusion registry.

Port of `sgslam_tpu/semantic/objects.py` (ObjectDatabase contract): a
detection merges into the nearest object of its class within a per-class
radius (bottle 0.2 m, chair 1.0 m, tvmonitor 0.5 m, others 0.6 m), by
running means of centroid, size and probability; otherwise it takes the
next free slot. One update is a handful of tensor ops with no host read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# per-class association radius (meters); VOC ids; default 0.6
CLASS_RADIUS = np.full(21, 0.6, np.float32)
CLASS_RADIUS[5] = 0.2    # bottle
CLASS_RADIUS[9] = 1.0    # chair
CLASS_RADIUS[20] = 0.5   # tvmonitor


@dataclasses.dataclass
class ObjectDB:
    centroid: torch.Tensor   # [O,3]
    size: torch.Tensor       # [O,3]
    prob: torch.Tensor       # [O]
    cls: torch.Tensor        # [O] i32
    count: torch.Tensor      # [O] i32 fused detections
    valid: torch.Tensor      # [O] bool
    next_id: torch.Tensor    # [] i32

    @staticmethod
    def empty(capacity: int = 256, device="cpu") -> "ObjectDB":
        return ObjectDB(
            centroid=torch.zeros((capacity, 3), device=device),
            size=torch.zeros((capacity, 3), device=device),
            prob=torch.zeros(capacity, device=device),
            cls=torch.full((capacity,), -1, dtype=torch.int32, device=device),
            count=torch.zeros(capacity, dtype=torch.int32, device=device),
            valid=torch.zeros(capacity, dtype=torch.bool, device=device),
            next_id=torch.zeros((), dtype=torch.int32, device=device))


def _set(x, slot, value):
    return x.index_copy(0, slot, value[None].to(x.dtype))


def _get(x, j):
    return x.index_select(0, j)[0]


def add_object(db: ObjectDB, centroid, size, prob, cls) -> ObjectDB:
    """Insert-or-fuse one semantic object (addObject contract)."""
    cap = db.centroid.shape[0]
    dev = db.centroid.device
    cls = torch.as_tensor(cls, device=dev).to(torch.int32)
    prob = torch.as_tensor(prob, device=dev).to(torch.float32)
    same = db.valid & (db.cls == cls)
    d = torch.linalg.vector_norm(db.centroid - centroid[None], dim=-1)
    d = torch.where(same, d, torch.inf)
    # [1] indices throughout: indexing with a 0-dim tensor is a host read
    j = torch.argmin(d).reshape(1)
    radius = _get(torch.from_numpy(CLASS_RADIUS).to(dev),
                  torch.clamp(cls, 0, 20).reshape(1).to(torch.int64))
    merge = _get(d, j) < radius

    cnt = _get(db.count, j).to(torch.float32)
    new_centroid = (_get(db.centroid, j) * cnt + centroid) / (cnt + 1.0)
    new_size = (_get(db.size, j) * cnt + size) / (cnt + 1.0)
    new_prob = (_get(db.prob, j) * cnt + prob) / (cnt + 1.0)

    k = torch.clamp(db.next_id, max=cap - 1).to(torch.int64).reshape(1)
    slot = torch.where(merge, j, k)
    return ObjectDB(
        centroid=_set(db.centroid, slot,
                      torch.where(merge, new_centroid, centroid)),
        size=_set(db.size, slot, torch.where(merge, new_size, size)),
        prob=_set(db.prob, slot, torch.where(merge, new_prob, prob)),
        cls=_set(db.cls, slot, cls),
        count=_set(db.count, slot, _get(db.count, slot) + 1),
        valid=_set(db.valid, slot, torch.ones((), dtype=torch.bool,
                                              device=dev)),
        next_id=torch.where(merge, db.next_id,
                            torch.clamp(db.next_id + 1, max=cap)))
