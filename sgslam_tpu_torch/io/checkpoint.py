"""Map checkpoint / resume.

The port's own copy of `sgslam_tpu/io/checkpoint.py`, with the same `.npz`
layout: one `map__<field>` array per `MapState` field and one
`extra__<key>` array per auxiliary entry. Descriptors are stored as the
reference's uint32 words and bit-cast to the port's int32 on load
(`convert.py`), so either package reads a map the other wrote.
"""

from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..convert import map_from_numpy, map_to_numpy
from ..mapstate.mapstate import MapState


def save_map(path: str, m: MapState, extra: dict | None = None):
    arrays = {f"map__{k}": v for k, v in map_to_numpy(m).items()}
    for k, v in (extra or {}).items():
        arrays[f"extra__{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_map(path: str, device="cuda"):
    """Returns (MapState on `device`, extra dict of numpy arrays)."""
    dev = resolve_device(device)
    with np.load(path) as data:
        arrays = {k[5:]: data[k] for k in data.files if k.startswith("map__")}
        extra = {k[7:]: data[k] for k in data.files
                 if k.startswith("extra__")}
    return map_from_numpy(arrays, dev), extra
