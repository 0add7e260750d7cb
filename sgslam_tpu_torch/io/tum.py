"""TUM RGB-D dataset loading: association files, PNG frames, ground truth.

Own copy of `sgslam_tpu/io/tum.py` for the port (the reference's
`LoadImages` + association handling and the `DepthMapFactor` scaling:
depth PNG / 5000.0 -> meters). Files are read on the host (`io/native`);
frames come out as float32 tensors on the sequence's device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device


@dataclasses.dataclass
class TumAssociation:
    timestamps: np.ndarray          # [N] float64 (rgb timestamps)
    rgb_paths: List[str]
    depth_paths: List[str]


def load_association(path: str) -> TumAssociation:
    """Parse an association file: `t_rgb rgb/... t_depth depth/...` lines."""
    ts, rgbs, depths = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            ts.append(float(parts[0]))
            rgbs.append(parts[1])
            depths.append(parts[3])
    return TumAssociation(np.asarray(ts), rgbs, depths)


def associate(rgb_list: str, depth_list: str,
              max_difference: float = 0.02) -> TumAssociation:
    """Greedy nearest-timestamp association of rgb.txt and depth.txt
    (equivalent of TUM's associate.py, so raw sequences work without it)."""

    def read_list(p):
        out = []
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, path = line.split()[:2]
                out.append((float(t), path))
        return out

    a, b = read_list(rgb_list), read_list(depth_list)
    bt = np.asarray([t for t, _ in b])
    ts, rgbs, depths = [], [], []
    used = set()
    for t, p in a:
        j = int(np.argmin(np.abs(bt - t)))
        if abs(bt[j] - t) <= max_difference and j not in used:
            used.add(j)
            ts.append(t)
            rgbs.append(p)
            depths.append(b[j][1])
    return TumAssociation(np.asarray(ts), rgbs, depths)


class TumSequence:
    """Iterates (gray float32 [H,W] in [0,1], depth float32 meters [H,W]) as
    tensors on `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, root: str, association: Optional[str] = None,
                 depth_factor: float = 5000.0, device="cuda"):
        self.root = root
        self.depth_factor = depth_factor
        self.device = resolve_device(device)
        if association and os.path.exists(association):
            self.assoc = load_association(association)
        else:
            self.assoc = associate(os.path.join(root, "rgb.txt"),
                                   os.path.join(root, "depth.txt"))
        self.timestamps = self.assoc.timestamps

    def __len__(self):
        return len(self.assoc.rgb_paths)

    def _read(self, rel_path: str) -> np.ndarray:
        from . import native

        return native.png_read(os.path.join(self.root, rel_path))

    def _tensor(self, x: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _host_frame(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        rgb = self._read(self.assoc.rgb_paths[i])
        depth_raw = self._read(self.assoc.depth_paths[i])
        if rgb.ndim == 3:
            # ITU-R BT.601 luma, same as cv::cvtColor(BGR2GRAY) up to channel
            # order (the reference converts to grayscale likewise).
            gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                    + 0.114 * rgb[..., 2]) / 255.0
        else:
            gray = rgb / 255.0
        depth = depth_raw.astype(np.float32) / self.depth_factor
        return gray.astype(np.float32), depth

    def frame(self, i: int):
        """(gray, depth) float32 tensors on the sequence's device."""
        gray, depth = self._host_frame(i)
        return self._tensor(gray), self._tensor(depth)

    def rgb(self, i: int):
        """The colour (or gray) image as stored: a uint8 tensor."""
        return self._tensor(self._read(self.assoc.rgb_paths[i]))

    def prefetch(self, n_threads: int = 4, window: int = 8):
        """Decode-ahead iterator over (i, gray, depth, rgb) tensors backed
        by the C++ worker pool (native/dataset.cc); without the library it
        decodes synchronously."""
        from . import native

        if native.available():
            loader = native.NativeTumLoader(
                [os.path.join(self.root, p) for p in self.assoc.rgb_paths],
                [os.path.join(self.root, p) for p in self.assoc.depth_paths],
                depth_factor=self.depth_factor, n_threads=n_threads,
                window=window)
            try:
                for i, gray, depth, rgb in loader:
                    yield (i, self._tensor(gray), self._tensor(depth),
                           self._tensor(rgb))
            finally:
                loader.close()
            return
        for i in range(len(self)):
            gray, depth = self.frame(i)
            yield i, gray, depth, self.rgb(i)


def load_groundtruth(path: str):
    """groundtruth.txt -> (timestamps [N], poses_wc [N,7] (q_wxyz, t)).

    TUM files store `t tx ty tz qx qy qz qw`.
    """
    data = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            if len(v) >= 8:
                data.append(v[:8])
    arr = np.asarray(data)
    ts = arr[:, 0]
    t = arr[:, 1:4]
    qxyzw = arr[:, 4:8]
    q = np.concatenate([qxyzw[:, 3:4], qxyzw[:, 0:3]], axis=1)  # -> wxyz
    poses = np.concatenate([q, t], axis=1).astype(np.float32)
    return ts, poses
