"""Trajectory export in TUM and KITTI formats.

The port's own copy of `sgslam_tpu/io/trajectory.py` (System::
SaveTrajectoryTUM / SaveTrajectoryKITTI contract, System.cc:398-548): TUM
lines are `timestamp tx ty tz qx qy qz qw` of the camera-to-world pose;
KITTI lines are the 3x4 row-major camera-to-world matrix. Poses are
inverted in float32 on the CPU, as the reference inverts them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import se3


def _pose_wc(T_cw):
    """[7] world-to-camera pose (numpy or tensor) -> camera-to-world."""
    T = torch.as_tensor(np.asarray(T_cw, dtype=np.float32))
    return se3.se3_inverse(T)


def save_tum(path: str, timestamps, poses_cw):
    """poses_cw: [N,7] world-to-camera (tracking output, Tcw convention)."""
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses_cw):
            qw, qx, qy, qz, tx, ty, tz = _pose_wc(T).numpy()
            f.write(f"{ts:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                    f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")


def save_kitti(path: str, poses_cw):
    with open(path, "w") as f:
        for T in poses_cw:
            m = se3.se3_to_matrix(_pose_wc(T)).numpy()[:3, :4]
            f.write(" ".join(f"{x:.9e}" for x in m.reshape(-1)) + "\n")


def load_tum(path: str):
    """-> (timestamps [N], poses_wc [N,7] wxyz-quat + t)."""
    data = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            data.append([float(x) for x in line.split()][:8])
    arr = np.asarray(data)
    q = np.concatenate([arr[:, 7:8], arr[:, 4:7]], axis=1)
    return arr[:, 0], np.concatenate([q, arr[:, 1:4]], axis=1).astype(np.float32)
