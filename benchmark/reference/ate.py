"""Absolute trajectory error in plain numpy: camera centres of the
estimated world-to-camera poses, rigidly aligned (Horn, no scale: RGB-D is
metric) to the ground truth's, and the RMSE of what remains."""

from __future__ import annotations

import numpy as np


def quat_to_mat(q):
    """(w, x, y, z) [n, 4] -> rotation matrices [n, 3, 3]."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def ate_rmse(Tcw, T_wc_gt) -> float:
    """Tcw [n, 7] estimated world-to-camera poses (qw qx qy qz tx ty tz),
    T_wc_gt [n, 7] true camera-to-world poses -> ATE RMSE (m) over the
    frames that have a pose (rows of NaN have none); NaN if fewer than
    three have one."""
    Tcw = np.asarray(Tcw, np.float64)
    has = np.isfinite(Tcw).all(-1)
    if has.sum() < 3:
        return float("nan")
    Tcw, T_wc_gt = Tcw[has], np.asarray(T_wc_gt)[has]
    R = quat_to_mat(Tcw[:, :4])
    est = -np.einsum("nji,nj->ni", R, Tcw[:, 4:7])     # -R^T t
    gt = np.asarray(T_wc_gt, np.float64)[:, 4:7]
    mu_e, mu_g = est.mean(0), gt.mean(0)
    H = (est - mu_e).T @ (gt - mu_g)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    Ra = Vt.T @ D @ U.T
    aligned = (est - mu_e) @ Ra.T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, -1))))
