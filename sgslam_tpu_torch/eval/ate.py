"""Trajectory evaluation: ATE RMSE after Horn/Umeyama alignment, RPE, and
timestamp association.

The port's own copy of `sgslam_tpu/eval/ate.py`, so that it imports nothing
of the JAX package. RPE composes poses in float32 with the port's SE(3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import se3


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment dst ~= s R src + t.

    Returns (s, R [3,3], t [3]). Closed-form Umeyama 1991.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_wc: np.ndarray, gt_wc: np.ndarray, with_scale: bool = False):
    """Absolute trajectory error after alignment.

    est_wc, gt_wc: [N,7] camera-to-world poses (wxyz quat + t), same indexing.
    Returns (rmse, aligned_est_positions, errors [N]).
    """
    p_est = np.asarray(est_wc)[:, 4:7].astype(np.float64)
    p_gt = np.asarray(gt_wc)[:, 4:7].astype(np.float64)
    s, R, t = umeyama_alignment(p_est, p_gt, with_scale)
    p_al = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_al - p_gt, axis=1)
    return float(np.sqrt((err ** 2).mean())), p_al, err


def rpe(est_wc: np.ndarray, gt_wc: np.ndarray, delta: int = 1):
    """Relative pose error over frame gaps of `delta`.

    Returns (trans_rmse, rot_rmse_rad).
    """
    est = torch.as_tensor(np.asarray(est_wc))
    gt = torch.as_tensor(np.asarray(gt_wc))
    n = len(est) - delta
    terr, rerr = [], []
    for i in range(n):
        # relative motions
        de = se3.se3_compose(se3.se3_inverse(est[i]), est[i + delta])
        dg = se3.se3_compose(se3.se3_inverse(gt[i]), gt[i + delta])
        e = se3.se3_compose(se3.se3_inverse(dg), de).numpy()
        terr.append(np.linalg.norm(e[4:7]))
        rerr.append(np.linalg.norm(se3.so3_log(torch.as_tensor(e[:4]))
                                   .numpy()))
    terr = np.asarray(terr)
    rerr = np.asarray(rerr)
    return float(np.sqrt((terr ** 2).mean())), float(np.sqrt((rerr ** 2).mean()))


def associate_by_time(ts_a: np.ndarray, ts_b: np.ndarray,
                      max_difference: float = 0.02):
    """Index pairs (ia, ib) matching trajectories by nearest timestamp."""
    ia, ib = [], []
    used = set()
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - t)))
        if abs(ts_b[j] - t) <= max_difference and j not in used:
            used.add(j)
            ia.append(i)
            ib.append(j)
    return np.asarray(ia), np.asarray(ib)
