"""Seeded inputs of motion-only BA for the pose kernel's checks.

`pose_case(rng, n, mix)` draws one `pose_optimization` input as numpy
arrays: n points in front of a 640x480 camera, their observations at the
true pose with pixel noise scaled by pyramid level, a share of gross
outliers, stereo (u_right = u - bf / z) or mono (u_right = -1) rows, a
validity mask, and a start pose 2 cm and ~0.6 degrees off the truth, as
`track_step`'s stage 1 sees one. `pose_args(case, device)` gives the
tensors in `pose_optimization`'s order, `chi2(case, T)` each row's chi2
and gate at a pose. Used by `tests/test_torch_pose_opt_cuda.py` and
`chip_smoke.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import synthetic_config
from ..geometry import se3
from ..optim.pose_opt import CHI2_MONO, CHI2_STEREO

MIXES = ("stereo", "mono", "mixed", "invalid")
SCALE_FACTOR = 1.2
OUTLIERS = 0.1          # share of rows moved by up to 40 px
VALID = 0.9             # share of valid rows


def camera():
    """The tracking configuration's 640x480 camera."""
    return synthetic_config(640, 480).camera


def pose_case(rng, n: int, mix: str = "mixed") -> dict:
    """One motion-only BA input. mix: "stereo" (every row has u_right),
    "mono" (none), "mixed" (points nearer than 3 m), "invalid" (as mixed,
    every row invalid)."""
    if mix not in MIXES:
        raise ValueError(f"mix must be one of {MIXES}, got {mix!r}")
    cam = camera()
    xi_true = np.concatenate([rng.normal(0.0, 0.3, 3),
                              rng.normal(0.0, 0.2, 3)]).astype(np.float32)
    T_true = se3.se3_exp(torch.from_numpy(xi_true))
    z = rng.uniform(0.5, 6.0, n)
    px = rng.uniform(0.0, cam.width, n)
    py = rng.uniform(0.0, cam.height, n)
    pc = np.stack([(px - cam.cx) / cam.fx * z, (py - cam.cy) / cam.fy * z,
                   z], -1).astype(np.float32)
    pw = se3.se3_apply(se3.se3_inverse(T_true)[None],
                       torch.from_numpy(pc)).numpy()
    level = rng.integers(0, 8, n)
    sigma = SCALE_FACTOR ** level
    u = cam.fx * pc[:, 0] / z + cam.cx + rng.normal(0.0, 1.0, n) * sigma
    v = cam.fy * pc[:, 1] / z + cam.cy + rng.normal(0.0, 1.0, n) * sigma
    ur = u - cam.bf / z + rng.normal(0.0, 0.5, n) * sigma
    bad = rng.random(n) < OUTLIERS
    u = np.where(bad, u + rng.uniform(-40.0, 40.0, n), u)
    v = np.where(bad, v + rng.uniform(-40.0, 40.0, n), v)
    stereo = {"stereo": np.ones(n, bool), "mono": np.zeros(n, bool)}.get(
        mix, z < 3.0)
    ur = np.where(stereo, np.maximum(ur, 0.0), -1.0)
    valid = (rng.random(n) < VALID) & (mix != "invalid")
    off = np.array([0.02, 0.0, 0.0, 0.0, 0.01, 0.0], np.float32)
    T0 = se3.se3_compose(se3.se3_exp(torch.from_numpy(off)), T_true)
    return {"Tcw0": T0.numpy(), "pw": pw.astype(np.float32),
            "obs": np.stack([u, v, ur], -1).astype(np.float32),
            "inv_sigma2": (sigma ** -2.0).astype(np.float32),
            "valid": valid}


def pose_args(case: dict, device) -> tuple:
    """(Tcw0, pw, obs, inv_sigma2, valid) on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(case[k])).to(device)
                 for k in ("Tcw0", "pw", "obs", "inv_sigma2", "valid"))


def chi2(case: dict, T) -> tuple:
    """(chi2 [N], gate [N]) of the case's rows at pose T, in float64."""
    cam = camera()
    T = torch.as_tensor(T).detach().cpu().double()
    pc = se3.se3_apply(T[None], torch.from_numpy(case["pw"]).double()).numpy()
    z = np.maximum(pc[:, 2], 1e-6)
    u = cam.fx * pc[:, 0] / z + cam.cx
    v = cam.fy * pc[:, 1] / z + cam.cy
    obs = case["obs"]
    stereo = obs[:, 2] >= 0
    r = np.stack([u - obs[:, 0], v - obs[:, 1],
                  np.where(stereo, u - cam.bf / z - obs[:, 2], 0.0)], -1)
    gate = np.where(stereo, CHI2_STEREO, CHI2_MONO)
    return (r * r).sum(-1) * case["inv_sigma2"], gate
