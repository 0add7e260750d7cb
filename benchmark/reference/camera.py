"""Pinhole camera: `sgslam_tpu_torch/geometry/camera.py`.

Frozen copy of the files named above as of commit 1275b16, with
their imports pointed at this folder. It imports nothing of the
program.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole intrinsics + radtan distortion + RGB-D pseudo-stereo baseline."""

    fx: float
    fy: float
    cx: float
    cy: float
    # radial-tangential distortion (k1, k2, p1, p2, k3)
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    # bf = fx * baseline (meters); RGB-D pseudo-stereo (Frame.cc:893-914)
    bf: float = 40.0
    width: int = 640
    height: int = 480

    @property
    def baseline(self):
        return self.bf / self.fx

    def has_distortion(self) -> bool:
        return any(abs(k) > 0 for k in (self.k1, self.k2, self.p1, self.p2, self.k3))


def project(cam: Camera, pc):
    """Camera-frame points [..., 3] -> pixel coords [..., 2] (no distortion)."""
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: Camera, pc):
    """[..., 3] -> (u, v, u_right) for the RGB-D pseudo-stereo residual."""
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    ur = u - cam.bf / z
    return torch.stack([u, v, ur], dim=-1)


def backproject(cam: Camera, uv, z):
    """Pixels [..., 2] + depth [...] -> camera-frame points [..., 3]."""
    x = (uv[..., 0] - cam.cx) * z / cam.fx
    y = (uv[..., 1] - cam.cy) * z / cam.fy
    return torch.stack([x, y, z], dim=-1)


def distort_normalized(cam: Camera, xy):
    """Apply radtan distortion to normalized coords [..., 2]."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: Camera, uv, iters: int = 8):
    """Undistort pixel coords [..., 2] by `iters` fixed-point iterations
    (the reference's static iteration count, Frame.cc:654-684)."""
    if not cam.has_distortion():
        return uv
    xd = (uv[..., 0] - cam.cx) / cam.fx
    yd = (uv[..., 1] - cam.cy) / cam.fy
    d = torch.stack([xd, yd], dim=-1)
    x = d
    for _ in range(iters):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * xx * yy + cam.p2 * (r2 + 2.0 * xx * xx)
        dy = cam.p1 * (r2 + 2.0 * yy * yy) + 2.0 * cam.p2 * xx * yy
        x = (d - torch.stack([dx, dy], dim=-1)) / radial[..., None]
    u = x[..., 0] * cam.fx + cam.cx
    v = x[..., 1] * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1)


def in_image(cam: Camera, uv, margin: float = 0.0):
    """Boolean mask of pixels inside the (undistorted) image bounds."""
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < cam.width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < cam.height - margin)
    )


def intrinsic_matrix(cam: Camera, dtype=torch.float32, device=None):
    return torch.tensor(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
        dtype=dtype, device=device)
