"""The scene renderer that the traffic generator draws frames with:
ray casting against the textured planes of a room and walking person
capsules on fronto-parallel planes, with exact depth.

Frozen copy of the renderer of `sgslam_tpu_torch/io/synthetic.py` as of
commit 1275b16, with the per-frame functions made to render a batch of
frames at once (the same per-pixel arithmetic). It imports nothing of the
program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .reference import se3
from .reference.camera import undistort_points


def _cell_hash(ix, iy, seed):
    """Deterministic pseudo-random value in [0,1) per integer cell."""
    # fma(ix, 127.1, iy * 311.7) in float32, emulated exactly in float64
    arg = (ix.double() * float(np.float32(127.1))
           + (iy * 311.7).double()).float() + seed * 74.7
    h = torch.sin(arg.double()).float() * 43758.5453
    return h - torch.floor(h)


def texture(x, y, seed: float = 0.0):
    """Multi-scale random-checker texture in [0,1]; sharp cell edges."""
    v = 0.0
    for k, cell in enumerate((0.40, 0.17, 0.07)):
        ix = torch.floor(x / cell)
        iy = torch.floor(y / cell)
        v = v + _cell_hash(ix, iy, seed + k) * (0.5 ** k)
    v = v / (1.0 + 0.5 + 0.25)
    # contrast stretch: strong cell-edge steps -> rich FAST response
    return torch.clamp(1.8 * (v - 0.5) + 0.5, 0.0, 1.0)


def _ray_grid(cam: Camera, device):
    """Per-pixel unit-z ray directions in the camera frame [H,W,3]; with a
    distorted camera, the rays of the undistorted pixel coordinates."""
    H, W = cam.height, cam.width
    uu = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    vv = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    if cam.has_distortion():
        uv = undistort_points(cam, torch.stack([uu, vv], dim=-1))
        uu, vv = uv[..., 0], uv[..., 1]
    dx = (uu - cam.cx) / cam.fx
    dy = (vv - cam.cy) / cam.fy
    return torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)


@dataclasses.dataclass(frozen=True)
class Plane:
    """n . x = d, textured by (x,y) coords in an in-plane basis."""

    nx: float
    ny: float
    nz: float
    d: float
    tex_seed: float


def _plane_basis(n):
    """Two in-plane axes for texture coordinates (float32 numpy)."""
    n = np.asarray(n, np.float32)
    a = (np.array([1.0, 0.0, 0.0], np.float32) if abs(n[0]) < 0.9
         else np.array([0.0, 1.0, 0.0], np.float32))
    u = np.cross(n, a)
    u = u / np.linalg.norm(u)
    v = np.cross(n, u)
    return u.astype(np.float32), v.astype(np.float32)


def _world_rays(cam: Camera, T_wc):
    """(camera centres [B,3], world ray directions [B,H,W,3]) of poses
    T_wc [B,7]."""
    d_w = se3.quat_rotate(T_wc[:, None, None, :4],
                          _ray_grid(cam, T_wc.device)[None])
    return T_wc[:, 4:7], d_w


def _render_planes(cam: Camera, o, d_w, planes):
    dev = d_w.device
    B, H, W = d_w.shape[0], cam.height, cam.width
    best_t = torch.full((B, H, W), math.inf, device=dev)
    best_col = torch.zeros((B, H, W), device=dev)
    for pl in planes:
        n_np = np.array([pl.nx, pl.ny, pl.nz], np.float32)
        n = torch.as_tensor(n_np, device=dev)
        denom = torch.einsum("bhwc,c->bhw", d_w, n)
        t = (pl.d - (o @ n)[:, None, None]) / torch.where(
            torch.abs(denom) < 1e-6, math.inf, denom)
        hit = t > 0.05
        p = o[:, None, None, :] + t[..., None] * d_w
        u_ax, v_ax = (torch.as_tensor(x, device=dev) for x in _plane_basis(n_np))
        col = texture(torch.einsum("bhwc,c->bhw", p, u_ax),
                      torch.einsum("bhwc,c->bhw", p, v_ax), pl.tex_seed)
        closer = hit & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_col = torch.where(closer, col, best_col)
    return best_t, best_col


def _f32(x, device):
    """A float32 tensor on `device` from a tensor or an array."""
    x = x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=torch.float32)


def _finish(best_t, best_col):
    depth = torch.where(torch.isfinite(best_t), best_t, 0.0)
    return best_col.to(torch.float32), depth.to(torch.float32)


def person_texture(px, py, seed):
    """High-contrast two-scale stripe texture, distinct from the walls'
    random checker, with rich FAST response."""
    a = torch.sin(18.0 * py + 7.1 * seed) * torch.sin(11.0 * px + 2.3 * seed)
    b = torch.sin(41.0 * (px + py) + 3.7 * seed)
    return torch.clamp(0.15 + 0.55 * (a > 0) + 0.25 * (b > 0), 0.0, 1.0)


def _person_mask(px, py, cx, cy, half_h):
    """Capsule silhouette in the person's plane; y points DOWN."""
    w = 0.40 * half_h
    body = (((px - cx) / w) ** 2
            + ((py - (cy + 0.28 * half_h)) / (0.72 * half_h)) ** 2) < 1.0
    hr = 0.30 * half_h
    head = ((px - cx) ** 2 + (py - (cy - 0.70 * half_h)) ** 2) < hr ** 2
    return body | head


def _fronto_parallel_hits(o, d_w, cz):
    """Ray parameters and hit points [B,H,W,3] on the world planes
    z = cz [B]."""
    n = torch.tensor([0.0, 0.0, -1.0], device=d_w.device)
    denom = torch.einsum("bhwc,c->bhw", d_w, n)
    t = ((-cz - o @ n)[:, None, None]
         / torch.where(torch.abs(denom) < 1e-6, math.inf, denom))
    return t, o[:, None, None, :] + t[..., None] * d_w


def _composite_people(o, d_w, people, best_t, best_col):
    """Ray-cast `people` [B,P,5] = (cx, cy, cz, half_h, seed) into the
    scene, each on its fronto-parallel world plane z = cz. half_h <= 0
    disables a row."""
    for i in range(people.shape[1]):
        cx, cy, cz, half_h, seed = people[:, i].unbind(-1)
        t, p = _fronto_parallel_hits(o, d_w, cz)
        cx, cy, half_h, seed = (v[:, None, None]
                                for v in (cx, cy, half_h, seed))
        inside = (_person_mask(p[..., 0], p[..., 1], cx, cy, half_h)
                  & (t > 0.05) & (half_h > 0))
        col = person_texture(p[..., 0] - cx, p[..., 1] - cy, seed)
        closer = inside & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_col = torch.where(closer, col, best_col)
    return best_t, best_col


def render_frames(cam, T_wc, people, planes):
    """Room planes + person capsules for a batch of frames: poses T_wc
    [B,7], people [B,P,5] (P may be 0) -> (gray [B,H,W] in [0,1], depth
    [B,H,W] in meters, 0 = invalid)."""
    o, d_w = _world_rays(cam, T_wc)
    best_t, best_col = _render_planes(cam, o, d_w, planes)
    people = _f32(people, o.device)
    if people.shape[1]:
        best_t, best_col = _composite_people(o, d_w, people, best_t, best_col)
    return _finish(best_t, best_col)
