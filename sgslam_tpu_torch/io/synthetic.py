"""Procedural synthetic RGB-D sequence renderer with exact ground truth.

Port of `sgslam_tpu/io/synthetic.py` (every function): per-pixel
ray casting against the textured planes of a room, walking person capsules
and semantic props on fronto-parallel planes, and the camera walks. Frames
come out on the sequence's device, so a GPU run needs no JAX and no
host-side rendering.

`_cell_hash` multiplies a float32 `sin` of arguments up to ~2e4 by 43758,
so one ulp of the argument (0.002 there) changes a cell's value entirely.
The port therefore rounds the argument as XLA compiles the reference (the
`ix` product fused with the `iy` term in one multiply-add) and takes `sin`
in float64; what remains are last-ulp differences of `sin`, ~4e-3 in the
texture (tests/test_torch_synthetic.py). The person and prop textures
threshold `sin` of arguments up to ~100, so pixels whose argument sits
within an ulp of a zero crossing may flip between the packages
(tests/test_torch_synthetic_dynamic.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import resolve_device
from ..geometry import se3
from ..geometry.camera import Camera, undistort_points


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


# A simple "room": back wall, floor, left wall.
ROOM = (
    Plane(0.0, 0.0, -1.0, -3.5, 1.0),   # back wall at z=3.5 (facing camera)
    Plane(0.0, -1.0, 0.0, -1.0, 2.0),   # floor at y=+1.0 (camera y points down)
    Plane(1.0, 0.0, 0.0, -2.0, 3.0),    # left wall at x=-2.0
)

# A fully closed box (all four walls + floor + ceiling): the camera can spin
# a full circuit and always sees textured geometry.
ROOM_CLOSED = (
    Plane(0.0, 0.0, -1.0, -3.5, 1.0),   # back wall   z = +3.5
    Plane(0.0, 0.0, 1.0, -3.5, 4.0),    # front wall  z = -3.5
    Plane(1.0, 0.0, 0.0, -2.5, 3.0),    # left wall   x = -2.5
    Plane(-1.0, 0.0, 0.0, -2.5, 5.0),   # right wall  x = +2.5
    Plane(0.0, -1.0, 0.0, -1.0, 2.0),   # floor       y = +1.0
    Plane(0.0, 1.0, 0.0, -1.5, 6.0),    # ceiling     y = -1.5
)


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
    """(camera center [3], world ray directions [H,W,3]) of pose T_wc."""
    d_w = se3.quat_rotate(T_wc[None, None, :4], _ray_grid(cam, T_wc.device))
    return T_wc[4:7], d_w


def _render_planes(cam: Camera, o, d_w, planes):
    dev = d_w.device
    H, W = cam.height, cam.width
    best_t = torch.full((H, W), math.inf, device=dev)
    best_col = torch.zeros((H, W), device=dev)
    for pl in planes:
        n_np = np.array([pl.nx, pl.ny, pl.nz], np.float32)
        n = torch.as_tensor(n_np, device=dev)
        denom = torch.einsum("hwc,c->hw", d_w, n)
        t = (pl.d - torch.dot(n, o)) / torch.where(
            torch.abs(denom) < 1e-6, math.inf, denom)
        hit = t > 0.05
        p = o[None, None, :] + t[..., None] * d_w
        u_ax, v_ax = (torch.as_tensor(x, device=dev) for x in _plane_basis(n_np))
        col = texture(torch.einsum("hwc,c->hw", p, u_ax),
                      torch.einsum("hwc,c->hw", p, v_ax), pl.tex_seed)
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


def render_frame(cam: Camera, T_wc, obj_center=None, obj_half: float = 0.35,
                 planes=ROOM, obj_depth_ofs: float = 1.2):
    """Render one RGB-D frame on T_wc's device.

    T_wc: [7] camera-to-world pose. obj_center: optional [3] world position
    of a walking person capsule (half height 1.3 * obj_half); None disables
    it. `obj_depth_ofs` is unused, as in the reference. Returns gray [H,W]
    float32 in [0,1] and depth [H,W] float32 meters (0 = invalid).
    """
    o, d_w = _world_rays(cam, T_wc)
    best_t, best_col = _render_planes(cam, o, d_w, planes)
    if obj_center is not None:
        c = torch.as_tensor(obj_center, dtype=torch.float32, device=o.device)
        extra = torch.tensor([obj_half * 1.3, 9.0], dtype=torch.float32,
                             device=o.device)
        best_t, best_col = _composite_people(
            o, d_w, torch.cat([c, extra])[None, :], best_t, best_col)
    return _finish(best_t, best_col)


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
    """Ray parameter and hit points [H,W,3] on the world plane z = cz."""
    n = torch.tensor([0.0, 0.0, -1.0], device=d_w.device)
    denom = torch.einsum("hwc,c->hw", d_w, n)
    t = (-cz - torch.dot(n, o)) / torch.where(torch.abs(denom) < 1e-6,
                                              math.inf, denom)
    return t, o[None, None, :] + t[..., None] * d_w


def _composite_people(o, d_w, people, best_t, best_col):
    """Ray-cast `people` [P,5] = (cx, cy, cz, half_h, seed) into the scene,
    each on its fronto-parallel world plane z = cz. half_h <= 0 disables a
    row."""
    for i in range(people.shape[0]):
        cx, cy, cz, half_h, seed = people[i].unbind()
        t, p = _fronto_parallel_hits(o, d_w, cz)
        inside = (_person_mask(p[..., 0], p[..., 1], cx, cy, half_h)
                  & (t > 0.05) & (half_h > 0))
        col = person_texture(p[..., 0] - cx, p[..., 1] - cy, seed)
        closer = inside & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_col = torch.where(closer, col, best_col)
    return best_t, best_col


# ---------------------------------------------------------------------------
# Static semantic props: textured rectangles on fronto-parallel world planes,
# the non-person VOC objects that feed 3-D semantic mapping
# ---------------------------------------------------------------------------

PROP_BICYCLE = 2
PROP_BOTTLE = 5
PROP_BUS = 6
PROP_CAR = 7
PROP_CHAIR = 9
PROP_TABLE = 11
PROP_PLANT = 16
PROP_SOFA = 18
PROP_TRAIN = 19
PROP_TV = 20
PROP_CLASSES = (PROP_BICYCLE, PROP_BOTTLE, PROP_BUS, PROP_CAR, PROP_CHAIR,
                PROP_TABLE, PROP_PLANT, PROP_SOFA, PROP_TRAIN, PROP_TV)


def prop_texture(px, py, cls, seed):
    """Per-class texture in normalized in-prop coords px, py in [-1, 1]."""
    sin = torch.sin
    # chair: coarse checker grid
    grid = 0.25 + 0.6 * ((sin(14.0 * px + seed) > 0.3)
                         ^ (sin(14.0 * py + seed) > 0.3))
    # tvmonitor: bright frame + dark faintly-patterned screen
    screen = torch.where((torch.abs(px) > 0.8) | (torch.abs(py) > 0.8), 0.9,
                         0.12 + 0.1 * sin(30.0 * px * py + seed))
    # bottle: fine vertical stripes
    stripes_v = 0.2 + 0.65 * (sin(60.0 * px + 3.0 * seed) > 0.0)
    # sofa: wide horizontal bands + soft seam lines
    sofa = (0.35 + 0.35 * (sin(4.5 * py + seed) > 0.0)
            + 0.15 * (sin(22.0 * py) > 0.9))
    # pottedplant: dense irregular speckle
    sp = sin(37.0 * px + seed) * sin(41.0 * py + 2.0 * seed) \
        + sin(53.0 * (px + py))
    plant = 0.15 + 0.6 * (sp > 0.4)
    # diningtable: diagonal stripes
    table = 0.25 + 0.55 * (sin(18.0 * (px + py) + seed) > 0.0)
    # car: dark lower body + bright window band + wheel-dark corners
    wheels = (((px - 0.6) ** 2 + (py - 0.75) ** 2 < 0.06)
              | ((px + 0.6) ** 2 + (py - 0.75) ** 2 < 0.06))
    car = torch.where(wheels, 0.05,
                      torch.where(py < -0.1, 0.85 + 0.1 * sin(9.0 * px), 0.3))
    # bicycle: thin diagonal crosshatch
    bike = 0.2 + 0.65 * ((sin(34.0 * (px + py) + seed) > 0.85)
                         | (sin(34.0 * (px - py) + seed) > 0.85))
    # bus: bright body with a row of dark window squares up top
    win = (sin(16.0 * px) > 0.2) & (py > -0.6) & (py < -0.1)
    bus = torch.where(win, 0.12, 0.8 + 0.08 * sin(5.0 * py + seed))
    # train: long horizontal stripe pairs + repeated door slots
    door = sin(9.0 * px + seed) > 0.93
    train = torch.where(door, 0.1, 0.3 + 0.5 * (sin(11.0 * py + seed) > 0.4))

    choices = [(PROP_CHAIR, grid), (PROP_TV, screen),
               (PROP_BOTTLE, stripes_v), (PROP_SOFA, sofa),
               (PROP_PLANT, plant), (PROP_TABLE, table), (PROP_CAR, car),
               (PROP_BICYCLE, bike), (PROP_BUS, bus), (PROP_TRAIN, train)]
    t = stripes_v                       # jnp.select: the first match wins
    for c, tex in reversed(choices):
        t = torch.where(cls == c, tex, t)
    return torch.clamp(t, 0.0, 1.0)


def _composite_props(o, d_w, props, best_t, best_col):
    """Ray-cast `props` [Q,7] = (cx, cy, cz, half_w, half_h, cls, seed)
    rectangles on world planes z = cz. half_h <= 0 disables a row."""
    for i in range(props.shape[0]):
        cx, cy, cz, half_w, half_h, cls, seed = props[i].unbind()
        t, p = _fronto_parallel_hits(o, d_w, cz)
        px = (p[..., 0] - cx) / torch.clamp(half_w, min=1e-6)
        py = (p[..., 1] - cy) / torch.clamp(half_h, min=1e-6)
        inside = ((torch.abs(px) < 1.0) & (torch.abs(py) < 1.0)
                  & (t > 0.05) & (half_h > 0))
        col = prop_texture(px, py, cls.to(torch.int32), seed)
        closer = inside & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_col = torch.where(closer, col, best_col)
    return best_t, best_col


def _gt_box(cam: Camera, T_cw, corners, present):
    pc = se3.se3_apply(T_cw[None], corners)
    z_ok = torch.all(pc[:, 2] > 0.05) & present
    u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
    v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
    x1 = torch.clamp(torch.min(u), 0, cam.width - 1)
    y1 = torch.clamp(torch.min(v), 0, cam.height - 1)
    x2 = torch.clamp(torch.max(u), 0, cam.width - 1)
    y2 = torch.clamp(torch.max(v), 0, cam.height - 1)
    visible = z_ok & (x2 - x1 > 2) & (y2 - y1 > 2)
    return torch.stack([x1, y1, x2, y2]), visible


def prop_gt_box(cam: Camera, T_cw, prop):
    """Ground-truth pixel box (x1, y1, x2, y2) of a prop rectangle + a
    visibility flag. prop: [7] = (cx, cy, cz, half_w, half_h, cls, seed)."""
    cx, cy, cz, hw, hh = prop[:5].unbind()
    corners = torch.stack([
        torch.stack([cx - hw, cy - hh, cz]),
        torch.stack([cx + hw, cy - hh, cz]),
        torch.stack([cx - hw, cy + hh, cz]),
        torch.stack([cx + hw, cy + hh, cz])])
    return _gt_box(cam, T_cw, corners, prop[4] > 0)


def person_gt_box(cam: Camera, T_cw, person):
    """Ground-truth pixel box (x1, y1, x2, y2) of a person capsule, plus a
    visibility flag. T_cw: world->camera pose [7]."""
    cx, cy, cz, half_h = person[:4].unbind()
    w = 0.40 * half_h
    corners = torch.stack([
        torch.stack([cx - w, cy - half_h, cz]),
        torch.stack([cx + w, cy - half_h, cz]),
        torch.stack([cx - w, cy + half_h, cz]),
        torch.stack([cx + w, cy + half_h, cz])])
    return _gt_box(cam, T_cw, corners, half_h > 0)


# three default props along the back wall (world coords; y points down,
# floor at y=+1)
DEFAULT_PROPS = np.array([
    [-0.85, 0.55, 3.30, 0.35, 0.42, PROP_CHAIR, 11.0],
    [0.95, -0.25, 3.35, 0.45, 0.30, PROP_TV, 23.0],
    [0.10, 0.70, 2.90, 0.08, 0.24, PROP_BOTTLE, 37.0],
], np.float32)


def render_frame_people(cam: Camera, T_wc, people, planes=ROOM):
    """Render with person capsules ([P,5] rows of (cx, cy, cz, half_h,
    tex_seed); half_h <= 0 disables). Returns (gray, depth)."""
    return render_frame_scene(cam, T_wc, people,
                              torch.zeros((0, 7), device=T_wc.device),
                              planes=planes)


def render_frame_scene(cam: Camera, T_wc, people, props, planes=ROOM):
    """Full scene renderer: room planes + person capsules [P,5] + prop
    rectangles [Q,7]. Either may be a zero-row tensor."""
    o, d_w = _world_rays(cam, T_wc)
    best_t, best_col = _render_planes(cam, o, d_w, planes)
    people = _f32(people, o.device)
    props = _f32(props, o.device)
    if props.shape[0]:
        best_t, best_col = _composite_props(o, d_w, props, best_t, best_col)
    if people.shape[0]:
        best_t, best_col = _composite_people(o, d_w, people, best_t, best_col)
    return _finish(best_t, best_col)


def make_trajectory(n_frames: int, device="cpu"):
    """Smooth sinusoidal camera walk (T_wc per frame), [N,7]."""
    s = torch.linspace(0.0, 1.0, n_frames, dtype=torch.float32, device=device)
    tx = 0.6 * torch.sin(2 * math.pi * s)
    ty = 0.15 * torch.sin(4 * math.pi * s + 1.0)
    tz = 0.3 * torch.sin(2 * math.pi * s + 0.5)
    wy = 0.10 * torch.sin(2 * math.pi * s)        # yaw
    wx = 0.05 * torch.sin(4 * math.pi * s + 0.3)  # pitch
    xi = torch.stack([tx, ty, tz, wx, wy, torch.zeros_like(s)], dim=-1)
    return se3.se3_exp(xi)


def object_track(n_frames: int, device="cpu"):
    """World path [N,3] of the single dynamic person: strafes left-right
    close to the camera."""
    s = torch.linspace(0.0, 1.0, n_frames, dtype=torch.float32, device=device)
    cx = 0.9 * torch.sin(2 * math.pi * s * 1.5)
    return torch.stack([cx, torch.full_like(s, 0.15), torch.full_like(s, 2.0)],
                       dim=-1)


def walker_tracks(n_frames: int, n_walkers: int = 3, depth0: float = 1.8,
                  half_h: float = 0.55, device="cpu"):
    """World paths of several independent walkers, [N, P, 5] people rows
    (cx, cy, cz, half_h, tex_seed): each strafes on its own phase, speed
    and depth band, with a slight depth oscillation."""
    s = torch.linspace(0.0, 1.0, n_frames, dtype=torch.float32, device=device)
    rows = []
    for p in range(n_walkers):
        speed = 1.2 + 0.5 * p
        phase = 2.4 * p
        cx = (0.55 + 0.35 * (p % 2)) * torch.sin(
            2 * math.pi * s * speed + phase)
        cy = 0.15 + 0.05 * torch.sin(2 * math.pi * s * 0.7 + p)
        cz = (depth0 + 0.5 * p) + 0.25 * torch.sin(
            2 * math.pi * s * 0.9 + 1.3 * p)
        rows.append(torch.stack(
            [cx, cy, cz, torch.full_like(s, half_h * 1.3),
             torch.full_like(s, 9.0 + 4.0 * p)], dim=-1))
    return torch.stack(rows, dim=1)                  # [N, P, 5]


def make_walk_trajectory(n_frames: int, yaw_amp: float = 0.35, device="cpu"):
    """Sinusoidal walk with fast rotation: peak yaw rate ~2 deg/frame at
    30 FPS, on top of the translation sweep of make_trajectory."""
    s = torch.linspace(0.0, 1.0, n_frames, dtype=torch.float32, device=device)
    tx = 0.6 * torch.sin(2 * math.pi * s)
    ty = 0.15 * torch.sin(4 * math.pi * s + 1.0)
    tz = 0.3 * torch.sin(2 * math.pi * s + 0.5)
    wy = yaw_amp * torch.sin(3 * math.pi * s)
    wx = 0.08 * torch.sin(4 * math.pi * s + 0.3)
    xi = torch.stack([tx, ty, tz, wx, wy, torch.zeros_like(s)], dim=-1)
    return se3.se3_exp(xi)


def person_coverage(cam: Camera, T_wc, people, planes=ROOM) -> float:
    """Fraction of the image covered by person capsules at one frame
    (compares scene depth with and without people)."""
    _, d0 = render_frame(cam, T_wc, planes=planes)
    _, d1 = render_frame_people(cam, T_wc, people, planes=planes)
    return float(torch.mean((torch.abs(d1 - d0) > 1e-4).to(torch.float32)))


def make_circuit_trajectory(n_frames: int, radius: float = 1.0,
                            loops: float = 1.0, device="cpu"):
    """Closed-circuit camera path inside ROOM_CLOSED: a circle of `radius`
    in the x-z plane, always facing outward, `loops` revolutions."""
    s = torch.linspace(0.0, loops, n_frames, dtype=torch.float32,
                       device=device)
    theta = 2 * math.pi * s
    half = theta / 2.0
    zero = torch.zeros_like(half)
    q = torch.stack([torch.cos(half), zero, torch.sin(half), zero], dim=-1)
    out_dir = torch.stack([torch.sin(theta), zero, torch.cos(theta)], dim=-1)
    t = radius * out_dir
    t = t + torch.stack([zero, 0.05 * torch.sin(6 * math.pi * s), zero],
                        dim=-1)
    return se3.se3_make(q, t)


class SyntheticSequence:
    """Host-side iterator mimicking a dataset: (gray, depth, gt_T_wc), with
    frames rendered on `device`.

    dynamic: one person strafing through the room (`object_track`);
    people: explicit [N, P, 5] walker tracks (`walker_tracks`), which
    override `dynamic`; props: True for DEFAULT_PROPS, or a [Q,7] array."""

    def __init__(self, cam: Camera, n_frames: int = 60, dynamic: bool = False,
                 planes=ROOM, poses=None, props=None, people=None,
                 device="cuda"):
        self.cam = cam
        self.n_frames = n_frames
        self.dynamic = dynamic
        self.planes = planes
        self.device = resolve_device(device)
        dev = self.device
        # T_wc (camera-to-world) per frame
        self.poses = (make_trajectory(n_frames, dev) if poses is None
                      else _f32(poses, dev))
        self.obj = object_track(n_frames, dev) if dynamic else None
        self.people = _f32(people, dev) if people is not None else None
        self.props = (_f32(DEFAULT_PROPS, dev) if props is True
                      else (_f32(props, dev) if props is not None else None))
        self.timestamps = np.arange(n_frames, dtype=np.float64) / 30.0

    def __len__(self):
        return self.n_frames

    def frame(self, i: int):
        if self.people is not None:
            props = (self.props if self.props is not None
                     else torch.zeros((0, 7), device=self.device))
            return render_frame_scene(self.cam, self.poses[i], self.people[i],
                                      props, planes=self.planes)
        if self.props is not None:
            if self.dynamic:
                extra = torch.tensor([0.55 * 1.3, 9.0], device=self.device)
                people = torch.cat([self.obj[i], extra])[None, :]
            else:
                people = torch.zeros((0, 5), device=self.device)
            return render_frame_scene(self.cam, self.poses[i], people,
                                      self.props, planes=self.planes)
        obj_c = self.obj[i] if self.dynamic else None
        return render_frame(self.cam, self.poses[i], obj_c, obj_half=0.55,
                            planes=self.planes)

    def gt_prop_box(self, i: int, q: int):
        """GT pixel box + visibility of prop q at frame i."""
        return prop_gt_box(self.cam, se3.se3_inverse(self.poses[i]),
                           self.props[q])

    def frame_stereo(self, i: int):
        """Rectified stereo pair (gray_left, gray_right, depth_left),
        rendered on the sequence's device: the right camera sits baseline =
        bf/fx to the left camera's +x (the rectified-pair geometry of
        Frame.cc:87-127). People and props are not drawn, as in the
        reference; `dynamic` draws its one walker."""
        b = self.cam.bf / self.cam.fx
        T_wc_l = self.poses[i]
        T_wc_r = se3.se3_compose(T_wc_l, se3.se3_make(
            torch.tensor([1.0, 0.0, 0.0, 0.0], device=self.device),
            torch.tensor([b, 0.0, 0.0], device=self.device)))
        obj_c = self.obj[i] if self.dynamic else None
        gl, dl = render_frame(self.cam, T_wc_l, obj_c, obj_half=0.55,
                              planes=self.planes)
        gr, _ = render_frame(self.cam, T_wc_r, obj_c, obj_half=0.55,
                             planes=self.planes)
        return gl, gr, dl

    def gt_pose_wc(self, i: int):
        return self.poses[i]

    def gt_pose_cw(self, i: int):
        return se3.se3_inverse(self.poses[i])
