"""The one traffic generator: a mix's parameters (a `traffic/<mix>.json`)
and a seed -> frames in host memory, as a camera or a dataset reader hands
them over, with the ground-truth poses.

A mix describes a scene (the room's planes), a camera walk and walkers.
Every walked quantity is `offset + amp * sin(pi * k * s + phase)` of the
scene parameter s, which advances 1 / `frames_per_unit` per frame, so the
motion per frame is the mix's whatever the number of frames: a longer run
repeats the walk, it does not slow it. The camera's pose is the SE(3)
exponential of its six twist components (tx, ty, tz, wx, wy, wz); a
walker is a person capsule (cx, cy, cz, half_h, tex_seed). The camera
and the walkers move alike for every seed: loop closing answers to
revisits and to what the walkers hide, and a seed that moved them changed
the work (the number of loops closed in a window, and with it frames/s).
The seed draws each walker's look, its texture seed. The frames cover
`cap_fps` frames a second of the window; a run that needs more fails.

A runner that declares the view "gray_r" (`runners/__init__.py`) gets a
rectified right view beside each frame: the same scene, walkers and
intrinsics, rendered from the left pose moved by the baseline bf / fx
along the camera's +x axis. It draws nothing more from the seed, and a
run without it renders nothing more.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import scene
from .reference import se3

TWIST = ("tx", "ty", "tz", "wx", "wy", "wz")
PERSON = ("cx", "cy", "cz")


def _wave(spec, s):
    """offset + amp * sin(pi * k * s + phase) for spec = [offset, amp, k,
    phase] (float64)."""
    offset, amp, k, phase = spec
    return offset + amp * np.sin(math.pi * k * s + phase)


def looks(mix: dict, seed: int) -> list[float]:
    """Each walker's texture seed: the mix's `tex_seed` plus an offset
    drawn from the seed in [0, `tex_seed_range`)."""
    rng = np.random.default_rng(int(seed))
    return [p["tex_seed"] + float(rng.uniform(0.0, mix["tex_seed_range"]))
            for p in mix["people"]]


def walk(mix: dict, n: int, seed: int):
    """(T_wc [n, 7] float32, people [n, P, 5] float32) of frames 0..n-1."""
    unit = float(mix["frames_per_unit"])
    s = np.arange(n, dtype=np.float64) / unit
    xi = np.stack([_wave(mix["camera"][c], s) for c in TWIST], -1)
    T_wc = se3.se3_exp(torch.from_numpy(xi.astype(np.float32)))
    people = []
    for p, tex in zip(mix["people"], looks(mix, seed)):
        cols = [_wave(p[c], s) for c in PERSON]
        cols += [np.full(n, p["half_h"]), np.full(n, tex)]
        people.append(np.stack(cols, -1))
    people = (np.stack(people, 1) if people
              else np.zeros((n, 0, 5)))
    return T_wc.numpy(), people.astype(np.float32)


def frames_needed(mix: dict, seconds: float, lead: int, chunk: int) -> int:
    """Frames a run renders: `lead` frames of set-up, then `cap_fps`
    frames a second of the window, rounded up to whole chunks."""
    n = int(math.ceil(mix["cap_fps"] * seconds))
    n = -(-n // chunk) * chunk
    return lead + n


class Frames:
    """A run's frames in host memory: gray [n, H, W] in [0, 1] and depth
    [n, H, W] (meters, 0 = invalid) float32, the ground truth T_wc [n, 7],
    and gray_r [n, H, W], the rectified right view, or None where the
    runner does not declare it."""

    def __init__(self, gray, depth, T_wc, gray_r=None):
        self.gray, self.depth, self.T_wc = gray, depth, T_wc
        self.gray_r = gray_r

    def __len__(self):
        return self.gray.shape[0]


def right_poses(cam, T_wc):
    """The right camera's poses of a rectified pair whose left poses are
    T_wc [n, 7]: the same orientation, the centre moved by the baseline
    bf / fx along the left camera's +x axis."""
    off = torch.zeros_like(T_wc[:, 4:7])
    off[:, 0] = cam.bf / cam.fx
    return torch.cat([T_wc[:, :4],
                      T_wc[:, 4:7] + se3.quat_rotate(T_wc[:, :4], off)], -1)


def render(mix: dict, cam, n: int, seed: int, device, batch: int = 16,
           views=("gray", "depth")):
    """The mix's first n frames for `seed`, rendered on `device`, `batch`
    frames at a time, and held in host memory; with "gray_r" in `views`
    the right view of each frame too."""
    T_wc, people = walk(mix, n, seed)
    planes = tuple(scene.Plane(*map(float, p)) for p in mix["planes"])
    gray = np.empty((n, cam.height, cam.width), np.float32)
    depth = np.empty_like(gray)
    gray_r = np.empty_like(gray) if "gray_r" in views else None
    T = torch.from_numpy(T_wc).to(device)
    P = torch.from_numpy(people).to(device)
    for b in range(0, n, batch):
        g, d = scene.render_frames(cam, T[b:b + batch], P[b:b + batch],
                                   planes)
        gray[b:b + batch] = g.cpu().numpy()
        depth[b:b + batch] = d.cpu().numpy()
        if gray_r is not None:
            g, _ = scene.render_frames(cam, right_poses(cam, T[b:b + batch]),
                                       P[b:b + batch], planes)
            gray_r[b:b + batch] = g.cpu().numpy()
    return Frames(gray, depth, T_wc, gray_r)
