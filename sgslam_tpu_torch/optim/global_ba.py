"""Full-map bundle adjustment.

Port of `sgslam_tpu/optim/global_ba.py`: global BA is local BA with the
window = every keyframe slot and the point budget = the map's capacity
(`build_ba_problem` -> `bundle_adjust` -> `writeback_ba`), keyframe 0 fixed
for the gauge, and a slice-at-a-time loop that a host hook can preempt;
each slice is a `loop.gba` span on the active tracer.

At the default capacity the problem has C = 512 cameras and P = 32768
points: the point-block buffer of `bundle_adjust` is [C * P, 30] f32 (2.0
GB) and the couplings [C, P, 6, 3] (1.2 GB each), and the reduced camera
system costs about 2e12 flops per iteration. `tol=0` runs the whole budget
without a host read (`local_ba.bundle_adjust`).
"""

from __future__ import annotations

import torch

from ..config import SlamConfig
from ..mapstate import local_map as lm
from ..mapstate.mapstate import MapState
from ..utils import timing
from . import local_ba


def global_ba_step(cfg: SlamConfig, m: MapState, *, iters: int = 10,
                   fixed_extra=None) -> MapState:
    """One global-BA pass over the whole map, on the map's device. Keyframe
    0 is fixed for the gauge; `fixed_extra` [K] bool pins more keyframes
    (the post-loop GBA pins the verified loop pair)."""
    K = m.max_kf
    slot = torch.arange(K, dtype=torch.int32, device=m.device)
    kf_ids = torch.where(m.kf_valid, slot, -1)
    opt_mask = m.kf_valid & (slot != 0)
    if fixed_extra is not None:
        opt_mask = opt_mask & ~fixed_extra
    prob, pids = lm.build_ba_problem(cfg.camera, m, kf_ids, opt_mask,
                                     max_points=cfg.capacity.max_points,
                                     scale_factor=cfg.orb.scale_factor)
    # tol=0: the slicing loop owns the iteration count
    poses, points, _ = local_ba.bundle_adjust(
        cfg.camera, prob, iters1=iters // 2, iters2=iters - iters // 2,
        tol=0.0)
    return lm.writeback_ba(m, kf_ids, opt_mask, poses, pids, points)


def global_ba_interruptible(cfg: SlamConfig, m: MapState, *, iters: int = 10,
                            slice_iters: int = 2, should_abort=None,
                            fixed_extra=None):
    """Cooperatively cancellable global BA: `slice_iters`-iteration steps
    with the host `should_abort()` hook polled between them; every completed
    slice is kept. Returns (map, iterations_completed)."""
    tr = timing.active()
    done = 0
    while done < iters:
        n = min(slice_iters, iters - done)
        with tr.span("loop.gba"):
            m = global_ba_step(cfg, m, iters=n, fixed_extra=fixed_extra)
        done += n
        if should_abort is not None and done < iters and should_abort():
            break
    return m, done
