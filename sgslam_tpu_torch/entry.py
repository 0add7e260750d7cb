"""The compile-check half of the repository's entry contract on the port.

Port of `__graft_entry__.entry`. `entry(device)` returns `(fn,
example_args)` for the flagship step, one ORB extraction and one
`track_step` (local-map association and two pose optimizations) on a map
that holds one keyframe, at the small configuration: 320x240, 600
features, 640 keypoints, 64 keyframes, 8192 points, window 4, 1024 local
points. `fn(*example_args)` runs it on `device` (the card by default) and
returns `track_step`'s outputs (pose, matched point ids, inlier count,
close tracked and untracked counts, and the fallback flag; the reference
returns the first five).

The contract's other half, the multi-chip dryrun
(`__graft_entry__.dryrun_multichip`), is
`sgslam_tpu_torch.parallel.dryrun.dryrun_multichip`.
"""

from __future__ import annotations

import torch

from . import config, resolve_device


def small_config():
    """`__graft_entry__._small_cfg`."""
    return config.synthetic_config(
        width=320, height=240,
        orb=config.OrbConfig(n_features=600, max_keypoints=640),
        capacity=config.MapCapacity(max_keyframes=64, max_points=8192,
                                    local_window=4, local_points=1024))


def entry(device="cuda"):
    """(fn, example_args): fn(map, gray, depth, Tcw_pred) extracts the
    frame's features and tracks it against the map."""
    from .geometry import se3
    from .io import synthetic
    from .mapstate import mapstate as ms
    from .slam import tracking

    dev = resolve_device(device)
    cfg = small_config()
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=2, device=dev)
    gray0, depth0 = seq.frame(0)
    feats0 = tracking.extract_frame(cfg, gray0, depth0, dev)
    m = ms.empty_map(cfg.capacity, cfg.orb.max_keypoints, device=dev)
    m = ms.insert_keyframe(cfg.camera, cfg.orb.scale_factor, m, feats0,
                           se3.se3_identity(device=dev), 0,
                           torch.full((feats0.capacity,), -1,
                                      dtype=torch.int32, device=dev),
                           cfg.close_depth_threshold)
    gray1, depth1 = seq.frame(1)

    def fn(m, gray, depth, Tcw_pred):
        feats = tracking.extract_frame(cfg, gray, depth, dev)
        return tracking.track_step(cfg, m, feats, Tcw_pred, dev)

    return fn, (m, gray1, depth1, se3.se3_identity(device=dev))
