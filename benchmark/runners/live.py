"""SG-SLAM's per-frame mode, `System.track_rgbd` with the detector, the
cull, tracking with the keyframe back end, loop closing and the semantic
mapper. Set-up tracks the bootstrap and warm frames; the window hands
over frame after frame from host memory until its time is up and times
each call from handing the frame over to holding its pose (the call
returns the pose on the host, so it ends synchronised)."""

from __future__ import annotations

import time

import numpy as np
import torch

from . import program_config


class Runner:
    kind = "live"
    views = ("gray", "depth")

    def __init__(self, doc: dict, frames, device, capture):
        from sgslam_tpu_torch.models.detector import Detector2D
        from sgslam_tpu_torch.slam.system import System

        r = doc["runner"]
        self.cfg = cfg = program_config(doc)
        self.boot, self.warm = int(r["boot_frames"]), int(r["warm_frames"])
        self.device = device
        self.frames = frames
        det = Detector2D(cfg.detector, device=device)
        capture.watch_detector(det)
        self.s = System(cfg, detector=det, device=device,
                        enable_loop=bool(r["loop"]),
                        enable_mapping=bool(r["mapping"]))
        self.i = 0
        self._hooks = (None, None)

    def _track(self):
        i = self.i
        if i >= len(self.frames):
            raise RuntimeError(f"out of frames: the window wanted frame {i} "
                               f"of {len(self.frames)}")
        g, d = (getattr(self.frames, v)[i] for v in self.views)
        rgb = np.broadcast_to(g[..., None], g.shape + (3,))
        self.s.track_rgbd(g, d, rgb=rgb)
        self.i += 1
        if self.s.on_stage is not self._hooks[0]:
            # a reset after an early loss rebuilt the system's hooks
            self.hook(*self._hooks)

    def setup(self):
        """`boot_frames` + `warm_frames`, and on until the tracker tracks."""
        while (self.i < self.boot + self.warm
               or self.s.tracker.state != "OK"):
            if self.i >= 4 * self.boot + 2 * self.warm:
                raise RuntimeError(f"the tracker is not tracking after "
                                   f"{self.i} frames")
            self._track()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def hook(self, stages, backend=None):
        self._hooks = (stages, backend)
        self.s.on_stage = stages
        self.s.tracker.on_backend_stage = backend

    def window(self, seconds: float, stages=None) -> dict:
        start = self.i
        resets0 = self.resets()
        loops0 = self.s.metrics.counters.get("loops_closed", 0)
        relocs0 = self.s.metrics.counters.get("reloc_success", 0)
        frame_ms, kf, lost = [], [], []
        half = None
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if stages is not None:
                stages.tag = self.i
            a = time.perf_counter()
            self._track()
            frame_ms.append((time.perf_counter() - a) * 1e3)
            kf.append(bool(self.s.tracker.kf_inserted))
            lost.append(self.s.tracker.state != "OK")
            if half is None and time.perf_counter() - t0 >= seconds / 2:
                half = (self.i - start, time.perf_counter() - t0)
        dt = time.perf_counter() - t0
        return {"frames": self.i - start, "seconds": dt, "first": start,
                "end": self.i, "lost": int(sum(lost)), "frame_ms": frame_ms,
                "keyframe": kf,
                "loops_closed": self.s.metrics.counters.get(
                    "loops_closed", 0) - loops0,
                "relocalizations": self.s.metrics.counters.get(
                    "reloc_success", 0) - relocs0,
                "keyframes": int(sum(kf)), "resets": self.resets() - resets0,
                "half": half}

    def resets(self) -> int:
        """Frames handed over before the system's last reset (a reset
        rebuilds the tracker and its trajectory)."""
        return self.i - len(self.s.tracker.trajectory)

    def trajectory(self):
        """Tcw [n, 7] of every frame handed over, from frame 0; NaN rows
        for the frames before the system's last reset."""
        poses = self.s.tracker.poses_cw()
        gap = np.full((self.resets(), 7), np.nan, np.float32)
        return np.concatenate([gap, poses.astype(np.float32)])

    def close(self):
        self.s = None
