"""The chunked semantic pipeline, `ChunkedSemanticTracker`: bootstrap
frame by frame, warm chunks and a flush in set-up (`boot_frames` and
more until the tracker tracks, then `warm_frames`); the window hands over
chunk after chunk from host memory until its time is up, finishes the
chunk it began, flushes and synchronises."""

from __future__ import annotations

import time

import torch

from . import program_config


class Runner:
    kind = "chunked"
    views = ("gray", "depth")

    @staticmethod
    def _tracker():
        """The program's chunked runner class that this runner drives."""
        from sgslam_tpu_torch.slam.scan_pipeline import ChunkedSemanticTracker
        return ChunkedSemanticTracker

    def __init__(self, doc: dict, frames, device, capture):
        from sgslam_tpu_torch.models.detector import Detector2D
        from sgslam_tpu_torch.slam.loop_closing import LoopCloser

        r = doc["runner"]
        self.cfg = cfg = program_config(doc)
        self.chunk = int(r["chunk"])
        self.boot, self.warm = int(r["boot_frames"]), int(r["warm_frames"])
        self.device = device
        self.frames = frames
        det = Detector2D(cfg.detector, device=device)
        capture.watch_detector(det)
        self.ct = self._tracker()(
            cfg, det, chunk=self.chunk, fetch_every=int(r["fetch_every"]),
            loop=LoopCloser(cfg, device=device) if r["loop"] else None,
            device=device)
        self.i = 0

    def _views(self, sl):
        """The declared views of the frames `sl` (an index or a slice)."""
        return [getattr(self.frames, v)[sl] for v in self.views]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _chunk(self):
        c, i = self.chunk, self.i
        if i + c > len(self.frames):
            raise RuntimeError(f"out of frames: the window wanted frame "
                               f"{i + c - 1} of {len(self.frames)}")
        self.ct.process_chunk(*self._views(slice(i, i + c)))
        self.i += c

    def setup(self):
        """Bootstrap frame by frame: `boot_frames`, and on until the
        tracker is tracking (a walker in front of the camera can hold off
        the map's first keyframe), then the warm chunks and a flush."""
        while self.i < self.boot or self.ct.inner.state != "OK":
            if self.i >= 4 * self.boot + self.warm:
                raise RuntimeError(f"the tracker did not initialize in "
                                   f"{self.i} bootstrap frames")
            self.ct.bootstrap(*self._views(self.i))
            self.i += 1
        end = self.i + self.warm
        while self.i < end:
            self._chunk()
        self.ct.flush()
        self._sync()

    def hook(self, stages, backend=None):
        self.ct.on_chunk_stage = stages

    def window(self, seconds: float, stages=None) -> dict:
        ct = self.ct
        start = self.i
        loops0, relocs0, kf0 = ct.loops_closed, ct.relocs, ct._next_kf_host
        self._sync()
        t0 = time.perf_counter()
        half = None
        while time.perf_counter() - t0 < seconds:
            if stages is not None:
                stages.tag = self.i
            self._chunk()
            if half is None and time.perf_counter() - t0 >= seconds / 2:
                half = (self.i - start, time.perf_counter() - t0)
        ct.flush()
        self._sync()
        dt = time.perf_counter() - t0
        lost = ct.frame_lost[start:self.i]
        return {"frames": self.i - start, "seconds": dt, "first": start,
                "end": self.i, "lost": int(sum(lost)),
                "loops_closed": ct.loops_closed - loops0,
                "relocalizations": ct.relocs - relocs0,
                "keyframes": ct._next_kf_host - kf0,
                "half": half}

    def trajectory(self):
        """Tcw [n, 7] of every frame handed over, from frame 0."""
        return self.ct.poses_cw()

    def close(self):
        self.ct = None
