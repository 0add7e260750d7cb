"""System facade: the RGB-D semantic SLAM engine.

Port of `sgslam_tpu/slam/system.py`: per frame, the 2-D detector, ORB
extraction, the dynamic-feature cull (box-only before the map exists, then
ORB correspondences + F-RANSAC + epipolar test), tracking with the keyframe
back-end, relocalization when tracking is lost, and on keyframes loop
closing (BoW database, Sim3 verification, essential graph, fusion, global
BA) and the semantic mapper. The public API is the reference's:
`track_rgbd`, trajectory savers, reset, shutdown, localization mode,
checkpoints (with the place-recognition database).

`track_stereo` (rectified pairs, depth from `ops/stereo`) and
`track_monocular` (on a System built by `System.monocular`, whose tracker
is `slam.mono.MonoTracker`) run the same tracker, back-end and loop closer;
the semantic mapper stays RGB-D-only, as in the reference. Entry points
run on `device` ("cuda" by default).

`metrics` is the system's tracer (`utils/timing.Metrics`), active for
each call of `track_rgbd`, `track_stereo` and `track_monocular`: a
`runner.frame` span per frame holds the stages' spans (`semantic.detector`,
`front_end.extract`, `semantic.cull`, tracking's, `reloc`, `loop.detect`,
`mapping`); it counts `frames`, `keyframes`, `loops_closed`,
`reloc_attempts` and `reloc_success`. `on_stage(name)`, if set, is called
with "begin" at the start of `track_rgbd` and after each of its stages
("detector", "extract", "cull", "track", "relocalize" when tracking is
lost, and "loop_closing" and "mapping" on keyframes; `track_stereo` and
`track_monocular` list theirs), at the closing edge of the stage's span,
for timing with device events; it must not touch the state.
`sampler` replaces the F-RANSAC draws and `draws` the loop closer's (tests
replay the reference's).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import SlamConfig
from ..io import trajectory as traj_io
from ..mapping.semantic_mapper import SemanticMapper
from ..semantic import dynamic as dyn_mod
from ..semantic.dynamic import Boxes
from ..utils import timing
from . import tracking
from .loop_closing import LoopCloser
from .tracking import _as_tensor


class System:
    def __init__(self, cfg: SlamConfig, vocab=None, *,
                 enable_semantic: bool = True, enable_loop: bool = True,
                 enable_mapping: bool = True, detector=None, device="cuda",
                 sampler=None, draws=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tracker = tracking.Tracker(cfg, device=self.device)
        self._draws = draws
        self.loop = (LoopCloser(cfg, vocab, device=self.device, draws=draws)
                     if enable_loop else None)
        self.mapper = (SemanticMapper(cfg, device=self.device)
                       if enable_mapping else None)
        self.enable_semantic = enable_semantic and cfg.dynamic.enabled
        self.detector = detector
        if enable_semantic and detector is None and cfg.detector.enabled:
            from ..models.detector import Detector2D

            self.detector = Detector2D(cfg.detector, device=self.device)

        if self.loop is not None:
            self.tracker.on_compaction = self.loop.remap_keyframes

        # `sampler` replaces the F-RANSAC draws (tests replay the
        # reference's); by default a generator seeded like the reference
        self._sampler = sampler
        self.frontend = dyn_mod.SemanticFrontend(cfg, seed=7,
                                                 device=self.device,
                                                 sampler=sampler)
        self.last_feats = None
        self.person_cull_boxes = Boxes.empty(cfg.detector.max_boxes,
                                             self.device)
        self.object_boxes = None
        self.timestamps: list[float] = []
        self.metrics = timing.Metrics()
        self.on_stage = None

    def _mark(self, name: str):
        if self.on_stage is not None:
            self.on_stage(name)

    # ------------------------------------------------------------------
    def track_rgbd(self, gray, depth, rgb=None,
                   timestamp: Optional[float] = None) -> np.ndarray:
        """Main per-frame API (System::TrackRGBD contract). gray, depth
        [H,W] and rgb [H,W,3] float32 (numpy or tensors). Returns Tcw [7]."""
        tr = self.metrics
        with timing.tracing(tr), tr.span("runner.frame",
                                         rid=self.tracker.frame_id,
                                         frames=1):
            tr.count("frames")
            return self._track_rgbd(gray, depth, rgb, timestamp)

    def _track_rgbd(self, gray, depth, rgb, timestamp):
        cfg = self.cfg
        dev = self.device
        tr = self.metrics
        gray = _as_tensor(gray, dev)
        depth = _as_tensor(depth, dev)
        self.timestamps.append(
            timestamp if timestamp is not None
            else len(self.timestamps) / cfg.fps)
        self._mark("begin")

        # 2-D detection on the current frame
        if self.detector is not None and rgb is not None:
            with tr.span("semantic.detector"):
                (_, person_cull, person_map,
                 objects2d) = self.detector.detect(
                    _as_tensor(rgb, dev), cfg.camera.width, cfg.camera.height)
            self.person_cull_boxes = person_cull
            self.object_boxes = objects2d
            dynamic_boxes = person_map
        else:
            dynamic_boxes = Boxes.empty(cfg.detector.max_boxes, dev)
        self._mark("detector")

        with tr.span("front_end.extract"):
            feats = tracking.extract_frame(cfg, gray, depth, dev)
        feats_raw = feats   # pre-cull block: next frame's match target
        self._mark("extract")

        # semantic + geometric dynamic rejection
        if self.enable_semantic:
            with tr.span("semantic.cull"):
                # the init-frame box-only cull needs real detections;
                # oracle-box tests inject boxes only after initialization
                init_done = (self.tracker.state != "NOT_INITIALIZED"
                             or self.detector is None)
                feats = self.frontend.cull(gray, feats,
                                           self.person_cull_boxes,
                                           map_initialized=init_done)
        self._mark("cull")

        Tcw = self.tracker.process(gray, depth, feats=feats)
        self.last_feats = feats   # post-cull features
        self._mark("track")

        # relocalization on tracking loss (Tracking::Relocalization path)
        if self.tracker.state == "LOST" and self.loop is not None:
            with tr.span("reloc"):
                T_reloc, _ = self.loop.relocalize(self.tracker.map, feats)
            tr.count("reloc_attempts")
            if T_reloc is not None:
                self.tracker.force_pose(T_reloc)
                Tcw = T_reloc.cpu().numpy()
                tr.count("reloc_success")
            self._mark("relocalize")
        tracked_Tcw = self.tracker.Tcw

        # lost right after init with a tiny map: full reset
        # (Tracking.cc:513-521 "Track lost soon after initialisation")
        if self.tracker.state == "LOST" and self.tracker.n_kf <= 5:
            self.reset()
            return Tcw

        # keyframe side effects: loop closing + semantic mapping
        if self.tracker.kf_inserted:
            tr.count("keyframes")
            if self.loop is not None:
                self._loop_closing()
            if self.mapper is not None:
                with tr.span("mapping"):
                    self.mapper.insert_keyframe(
                        gray, depth, tracked_Tcw, dynamic_boxes,
                        self.object_boxes)
                self._mark("mapping")

        self.frontend.push(gray, feats_raw, dynamic_boxes)
        return Tcw

    def _loop_closing(self):
        kf_id = self.tracker.last_kf_id
        corrected = self.loop.on_keyframe(self.tracker.map, kf_id)
        if corrected is not None:
            self.metrics.count("loops_closed")
            self.tracker.map = corrected
            self.tracker.Tcw = corrected.kf_pose[kf_id]
            self.tracker.last_Tcw = self.tracker.Tcw
        self._mark("loop_closing")

    # oracle-box injection hooks (tests drive the cull without a detector)
    @property
    def prev_dynamic_boxes(self):
        return self.frontend.prev_boxes

    @prev_dynamic_boxes.setter
    def prev_dynamic_boxes(self, boxes):
        self.frontend.prev_boxes = boxes

    @property
    def prev_feats(self):
        return self.frontend.prev_feats

    # ------------------------------------------------------------------
    def track_stereo(self, gray_l, gray_r, rgb=None) -> np.ndarray:
        """Rectified stereo per-frame API (System::TrackStereo contract,
        System.cc:190-239): extraction on the left image + epipolar SAD
        depth from the right, then the identical tracking state machine.
        The semantic dynamic-feature cull runs on the LEFT image (pass
        `rgb` to drive the detector; oracle boxes via prev_dynamic_boxes
        work as in track_rgbd). The loop closer applies unchanged; the
        semantic mapper needs metric depth and stays RGB-D-only. Stages:
        "begin", "detector", "extract", "cull", "track", "loop_closing"."""
        tr = self.metrics
        with timing.tracing(tr), tr.span("runner.frame",
                                         rid=self.tracker.frame_id,
                                         frames=1):
            tr.count("frames")
            return self._track_stereo(gray_l, gray_r, rgb)

    def _track_stereo(self, gray_l, gray_r, rgb):
        cfg = self.cfg
        dev = self.device
        tr = self.metrics
        gray_l = _as_tensor(gray_l, dev).to(torch.float32)
        self.timestamps.append(len(self.timestamps) / cfg.fps)
        self._mark("begin")

        if self.detector is not None and rgb is not None:
            with tr.span("semantic.detector"):
                (_, person_cull, person_map,
                 objects2d) = self.detector.detect(
                    _as_tensor(rgb, dev), cfg.camera.width, cfg.camera.height)
            self.person_cull_boxes = person_cull
            self.object_boxes = objects2d
            dynamic_boxes = person_map
        else:
            dynamic_boxes = Boxes.empty(cfg.detector.max_boxes, dev)
        self._mark("detector")

        with tr.span("front_end.extract"):
            feats = tracking.extract_frame_stereo(cfg, gray_l, gray_r, dev)
        feats_raw = feats
        self._mark("extract")
        if self.enable_semantic:
            with tr.span("semantic.cull"):
                init_done = (self.tracker.state != "NOT_INITIALIZED"
                             or self.detector is None)
                feats = self.frontend.cull(gray_l, feats,
                                           self.person_cull_boxes,
                                           map_initialized=init_done)
        self._mark("cull")

        Tcw = self.tracker.process(gray_l, None, feats=feats)
        self.last_feats = feats
        self._mark("track")
        self._post_track()
        self.frontend.push(gray_l, feats_raw, dynamic_boxes)
        return Tcw

    def track_monocular(self, gray) -> np.ndarray:
        """Monocular per-frame API (System::TrackMonocular contract): the
        tracker must be a slam.mono.MonoTracker (see System.monocular).
        Stages: "begin", "track" (extraction included), "loop_closing"."""
        tr = self.metrics
        with timing.tracing(tr), tr.span("runner.frame",
                                         rid=self.tracker.frame_id,
                                         frames=1):
            tr.count("frames")
            self.timestamps.append(len(self.timestamps) / self.cfg.fps)
            self._mark("begin")
            Tcw = self.tracker.process_mono(gray)
            self._mark("track")
            if self.tracker.state == "OK":
                self._post_track()
            return Tcw

    @classmethod
    def monocular(cls, cfg: SlamConfig, **kw):
        """Construct a System whose tracker runs the monocular pipeline."""
        from .mono import MonoTracker

        s = cls(cfg, **kw)
        s.tracker = MonoTracker(cfg, device=s.device)
        if s.loop is not None:
            s.tracker.on_compaction = s.loop.remap_keyframes
        return s

    def _post_track(self):
        """Shared keyframe side effect of the stereo and monocular paths:
        loop closing (mapping needs a depth image, so RGB-D only)."""
        if self.tracker.kf_inserted and self.loop is not None:
            self._loop_closing()

    @property
    def state(self):
        return self.tracker.state

    def activate_localization_mode(self):
        """Freeze the map and only track (System.cc:345-349)."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        """Resume full SLAM: keyframe insertion + mapping."""
        self.tracker.only_tracking = False

    def shutdown(self):
        """System::Shutdown contract: the stages are host calls around
        device work, so shutdown waits for the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset(self):
        """System::Reset contract: drop map + trajectory, keep config and
        the tracer."""
        metrics = self.metrics
        self.__init__(self.cfg, self.loop.vocab if self.loop else None,
                      enable_semantic=self.enable_semantic,
                      enable_loop=self.loop is not None,
                      enable_mapping=self.mapper is not None,
                      detector=self.detector, device=self.device,
                      sampler=self._sampler, draws=self._draws)
        self.metrics = metrics

    # -- map checkpoint / resume (the reference's unimplemented TODO) --
    def save_checkpoint(self, path: str):
        """Persist the full map + place-recognition database; a saved
        checkpoint reopens in localization-only mode (or resumes mapping)."""
        from ..io import checkpoint as ckpt

        extra = {"Tcw": self.tracker.Tcw.cpu().numpy(),
                 "frame_id": np.asarray(self.tracker.frame_id)}
        if self.loop is not None:
            extra["bow_db"] = self.loop.bow_db.cpu().numpy()
            extra["db_valid"] = self.loop.db_valid.cpu().numpy()
        ckpt.save_map(path, self.tracker.map, extra)

    def load_checkpoint(self, path: str, localization_only: bool = True):
        """Restore a saved map; the tracker starts LOST and recovers by
        relocalization against the restored keyframe database."""
        from ..io import checkpoint as ckpt

        m, extra = ckpt.load_map(path, device=self.device)
        self.tracker.map = m
        self.tracker.n_kf = int(m.kf_valid.sum())
        self.tracker.last_kf_id = int(m.next_kf) - 1
        self.tracker.state = "LOST"
        if self.loop is not None and "bow_db" in extra:
            self.loop.bow_db = torch.as_tensor(extra["bow_db"],
                                               device=self.device)
            self.loop.db_valid = torch.as_tensor(extra["db_valid"],
                                                 device=self.device)
        if localization_only:
            self.activate_localization_mode()

    def save_trajectory_tum(self, path: str):
        traj_io.save_tum(path, self.timestamps, self.tracker.poses_cw())

    def save_trajectory_kitti(self, path: str):
        traj_io.save_kitti(path, self.tracker.poses_cw())

    def save_keyframe_trajectory_tum(self, path: str):
        m = self.tracker.map
        valid = m.kf_valid.cpu().numpy()
        poses = m.kf_pose.cpu().numpy()[valid]
        fids = m.kf_frame_id.cpu().numpy()[valid]
        ts = [self.timestamps[min(f, len(self.timestamps) - 1)]
              for f in fids]
        traj_io.save_tum(path, ts, poses)
