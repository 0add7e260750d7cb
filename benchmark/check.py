"""The numbers that decide `correct`, each against its limit.

After the window has closed, each sampled call of a judged layer (see
`capture.py`) is computed again by the plain reference (`reference/`) and
compared with what the program returned:

    keypoints  share of keypoint slots whose validity, position, level,
               angle, descriptor or depth differ (front end); of a
               stereo frame also its right coordinate u_right, the SAD
               search's disparity with its sub-pixel parabola
    boxes_px   widest gap of a detector box, in pixels; a box that is
               valid or of a class on one side only counts as the image's
               diagonal (semantic layer: detector)
    keep_mask  share of features whose keep flag in the dynamic cull
               differs (semantic layer: frame-to-frame matches, F-RANSAC,
               epipolar test)
    assoc      share of matched features whose map point differs
               (tracking: local points, projective searches)
    pose       widest gap of the optimised pose's components (tracking:
               motion-only BA; quaternion and metres)
    ba         widest gap of local BA's poses and points (keyframe back
               end; quaternion components and metres)
    ate_m      ATE RMSE of the window's trajectory against the scene's
               ground truth (the configuration's accuracy guarantee)

The front end and the detector start from the frames the benchmark made;
the cull, tracking and the BA follow the program's state as the call
received it (features, map, BA problem), which the earlier comparisons
check. The control (`control=True`) puts the reference computed with TF32
in the program's place: the precision next below the configuration's
float32 with TF32 off. Its tracking starts from its own TF32 extraction
of the frame, as the reference in the program's place would (without the
cull, which keep_mask judges), by the frame's own path (RGB-D or stereo):
TF32 alone moves the optimised pose by an ulp and no association.
"""

from __future__ import annotations

import contextlib
import math

import torch

from .reference import ate as ate_mod
from .reference import cull, detector, local_ba, orb, track

NUMBERS = ("keypoints", "boxes_px", "keep_mask", "assoc", "pose", "ba")


@contextlib.contextmanager
def precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _eq(a, b):
    """Elementwise exact equality, NaN equal to NaN."""
    if a.dtype.is_floating_point:
        return (a == b) | (torch.isnan(a) & torch.isnan(b))
    return a == b


def _gap(a, b) -> float:
    """Widest |a - b| (NaN on one side only: inf)."""
    a, b = a.double(), b.double()
    nan = torch.isnan(a) | torch.isnan(b)
    if bool((torch.isnan(a) != torch.isnan(b)).any()):
        return math.inf
    d = torch.where(nan, 0.0, (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def _pose_gap(a, b) -> float:
    """Widest component gap of poses [..., 7], whichever sign the
    quaternions take."""
    q = min(_gap(a[..., :4], b[..., :4]), _gap(a[..., :4], -b[..., :4]))
    return max(q, _gap(a[..., 4:], b[..., 4:]))


# the fields `keypoints` compares, by the sample's front end
FIELDS = {"rgbd": ("xy_raw", "level", "angle", "desc", "depth"),
          "stereo": ("xy_raw", "level", "angle", "desc", "depth",
                     "u_right")}


def keypoints(prog, ref, kind: str) -> tuple[int, int]:
    """(slots that differ, slots valid on either side), over the fields
    of the front end `kind`."""
    either = prog.valid | ref.valid
    same = prog.valid == ref.valid
    for f in FIELDS[kind]:
        a, b = getattr(prog, f), getattr(ref, f)
        e = _eq(a, b)
        same = same & (e.all(-1) if e.dim() > 1 else e)
    return int((either & ~same).sum()), int(either.sum())


def boxes_gap(prog, ref, diag: float) -> float:
    """Widest gap between two `Boxes` of the same shape."""
    either = prog.valid | ref.valid
    if not bool(either.any()):
        return 0.0
    flag = (prog.valid != ref.valid) | (prog.cls != ref.cls)
    if bool((either & flag).any()):
        return diag
    d = (prog.xyxy.double() - ref.xyxy.double()).abs().amax(-1)
    return float(torch.where(either, d, 0.0).max())


class Judge:
    """The reference side: the configuration file's settings, and the
    detector built from the weights file."""

    def __init__(self, rcfg, detector_path: str, device):
        self.cfg = rcfg
        self.device = device
        self.det = detector.Detector(rcfg.detector, detector_path, device)

    # each layer: [(program's output, reference's output)] per sample
    def extract(self, s):
        if s["kind"] == "stereo":
            return orb.extract_frame_stereo(self.cfg, s["gray"],
                                            s["gray_r"])
        return orb.extract_frame(self.cfg, s["gray"].to(torch.float32),
                                 s["depth"])

    def detect(self, s):
        cam = self.cfg.camera
        if s["kind"] == "batch":
            return self.det.detect_batch(s["x"], cam.width, cam.height)
        return self.det.detect(s["x"], cam.width, cam.height)

    def cull(self, s):
        a, _, _ = s["match"]
        c = self.cfg
        prev_xy, status = cull.match_prev_frame(
            c.matcher, c.orb.scale_factor, *a[2:],
            radius=c.dynamic.match_radius)
        drawn = s["drawn"]
        return cull.reject_dynamic_matched(
            c.dynamic, s["kp_xy"], s["kp_valid"], prev_xy, status,
            s["person_boxes"], s["prev_boxes"],
            lambda n_valid, iters: drawn[0])

    def track(self, s, control=False):
        feats = s["feats"]
        if control and s["gray"] is not None:
            # the control tracks its own features of the frame (the cull,
            # judged by keep_mask, left out)
            feats = self.extract(s)
        return track.track_step(self.cfg, s["m"], feats, s["Tcw_pred"],
                                fallback=s["fallback"])

    def ba(self, s):
        # the call's own budget and tolerance: local BA's, or a slice of
        # the global BA after a loop closure
        return local_ba.bundle_adjust(self.cfg.camera, s["prob"], **s["kw"])

    def numbers(self, cap, control: bool = False) -> dict:
        """The six layer numbers (None where the window made no call of a
        layer). With `control`, the reference with TF32 stands in for the
        program's outputs."""
        out = {}
        cam = self.cfg.camera
        diag = math.hypot(cam.width, cam.height)

        def pairs(layer):
            res = []
            for s in cap.samples(layer):
                with precision(False):
                    ref = getattr(self, layer)(s)
                if control:
                    with precision(True):
                        prog = (self.track(s, control=True)
                                if layer == "track" else
                                getattr(self, layer)(s))
                else:
                    prog = s["out"]
                res.append((prog, ref))
            return res

        p = pairs("extract")
        if p:
            bad = [keypoints(a, b, s["kind"])
                   for (a, b), s in zip(p, cap.samples("extract"))]
            out["keypoints"] = (sum(x for x, _ in bad)
                                / max(1, sum(n for _, n in bad)))
        p = pairs("detect")
        if p:
            out["boxes_px"] = max(boxes_gap(x, y, diag)
                                  for a, b in p for x, y in zip(a, b))
        p = pairs("cull")
        if p:
            bad = sum(int((a[0] != b[0]).sum()) for a, b in p)
            n = sum(int(s["kp_valid"].sum()) for s in cap.samples("cull"))
            out["keep_mask"] = bad / max(1, n)
        p = pairs("track")
        if p:
            bad = sum(int(((a[1] != b[1]) & ((a[1] >= 0) | (b[1] >= 0)))
                          .sum()) for a, b in p)
            n = sum(int(((a[1] >= 0) | (b[1] >= 0)).sum()) for a, b in p)
            out["assoc"] = bad / max(1, n)
            out["pose"] = max(_pose_gap(a[0], b[0]) for a, b in p)
        p = pairs("ba")
        if p:
            out["ba"] = max(max(_pose_gap(a[0], b[0]), _gap(a[1], b[1]))
                            for a, b in p)
        return {k: out.get(k) for k in NUMBERS}


def ate(Tcw, T_wc_gt) -> float:
    return ate_mod.ate_rmse(Tcw, T_wc_gt)


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number at or under its limit, {name: {value, limit}}). A
    number the run could not read fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = values.get(name)
        checks[name] = {"value": v, "limit": limit}
        if v is None or not (v <= limit):
            ok = False
    return ok, checks
