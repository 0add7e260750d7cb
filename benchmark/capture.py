"""What the harness installs on the program's function objects.

`Capture` keeps, for each layer that `correct` judges, a sample of the
calls made inside the measured window: its inputs and its outputs, held
by reference (the program builds new tensors for every update, so a held
input stays as the call saw it). The sample is a reservoir of fixed size
drawn from the run's seed. The wrappers call the program's function and
return its result unchanged; outside the window they only count. The
`extract` layer is both front ends, `tracking.extract_frame` (a sample of
kind "rgbd": gray, depth) and `tracking.extract_frame_stereo` (kind
"stereo": gray, gray_r); a `track` sample carries its frame's view too.

`Spans` wraps the two hand-written kernels' entry points in profiler
ranges (`bench.k1s`, `bench.segsum`) and keeps each call's shapes, so
that their rooflines can divide the call's least time by the device time
launched inside the range. It is installed in traced runs only.
"""

from __future__ import annotations

import collections
import sys

import numpy as np
import torch

# calls kept per layer: frames for the per-frame layers, fewer of the
# detector (a chunk's call holds four frames) and of the BA (the costliest
# to recompute)
LAYERS = {"extract": 8, "detect": 4, "cull": 8, "track": 8, "ba": 4}
# a tracked frame whose extraction the window did not see
NO_FRAME = {"kind": "rgbd", "gray": None, "depth": None}


class Reservoir:
    """k items drawn uniformly from a stream (algorithm R)."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def slot(self):
        """The slot the next item of the stream goes to, or None."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.k else None


def _patch(module, name, wrapper, undo):
    orig = getattr(module, name)
    setattr(module, name, wrapper(orig))
    undo.append((module, name, orig))
    return orig


class Capture:
    """Samples of the window's calls of the judged layers. `armed` is
    set for the measured window only."""

    def __init__(self, seed: int):
        rng = np.random.default_rng([int(seed), 7])
        self.res = {k: Reservoir(n, rng) for k, n in LAYERS.items()}
        self.armed = False
        self._undo = []
        self._match = None
        # the frames of the latest extractions, by their descriptors'
        # tensor (culled features share it), for the control's chain
        self._frames = collections.OrderedDict()

    def samples(self, layer):
        return [s for s in self.res[layer].items if s is not None]

    def _keep(self, layer, item_fn):
        if not self.armed:
            return
        j = self.res[layer].slot()
        if j is not None:
            self.res[layer].items[j] = item_fn()

    def install(self):
        """Wrap the program's layer functions (before the runner builds
        its objects, which bind some of them)."""
        from sgslam_tpu_torch.optim import local_ba
        from sgslam_tpu_torch.semantic import dynamic
        from sgslam_tpu_torch.slam import tracking

        def extract(kind, second):
            # one reservoir for both paths: an extraction call is one
            # item, whichever path made it
            def wrap(orig):
                def f(cfg, gray, other, device="cuda"):
                    out = orig(cfg, gray, other, device)
                    view = {"kind": kind, "gray": gray, second: other}
                    self._keep("extract", lambda: dict(view, out=out))
                    if self.armed:
                        self._frames[id(out.desc)] = (out.desc, view)
                        while len(self._frames) > 32:
                            self._frames.popitem(last=False)
                    return out
                return f
            return wrap

        def match(orig):
            def f(*a, **kw):
                out = orig(*a, **kw)
                if self.armed:
                    self._match = (a, kw, out)
                return out
            return f

        def reject(orig):
            def f(cfg, kp_xy, kp_valid, prev_xy, status, person_boxes,
                  prev_boxes, sampler):
                keep_it = self.armed and self._match is not None
                j = self.res["cull"].slot() if keep_it else None
                drawn = []

                def rec(n_valid, iters):
                    s = sampler(n_valid, iters)
                    drawn.append(s)
                    return s

                out = orig(cfg, kp_xy, kp_valid, prev_xy, status,
                           person_boxes, prev_boxes,
                           rec if j is not None else sampler)
                if j is not None:
                    self.res["cull"].items[j] = dict(
                        match=self._match, kp_xy=kp_xy, kp_valid=kp_valid,
                        person_boxes=person_boxes, prev_boxes=prev_boxes,
                        drawn=drawn, out=out)
                self._match = None
                return out
            return f

        def track(orig):
            def f(cfg, m, feats, Tcw_pred, device="cuda", fallback="host"):
                out = orig(cfg, m, feats, Tcw_pred, device, fallback=fallback)
                _, view = self._frames.get(id(feats.desc),
                                           (None, NO_FRAME))
                self._keep("track", lambda: dict(view, m=m, feats=feats,
                                                 Tcw_pred=Tcw_pred,
                                                 fallback=fallback,
                                                 out=out))
                return out
            return f

        def ba(orig):
            def f(cam, prob, **kw):
                out = orig(cam, prob, **kw)
                self._keep("ba", lambda: dict(prob=prob, kw=kw, out=out))
                return out
            return f

        _patch(tracking, "extract_frame", extract("rgbd", "depth"),
               self._undo)
        _patch(tracking, "extract_frame_stereo",
               extract("stereo", "gray_r"), self._undo)
        _patch(dynamic, "match_prev_frame", match, self._undo)
        _patch(dynamic, "reject_dynamic_matched", reject, self._undo)
        _patch(tracking, "track_step", track, self._undo)
        _patch(local_ba, "bundle_adjust", ba, self._undo)

    def watch_detector(self, det):
        """Wrap one detector object's two entry points."""
        def batch(orig):
            def f(grays, w, h):
                out = orig(grays, w, h)
                self._keep("detect", lambda: dict(kind="batch", x=grays,
                                                  out=out))
                return out
            return f

        def single(orig):
            def f(rgb, w, h):
                out = orig(rgb, w, h)
                self._keep("detect", lambda: dict(kind="single", x=rgb,
                                                  out=out))
                return out
            return f

        det.detect_batch = batch(det.detect_batch)
        det.detect = single(det.detect)

    def uninstall(self):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo = []


class Spans:
    """Profiler ranges around the two hand-written kernels' entry points,
    with each call's shapes for its bound."""

    def __init__(self):
        self.k1s, self.segsum = [], []
        self._undo = []

    def install(self):
        from sgslam_tpu_torch.ops import hamming_search, segment

        def k1s(orig):
            def f(desc_q, valid_q, desc_t, valid_t, window=None,
                  mutual=False):
                with torch.profiler.record_function("bench.k1s"):
                    out = orig(desc_q, valid_q, desc_t, valid_t, window,
                               mutual)
                self.k1s.append((valid_q, valid_t, window, mutual))
                return out
            return f

        def segsum(orig):
            def f(values, index, n, init=None):
                with torch.profiler.record_function("bench.segsum"):
                    out = orig(values, index, n, init)
                self.segsum.append((tuple(values.shape),
                                    values.element_size(), index,
                                    index.element_size(), int(n),
                                    init is not None))
                return out
            return f

        # every module that bound the entry points by name
        for name, fn, wrap in (
                ("hamming_search", hamming_search.hamming_search, k1s),
                ("segment_sum", segment.segment_sum, segsum)):
            for mod in list(sys.modules.values()):
                if (getattr(mod, "__name__", "").split(".")[0]
                        == "sgslam_tpu_torch"
                        and getattr(mod, name, None) is fn):
                    _patch(mod, name, wrap, self._undo)

    def uninstall(self):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo = []

    def bounds(self):
        """(K1s bound ms, segment-sum bound ms) summed over the calls."""
        from . import stats
        from .reference.search import candidates

        k1s = 0.0
        for valid_q, valid_t, window, mutual in self.k1s:
            n_cand = None
            if window is not None:
                n_cand = int(candidates(valid_q, valid_t, window).sum())
            k1s += stats.search_bound(int(valid_q.shape[0]),
                                      int(valid_t.shape[0]), mutual,
                                      window is not None, n_cand)
        seg = 0.0
        for shape, vsize, index, isize, n, has_init in self.segsum:
            kept = int(((index >= 0) & (index < n)).sum())
            cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            seg += stats.segment_bound(kept, shape[0], cols, n, vsize,
                                       isize, has_init)
        return k1s, seg
