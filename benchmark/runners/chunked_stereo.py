"""The chunked semantic pipeline on a rectified stereo camera,
`ChunkedSemanticStereoTracker`: the chunked runner (`runners/chunked.py`:
set-up, window, trajectory) handing over (left, right) pairs where the
RGB-D runner hands over (gray, depth). Extraction takes depth from the
epipolar SAD search (`tracking.extract_frame_stereo`); the detector and
the cull see the left image. The program's stereo runner drives no
mapper, and neither does the RGB-D chunked runner. The module is
`chunked_stereo`; its family, `Runner.kind`, stays "chunked"."""

from __future__ import annotations

from . import chunked


class Runner(chunked.Runner):
    views = ("gray", "gray_r")

    @staticmethod
    def _tracker():
        from sgslam_tpu_torch.slam.scan_pipeline import (
            ChunkedSemanticStereoTracker)
        return ChunkedSemanticStereoTracker
