"""frame_ms_p95: the 95th percentile of the same per-frame times as
frame_ms_p50 (live cells): the highest percentile with ten samples or
more beyond it at ~270 frames, and inside the keyframe frames, which are
9-14% of a window (local BA inline), where a 90th percentile would sit on
the edge between plain and keyframe frames."""

from benchmark.stats import percentile


def read(ctx):
    ms = ctx.window.get("frame_ms")
    return percentile(ms, 95) if ms else None
