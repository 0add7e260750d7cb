"""frame_ms_p50: median over the window's frames of the host time from
handing a frame to `System.track_rgbd` to holding its pose (live cells)."""

from benchmark.stats import percentile


def read(ctx):
    ms = ctx.window.get("frame_ms")
    return percentile(ms, 50) if ms else None
