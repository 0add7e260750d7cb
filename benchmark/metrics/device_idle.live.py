"""device_idle.live: share (%) of the traced window in which no operation
ran on the device, as device_idle.chunked, in the live cells."""


def read(ctx):
    if ctx.kind != "live" or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
