"""device_idle.chunked: share (%) of the traced window in which no
operation ran on the device: 1 - (union of the device operations'
intervals) / the window, from torch.profiler's trace."""


def read(ctx):
    if ctx.kind != "chunked" or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
