"""launches.chunked: kernels launched on the device per frame of the
traced window (the profiler's kernel count / the window's frames)."""


def read(ctx):
    if ctx.kind != "chunked" or ctx.trace is None:
        return None
    return ctx.trace["kernels"] / ctx.window["frames"]
