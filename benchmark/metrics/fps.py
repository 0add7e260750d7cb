"""fps: frames handed over in the window / the window's wall time, which
ends after the final flush and a synchronise (chunked cells)."""


def read(ctx):
    if ctx.kind != "chunked":
        return None
    return ctx.window["frames"] / ctx.window["seconds"]
