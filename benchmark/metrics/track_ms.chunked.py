"""track_ms.chunked: device ms per frame of each chunk's first tracking
pass (local points, searches, motion-only BA, keyframe decision), summed
over the window / its frames."""


def read(ctx):
    if ctx.kind != "chunked" or not ctx.stages:
        return None
    return ctx.stage_ms({"track"}) / ctx.window["frames"]
