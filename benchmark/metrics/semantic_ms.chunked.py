"""semantic_ms.chunked: device ms per frame of the semantic layer: the
detector's and the dynamic cull's stages of the chunked tracker, summed
over the window / its frames."""


def read(ctx):
    if ctx.kind != "chunked" or not ctx.stages:
        return None
    return ctx.stage_ms({"detector", "cull"}) / ctx.window["frames"]
