"""extract_ms.chunked: device ms per frame of the front end (ORB
extraction and the depth lookup): CUDA events at the chunked tracker's
"begin" and "extract" marks, summed over the window / its frames."""


def read(ctx):
    if ctx.kind != "chunked" or not ctx.stages:
        return None
    return ctx.stage_ms({"extract"}) / ctx.window["frames"]
