"""stereo_ms.chunked: device ms per frame of the stereo front end's SAD
search (`ops/stereo.stereo_match`): CUDA events at the stereo chunk's
"stereo" marks, each after a frame's search and timed from that frame's
"extract" mark after its ORB half, summed over the window / its frames;
nothing where no "stereo" stage was marked (an RGB-D cell, or a program
whose stereo chunk marks its extraction once)."""


def read(ctx):
    if ctx.kind != "chunked" or not any(n == "stereo"
                                        for n, _, _ in ctx.stages):
        return None
    return ctx.stage_ms({"stereo"}) / ctx.window["frames"]
