"""extract_ms.live: device ms per frame of the front end in
`System.track_rgbd` (CUDA events at its "detector" and "extract" marks),
over the window's frames that inserted no keyframe."""


def read(ctx):
    if ctx.kind != "live" or not ctx.stages:
        return None
    plain = ctx.plain_frames()
    return ctx.stage_ms({"extract"}, plain) / max(1, len(plain))
