"""semantic_ms.live: device ms per frame of the detector and the dynamic
cull in `System.track_rgbd`, over the window's frames that inserted no
keyframe."""


def read(ctx):
    if ctx.kind != "live" or not ctx.stages:
        return None
    plain = ctx.plain_frames()
    return ctx.stage_ms({"detector", "cull"}, plain) / max(1, len(plain))
