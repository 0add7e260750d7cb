"""track_ms.live: device ms per frame of tracking in `System.track_rgbd`
(the "track" stage), over the window's frames that inserted no
keyframe."""


def read(ctx):
    if ctx.kind != "live" or not ctx.stages:
        return None
    plain = ctx.plain_frames()
    return ctx.stage_ms({"track"}, plain) / max(1, len(plain))
