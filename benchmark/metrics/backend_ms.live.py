"""backend_ms.live: device ms per keyframe of the back-end pass (point
culling, triangulation, fusion, local BA, keyframe culling): CUDA events
at `Tracker.on_backend_stage`, summed over the window's passes / passes."""

STAGES = {"cull", "triangulate", "fuse", "ba", "kf_cull"}


def read(ctx):
    if ctx.kind != "live" or not ctx.backend:
        return None
    passes = sum(1 for n, _, _ in ctx.backend if n == "kf_cull")
    if not passes:
        return None
    return sum(ms for n, ms, _ in ctx.backend if n in STAGES) / passes
