"""insert_ms.chunked: device ms per frame of the keyframe back end in the
chunked tracker's insertion rounds (insertion with the back-end pass, and
the re-track after it), summed over the window / its frames; nothing where
the window inserted no keyframe."""

ROUNDS = {"insert1", "retrack1", "insert2", "retrack2"}


def read(ctx):
    if ctx.kind != "chunked" or not any(n in ROUNDS for n, _, _ in ctx.stages):
        return None
    return ctx.stage_ms(ROUNDS) / ctx.window["frames"]
