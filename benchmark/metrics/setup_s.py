"""setup_s: seconds from the process's start to the window's start:
imports, the card's first touch, the kernels' build where the checkout
has none yet, rendering the frames, building the program and warming it."""


def read(ctx):
    return ctx.setup_s
