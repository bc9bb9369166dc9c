"""The window's seconds over the units (samples) finished in it."""


def read(ctx):
    return ctx["window_s"] / ctx["units"]
