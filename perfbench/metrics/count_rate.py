"""k-mer events counted in the window over the window's seconds: every
unit in it is whole, so this is all its work over all its time."""


def read(ctx):
    return ctx["events"] / ctx["window_s"] if ctx["events"] else None
