"""Seconds from the process's start to the window's: imports, the CUDA
context, kernel loads (a checkout's first run also builds them), the
sample made, one whole unit."""


def read(ctx):
    return ctx["setup_s"]
