"""The card's idle share of the traced window of samples, in percent:
the window less the union of its kernels, copies and sets in the
profile."""


def read(ctx):
    trace = ctx.get("trace") or {}
    if ctx["unit"] != "sample" or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
