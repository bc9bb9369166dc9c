"""The count path's hand-written kernels (``run_ends``, ``run_starts``,
``stitch_rows``, ``hash_insert``) against their least time, in percent:
the sum over the window's launches of each launch's least time (its
bytes over the card's memory rate) over the sum of their device time in
the profile. Nothing where no wrapped kernel ran or a launch's time or
bytes could not be read."""


def read(ctx):
    trace = ctx.get("trace") or {}
    if ctx["unit"] != "count" or "kernel_least_s" not in trace:
        return None
    times = [t for v in trace.get("kernel_device_s", {}).values() for t in v]
    if len(times) != trace.get("kernel_launches") or sum(times) <= 0:
        return None
    return 100.0 * trace["kernel_least_s"] / sum(times)
