"""Seconds a pass spends making its spectra: the self time of the port's
``consolidate.spectrum`` spans, one a snapshot (the drains and merges a
sorted store's first snapshot flushes are spans of their own); the mean
over the window's passes, from the port's run records (the last
``units + 1`` less the measuring unit's). Nothing where the port keeps
no records."""


def read(ctx):
    if ctx["unit"] != "count":
        return None
    from sharkmer_tpu_torch.utils import phases

    records = getattr(phases, "records", None)
    n = ctx["units"]
    window = records()[-(n + 1):-1] if records else []
    if len(window) < n or not n:
        return None
    return sum(r.total("consolidate.spectrum").self_s for r in window) / n
