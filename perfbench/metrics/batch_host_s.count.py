"""Seconds a pass spends in the engine's host work on its batches: the
port's ``ingest.host`` spans (the valid-base count, ``lens.sum()``, the
chunk routing and row copies); the mean over the window's passes, from
the port's run records (the last ``units + 1`` less the measuring
unit's). Nothing where the port keeps no records."""


def read(ctx):
    if ctx["unit"] != "count":
        return None
    from sharkmer_tpu_torch.utils import phases

    records = getattr(phases, "records", None)
    n = ctx["units"]
    window = records()[-(n + 1):-1] if records else []
    if len(window) < n or not n:
        return None
    return sum(r.total("ingest.host").wall for r in window) / n
