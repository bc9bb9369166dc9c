"""Seconds a pass waits in host syncs (the port's ``utils/phases.sync``)
inside its ``ingest.batch`` and ``consolidate`` spans: each blocking
call's wall; the mean over the window's passes, from the port's run
records (the last ``units + 1`` less the measuring unit's). Nothing
where the port keeps no records."""


def read(ctx):
    if ctx["unit"] != "count":
        return None
    from sharkmer_tpu_torch.utils import phases

    records = getattr(phases, "records", None)
    n = ctx["units"]
    window = records()[-(n + 1):-1] if records else []
    if len(window) < n or not n:
        return None
    return sum(r.syncs("ingest.batch", "consolidate")[1]
               for r in window) / n
