"""Host syncs of a pass: the calls that block the host on the card (the
port's ``utils/phases.sync``: reads to the host, masks, pageable uploads)
charged inside its ``ingest.batch`` and ``consolidate`` spans; the mean
over the window's passes. Read from the port's run records, one a
``CountingEngine``: the window's are the last ``units + 1`` less the
last, the measuring unit's. Nothing where the port keeps no records."""


def read(ctx):
    if ctx["unit"] != "count":
        return None
    from sharkmer_tpu_torch.utils import phases

    records = getattr(phases, "records", None)
    n = ctx["units"]
    window = records()[-(n + 1):-1] if records else []
    if len(window) < n or not n:
        return None
    return sum(r.syncs("ingest.batch", "consolidate")[0]
               for r in window) / n
