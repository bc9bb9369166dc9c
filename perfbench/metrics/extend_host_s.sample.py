"""Seconds a sample's genes spend in host graph extension: the self time
of the port's ``spcr.extend`` spans (their reach calls and closures left
out), summed over the genes; the mean over the window's samples, from
the port's run records (the last ``units + 1`` less the measuring
unit's). Nothing where the port keeps no records."""


def read(ctx):
    if ctx["unit"] != "sample":
        return None
    from sharkmer_tpu_torch.utils import phases

    records = getattr(phases, "records", None)
    n = ctx["units"]
    window = records()[-(n + 1):-1] if records else []
    if len(window) < n or not n:
        return None
    return sum(r.total("spcr.extend").self_s for r in window) / n
