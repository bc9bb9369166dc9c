"""Seconds a pass spends in ``CountingEngine.consolidate()`` (the
stores' last drains and merges, ``merge_from`` of the chunk stores, the
spectra), ended by a synchronise; the mean over the window's passes."""


def read(ctx):
    walls = (ctx["spans"].get("consolidate") if ctx["unit"] == "count"
             else None)
    return sum(walls) / len(walls) if walls else None
