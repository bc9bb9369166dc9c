"""Seconds a sample spends counting: its ingest and ``consolidate()``,
each ended by a synchronise; the mean over the window's samples."""


def read(ctx):
    walls = ctx["spans"].get("count") if ctx["unit"] == "sample" else None
    return sum(walls) / len(walls) if walls else None
