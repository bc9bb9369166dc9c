"""Seconds a sample spends in reach closures: the ``closures`` phase the
port's ``ops/reach`` adds to ``utils/phases`` (each call's wall, summed
over the gene threads that call it), the mean over the window's
samples."""


def read(ctx):
    if ctx["unit"] != "sample":
        return None
    walls = [p["closures"][0] for p in ctx.get("phases") or []
             if "closures" in p]
    return sum(walls) / len(walls) if walls else None
