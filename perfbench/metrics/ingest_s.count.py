"""Seconds a pass spends in the engine's ingest: every batch through
``CountingEngine.ingest_code_batch`` (the host's valid-base count, the
upload, ``ops/encoding``, the store's inserts and drains), ended by a
synchronise; the mean over the window's passes."""


def read(ctx):
    walls = ctx["spans"].get("ingest") if ctx["unit"] == "count" else None
    return sum(walls) / len(walls) if walls else None
