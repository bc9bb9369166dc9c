"""Seconds a sample spends in ``stats.run_pcr`` over the panel (the
lookup table's warm-up, the panel scans, the closures, the gene threads'
graph extension, the FASTA files); the mean over the window's samples."""


def read(ctx):
    walls = ctx["spans"].get("spcr") if ctx["unit"] == "sample" else None
    return sum(walls) / len(walls) if walls else None
