"""Synthetic read generation for offline benchmark runs.

The reference's benchmark grid streams real ENA accessions
(upstream sharkmer benchmarks/run_benchmark.py); in air-gapped
environments this module synthesizes an equivalent workload instead: a
random genome with every panel primer pair's amplicon embedded at
high copy number (panel targets are rRNA repeats / mitochondrial
genes), sampled into fixed-length reads with Illumina-like uniform
substitution errors, written as gzip FASTQ. One file per
(panel, seed) at the deepest depth; shallower depths reuse it through
the CLI's --max-reads.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
GEN_SLAB = 250_000  # reads per write slab (bounds temporaries)


def _panel_params(panel_path: Path):
    from sharkmer_tpu_torch.pcr.panels import (
        filter_deprecated_primers, parse_panel_yaml,
        resolve_primer_gene_names,
    )

    panel = parse_panel_yaml(Path(panel_path).read_text())
    primers = filter_deprecated_primers(panel.primers, panel.name)
    resolve_primer_gene_names(primers, panel.name)
    return primers


def synthesize_panel_fastq(
    panel_path: Path,
    out_path: Path,
    n_reads: int,
    read_len: int = 150,
    genome_mbp: float = 20.0,
    error_rate: float = 0.01,
    seed: int = 0,
) -> Path:
    """Write ``n_reads`` synthetic reads covering ``panel_path``'s
    amplicons to ``out_path`` (gzip FASTQ). Idempotent per path."""
    from sharkmer_tpu_torch.pcr.params import IUPAC

    out_path = Path(out_path)
    if out_path.exists():
        return out_path
    out_path.parent.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=int(genome_mbp * 1e6), dtype=np.uint8)
    pos = 1000
    for p in _panel_params(panel_path):
        fwd = "".join(
            c if c in "ACGT" else rng.choice(list(IUPAC[c]))
            for c in p.forward_seq
        )
        rev = "".join(
            c if c in "ACGT" else rng.choice(list(IUPAC[c]))
            for c in p.reverse_seq
        )
        total = p.expected_length or (p.min_length + p.max_length) // 2
        insert = "".join(
            rng.choice(list("ACGT"), size=total - len(fwd) - len(rev))
        )
        amp = fwd + insert + "".join(_COMP[b] for b in reversed(rev))
        codes = np.frombuffer(amp.encode(), np.uint8)
        lut = np.full(256, 0, np.uint8)
        for i, b in enumerate("ACGT"):
            lut[ord(b)] = i
        codes = lut[codes]
        # 8 copies: amplicon k-mers sit well above min_count at the
        # sweep's genome-wide coverages, like real high-copy targets
        for _ in range(8):
            genome[pos : pos + len(codes)] = codes
            pos += len(codes) + 2000

    col = np.arange(read_len)[None, :]
    qual = b"I" * read_len
    tmp = out_path.with_suffix(".tmp.gz")
    with gzip.open(tmp, "wb", compresslevel=1) as f:
        written = 0
        while written < n_reads:
            n = min(GEN_SLAB, n_reads - written)
            starts = rng.integers(0, len(genome) - read_len, size=n)
            reads = genome[starts[:, None] + col]
            if error_rate > 0.0:
                err = rng.random(reads.shape) < error_rate
                shift = rng.integers(1, 4, size=reads.shape, dtype=np.uint8)
                reads = np.where(err, (reads + shift) % 4, reads)
            seqs = _BASES[reads]
            chunk = bytearray()
            for i in range(n):
                chunk += b"@r%d\n" % (written + i)
                chunk += seqs[i].tobytes()
                chunk += b"\n+\n"
                chunk += qual
                chunk += b"\n"
            f.write(bytes(chunk))
            written += n
    tmp.rename(out_path)
    return out_path
