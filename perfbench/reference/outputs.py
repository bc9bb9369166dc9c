"""The sample traffic's outputs held to what the generator embedded.

Each primer pair's amplicon is the generator's record, and the product
it implies runs from primer to primer (``expected_products``); a run's
products for the pair are the sequences of its FASTA file, each read on
the strand that fits it better (``product_subst``). The run totals of
``stats.yaml`` follow from the reads alone.
"""

from __future__ import annotations

import os

import numpy as np
import yaml

_COMP = str.maketrans("ACGT", "TGCA")
DEFAULT_TRIM = 15  # upstream sharkmer's primer trim where a pair sets none


def fasta_seqs(path: str) -> list[str]:
    """The sequences of a FASTA file ([] if there is none)."""
    if not os.path.exists(path):
        return []
    seqs = []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                seqs.append("")
            elif seqs:
                seqs[-1] += line.strip()
    return seqs


def expected_products(panel_file: str, amplicons: list[str],
                      k: int) -> list[str]:
    """The product sPCR should write for each pair's amplicon, primer to
    primer: upstream sharkmer seeds each primer on its 3'-most ``trim``
    bases (the pair's ``trim``, 15 where it gives none, at most k - 1),
    so a longer primer's 5' bases are not part of the product."""
    with open(panel_file) as f:
        pairs = [p for p in yaml.safe_load(f)["primers"]
                 if not p.get("deprecated")]
    if len(pairs) != len(amplicons):
        raise ValueError(f"{len(pairs)} pairs, {len(amplicons)} amplicons")
    out = []
    for p, amp in zip(pairs, amplicons):
        trim = min(int(p.get("trim", DEFAULT_TRIM)), k - 1)
        cut_f = max(len(p["forward_seq"]) - trim, 0)
        cut_r = max(len(p["reverse_seq"]) - trim, 0)
        out.append(amp[cut_f : len(amp) - cut_r])
    return out


def product_subst(product: str, expected: str) -> int:
    """Substitutions between a product and the expected one, on the
    strand that reads fewer: bases that differ from the start, plus one
    for each base by which the lengths differ (0 only for the expected
    product, whole)."""
    want = np.frombuffer(expected.encode(), np.uint8)
    best = None
    for s in (product, product.translate(_COMP)[::-1]):
        seq = np.frombuffer(s.encode(), np.uint8)
        m = min(len(seq), len(want))
        d = abs(len(seq) - len(want)) + int((seq[:m] != want[:m]).sum())
        best = d if best is None else min(best, d)
    return best


def stats_wrong(path: str, n_reads: int, n_bases: int, n_events: int) -> int:
    """Run totals of a ``stats.yaml`` that differ from the reads' own (a
    missing file counts all five)."""
    want = {"n_reads_read": n_reads, "n_bases_read": n_bases,
            "n_subreads_ingested": n_reads, "n_bases_ingested": n_bases,
            "n_kmers": n_events}
    if not os.path.exists(path):
        return len(want)
    with open(path) as f:
        got = yaml.safe_load(f) or {}
    return sum(got.get(key) != value for key, value in want.items())
