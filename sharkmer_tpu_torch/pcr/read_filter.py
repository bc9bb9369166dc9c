"""Primer-kmer read filter for per-gene read selection (Pass 2).

Reference: upstream sharkmer src/pcr/read_filter.rs — keep only reads
containing at least one primer-derived canonical k-mer.
"""

from __future__ import annotations

from ..ops.encoding import kmers_from_ascii_ref
from .counts import SmallCounts


class PrimerReadFilter:
    def __init__(self, primer_kmers: set[int], k: int):
        self.primer_kmers = primer_kmers
        self.k = k

    @classmethod
    def from_primer_kmers(
        cls, forward: SmallCounts, reverse: SmallCounts, k: int
    ) -> "PrimerReadFilter":
        kmers = set(forward.kmers()) | set(reverse.kmers())
        return cls(kmers, k)

    def matches(self, sequence: str) -> bool:
        try:
            kmers = kmers_from_ascii_ref(sequence, self.k)
        except ValueError:
            return False
        return any(km in self.primer_kmers for km in kmers)

    def filter_reads(self, reads):
        return [r for r in reads if self.matches(r.sequence)]
