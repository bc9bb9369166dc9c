"""Primer-kmer read filter for per-gene read selection (Pass 2).

Reference: upstream sharkmer src/pcr/read_filter.rs — keep only reads
containing at least one primer-derived canonical k-mer.
"""

from __future__ import annotations

import numpy as np

from .counts import SmallCounts

# a read byte's base code: 0-3 for ACGT, 4 for N (it breaks the k-mer
# frame), 5 for any byte the reference encoder rejects ("?" stands for a
# character past ASCII)
_CODES = np.array([b"ACGTN".find(c) % 6 for c in range(256)], np.uint8)
# the padded bases a slab of filter_reads holds (reads x its longest
# read): a read longer than that is a slab alone
CELLS = 1 << 21


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

    def filter_reads(self, reads):
        """The reads holding one of the primer k-mers, in order: each
        slab (``_slabs``) encoded at once with numpy (the canonical k-mer
        of every window free of N, as the reference encoder
        ``kmers_from_ascii_ref`` rolls it) and probed against the sorted
        primer k-mers. A read with a byte the reference encoder rejects
        is left out."""
        if not self.primer_kmers:
            return []
        primers = np.array(sorted(self.primer_kmers), np.uint64)
        kept = []
        for slab in _slabs(reads):
            hits = self._hits([r.sequence for r in slab], primers)
            kept.extend(r for r, hit in zip(slab, hits) if hit)
        return kept

    def _hits(self, seqs: list[str], primers: np.ndarray) -> np.ndarray:
        """For each sequence, whether one of its canonical k-mers is in
        the sorted ``primers`` and every byte is one the reference
        encoder takes."""
        k, n = self.k, len(seqs)
        # one byte a character: "?" for each past ASCII
        flat = _CODES[np.frombuffer("".join(seqs).encode("ascii", "replace"),
                                    np.uint8)]
        lens = np.fromiter(map(len, seqs), np.int64, n)
        width = int(lens.max(initial=0))
        if width < k:
            return np.zeros(n, bool)
        if (lens == width).all():
            codes = flat.reshape(n, width)
        else:
            codes = np.full((n, width), 4, np.uint8)  # padding breaks frames
            ends = np.cumsum(lens)
            codes[np.repeat(np.arange(n), lens),
                  np.arange(flat.size) - np.repeat(ends - lens, lens)] = flat
        base = (codes & 3).astype(np.uint64)
        fwd, rev = _windows(base, k), _windows(np.uint64(3) - base, k,
                                               reverse=True)
        n_win = width - k + 1
        breaks = np.zeros((n, width + 1), np.int32)
        np.cumsum(codes >= 4, axis=1, out=breaks[:, 1:])
        whole = breaks[:, k:] == breaks[:, :n_win]  # no N in the window
        canon = np.minimum(fwd, rev)
        at = np.minimum(np.searchsorted(primers, canon), primers.size - 1)
        found = (primers[at] == canon) & whole
        return found.any(axis=1) & ~(codes == 5).any(axis=1)


def _slabs(reads):
    """``reads`` in order, cut where a slab's reads times its longest read
    would pass CELLS."""
    slab, width = [], 0
    for read in reads:
        longest = max(width, len(read.sequence))
        if slab and (len(slab) + 1) * longest > CELLS:
            yield slab
            slab, longest = [], len(read.sequence)
        slab.append(read)
        width = longest
    if slab:
        yield slab


def _windows(base: np.ndarray, k: int, reverse: bool = False) -> np.ndarray:
    """Every k-base window of each row of 2-bit ``base`` codes as one
    word, its first base highest (``reverse``: lowest, the reverse
    complement's order when ``base`` holds the complements), built by
    doubling the window length (log k steps) rather than by k shifts
    (``tools/filter_phase.py`` times both)."""

    def join(left, right, left_bases, right_bases):
        # left covers [j, j + left_bases), right the bases after it
        if reverse:
            return left | (right << np.uint64(2 * left_bases))
        return (left << np.uint64(2 * right_bases)) | right

    powers = {1: base}  # bases a window holds -> the windows
    m = 1
    while 2 * m <= k:
        half = powers[m]
        powers[2 * m] = join(half[:, : half.shape[1] - m], half[:, m:], m, m)
        m *= 2
    out, length = powers[m], m
    for b in sorted(powers, reverse=True):
        if b & k and b != m:
            part = powers[b][:, length:]
            out = join(out[:, : part.shape[1]], part, length, b)
            length += b
    return out
