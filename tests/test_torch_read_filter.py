"""The port's Pass 2 read filter (``pcr/read_filter.py``), which encodes
a slab of reads at once with numpy, against the JAX package's, which
rolls each read through the reference encoder: the same reads kept, in
the same order, for every k the CLI takes past the packed field and
below it, on reads with N runs, reads shorter than k, reads with bytes
the reference encoder rejects (lower case, ``X``, non-ASCII), slabs
split anywhere, one read far longer than the rest, and no primer k-mers
at all; and the timing tool's two window methods alike."""

import types

import numpy as np
import pytest

from sharkmer_tpu.ops.encoding import kmers_from_ascii_ref
from sharkmer_tpu.pcr.read_filter import PrimerReadFilter as JaxFilter
from sharkmer_tpu_torch.pcr import read_filter
from sharkmer_tpu_torch.pcr.read_filter import PrimerReadFilter
from sharkmer_tpu_torch.tools import filter_phase

from util import random_genome


def _reads(genome: str, rng) -> list:
    """Reads of ``genome`` (150 bp and shorter, some reverse-complemented,
    some with N runs or a rejected byte), as records with ``.sequence``."""
    comp = str.maketrans("ACGTN", "TGCAN")
    seqs = []
    for i in range(600):
        n = int(rng.choice([150, 150, 150, 80, 30, 18, 0]))
        p = int(rng.integers(0, len(genome) - 150))
        s = genome[p : p + n]
        if i % 2:
            s = s.translate(comp)[::-1]
        if i % 7 == 0 and n > 40:
            j = int(rng.integers(0, n - 5))
            s = s[:j] + "N" * int(rng.integers(1, 5)) + s[j + 5 :]
        if i % 29 == 0 and n:
            j = int(rng.integers(0, n))
            s = s[:j] + ["a", "X", "é"][i % 3] + s[j + 1 :]
        seqs.append(s)
    return [types.SimpleNamespace(sequence=s) for s in seqs]


@pytest.mark.parametrize("k", [19, 21, 25, 31])
@pytest.mark.parametrize("slab", [7, 1 << 14])
def test_filter_keeps_the_reads_the_jax_filter_keeps(monkeypatch, k, slab):
    # slabs of about ``slab`` reads of 150 bases
    monkeypatch.setattr(read_filter, "CELLS", 150 * slab)
    rng = np.random.default_rng(k)
    genome = random_genome(20_000, seed=k, n_rate=0.001)
    reads = _reads(genome, rng)
    # primer k-mers: some canonical k-mers of the genome, some random
    windows = [genome[p : p + k] for p in rng.integers(0, 20_000 - k, 30)]
    primers = {km for w in windows if "N" not in w
               for km in kmers_from_ascii_ref(w, k)}
    primers |= {int(x) for x in rng.integers(0, 1 << (2 * k), 10)}
    # decoys: windows across an N read as A, which no read holds
    for r in reads:
        j = r.sequence.find("N")
        if j >= k and "N" not in r.sequence[j + 1 : j + k]:
            decoy = r.sequence[j - k + 1 : j + 1].replace("N", "A")
            if set(decoy) <= set("ACGT"):
                primers |= set(kmers_from_ascii_ref(decoy, k))
    want = JaxFilter(primers, k).filter_reads(reads)
    got = PrimerReadFilter(primers, k).filter_reads(reads)
    assert [id(r) for r in got] == [id(r) for r in want]
    assert 10 < len(got) < len(reads)
    assert PrimerReadFilter(set(), k).filter_reads(reads) == []


@pytest.mark.parametrize("k", [21, 31])
def test_a_long_read_is_a_slab_alone(monkeypatch, k):
    """One 100 kb read among 150 bp ones, past a slab's CELLS: the same
    reads kept, the long read a slab alone, and every other slab within
    CELLS padded bases."""
    monkeypatch.setattr(read_filter, "CELLS", 50_000)
    rng = np.random.default_rng(k)
    genome = random_genome(120_000, seed=k, n_rate=0.001)
    reads = _reads(genome[:20_000], rng)
    long_read = types.SimpleNamespace(sequence=genome[10_000:110_000])
    reads = reads[:300] + [long_read] + reads[300:]
    primers = set(kmers_from_ascii_ref(genome[80_000 : 80_000 + k], k))
    primers |= {int(x) for x in rng.integers(0, 1 << (2 * k), 10)}
    shapes = []
    hits = PrimerReadFilter._hits

    def spy(self, seqs, primer_array):
        shapes.append((len(seqs), max(map(len, seqs))))
        return hits(self, seqs, primer_array)

    monkeypatch.setattr(PrimerReadFilter, "_hits", spy)
    want = JaxFilter(primers, k).filter_reads(reads)
    got = PrimerReadFilter(primers, k).filter_reads(reads)
    assert [id(r) for r in got] == [id(r) for r in want]
    assert long_read in got
    assert (1, 100_000) in shapes
    assert all(n * width <= 50_000 for n, width in shapes if n > 1)


def test_timing_tool_methods_agree():
    """``tools/filter_phase.py``: doubling and the k-step roll give the
    same windows, and filter_reads keeps the same reads with each."""
    rng = np.random.default_rng(3)
    for k in (1, 2, 19, 25, 31):
        base = rng.integers(0, 4, (5, 40)).astype(np.uint64)
        for reverse in (False, True):
            assert (filter_phase.roll_windows(base, k, reverse)
                    == read_filter._windows(base, k, reverse)).all()
    times = filter_phase.time_methods(filter_phase.reads(500), 21, 1)
    assert sorted(times) == ["doubling", "roll"]
