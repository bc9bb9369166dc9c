"""The plain reference against a count by hand, and the comparison's
numbers on tables that differ from it."""

from collections import Counter

import numpy as np
import pytest
import torch

from perfbench.reference import count as ref
from perfbench.reference import outputs

COMP = str.maketrans("ACGT", "TGCA")
READS = ["ACGTTGCAAC", "TTTTTGGGGA", "ACGTTGCANC", "GGGACGTTGC", "CATTTTTGG",
         "ACGTTGCAAC"]
K = 5
WIDTH = 12


def batch(reads):
    codes = np.full((len(reads), WIDTH), 5, np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = ["ACGTN".index(b) for b in r]
    return codes


def by_hand(reads, k):
    """Canonical k-mer counts of the reads: the lesser of a window and its
    reverse complement as a base-4 number; windows with N skipped."""
    counts = Counter()
    for r in reads:
        for i in range(len(r) - k + 1):
            w = r[i : i + k]
            if "N" in w:
                continue
            rc = w.translate(COMP)[::-1]
            counts[min(int(w.translate(str.maketrans("ACGT", "0123")), 4),
                       int(rc.translate(str.maketrans("ACGT", "0123")), 4))] += 1
    return counts


def spectrum_by_hand(counts, histo_max):
    out = np.zeros(histo_max + 2, np.uint64)
    for c in counts.values():
        out[min(c, histo_max + 1)] += 1
    return out


@pytest.mark.parametrize("batch_reads", [2, 4, 6])
def test_recount_equals_hand_count(batch_reads):
    keys, counts, spectra = ref.table(batch(READS), batch_reads, K, 1, 3,
                                      "cpu")
    want = by_hand(READS, K)
    assert keys.tolist() == sorted(want)
    assert counts.tolist() == [want[x] for x in sorted(want)]
    assert len(spectra) == 1
    assert spectra[0].tolist() == spectrum_by_hand(want, 3).tolist()


def test_chunk_snapshots_by_hand(monkeypatch):
    """Read i goes to chunk (i // turn) % n; snapshot c holds chunks 0..c."""
    monkeypatch.setattr(ref, "READS_PER_TURN", 2)
    _k, _c, spectra = ref.table(batch(READS), 4, K, 2, 3, "cpu")
    first = [r for i, r in enumerate(READS) if (i // 2) % 2 == 0]
    assert spectra[0].tolist() == spectrum_by_hand(by_hand(first, K),
                                                   3).tolist()
    assert spectra[1].tolist() == spectrum_by_hand(by_hand(READS, K),
                                                   3).tolist()


def test_no_snapshot_without_chunks():
    assert ref.table(batch(READS), 4, K, 0, 3, "cpu")[2] == []


def test_slabs_cover_the_key_range():
    b = ref._bounds(19)
    assert b[0] == 0 and b[-1] == 4 ** 19 and b == sorted(b)
    assert len(b) == ref.SLABS + 1


def judged(keys, counts, spectra):
    return ref.compare(batch(READS), 4, K, 1, 3, "cpu", keys, counts,
                       [spectra])


def test_compare_reads_zero_on_the_recount():
    keys, counts, spectra = ref.table(batch(READS), 4, K, 1, 3, "cpu")
    assert judged(keys, counts, spectra) == {
        "keys_wrong": 0, "spectra_bins_wrong": 0, "bins_by_unit": [0]}


def test_compare_counts_each_kind_of_fault():
    keys, counts, spectra = ref.table(batch(READS), 4, K, 1, 3, "cpu")
    c = counts.clone()
    c[0] += 1  # a count wrong
    assert judged(keys, c, spectra)["keys_wrong"] == 1
    # a key missing; an extra key
    assert judged(keys[1:], counts[1:], spectra)["keys_wrong"] == 1
    extra = torch.cat([keys, torch.tensor([4 ** K - 1])])
    assert judged(extra, torch.cat([counts, torch.tensor([1])]),
                  spectra)["keys_wrong"] == 1
    bad = [s.copy() for s in spectra]
    bad[0][1] += 1
    assert judged(keys, counts, bad)["spectra_bins_wrong"] == 1
    assert judged(keys, counts, [])["spectra_bins_wrong"] == 3 + 2


def test_control_fails_where_counts_pass_the_cap():
    keys, counts, spectra = ref.table(batch(READS), 4, K, 1, 3, "cpu",
                                      count_cap=1)
    found = judged(keys, counts, spectra)
    assert found["keys_wrong"] == int((by_hand_counts() > 1).sum()) > 0
    assert found["spectra_bins_wrong"] > 0


def by_hand_counts():
    return np.array(list(by_hand(READS, K).values()))


def test_product_subst():
    amp = "ACGTACGGTTCAGT"
    assert outputs.product_subst(amp, amp) == 0
    rc = amp.translate(COMP)[::-1]
    assert outputs.product_subst(rc, amp) == 0
    assert outputs.product_subst("ACGTACGGTTCAGA", amp) == 1
    # a stretch of the product, or one base more, is not the product
    assert outputs.product_subst(amp[:9], amp) == 5
    assert outputs.product_subst(amp[2:], amp) > 0
    assert outputs.product_subst(amp + "A", amp) == 1
    assert outputs.product_subst(rc[:-3], amp) >= 3


def test_expected_products_trim_the_primers(tmp_path):
    """A primer longer than its trim loses its 5' bases; trim is at most
    k - 1, and 15 where the pair gives none."""
    panel = tmp_path / "panel.yaml"
    panel.write_text(
        "primers:\n"
        "- {gene: a, forward_seq: AAAACCCCGG, reverse_seq: TTTGGG, trim: 8}\n"
        "- {gene: b, forward_seq: ACGTACGTACGTACGTAC, reverse_seq: GGG}\n"
        "- {gene: c, forward_seq: ACGTACGTACGTACGTAC, reverse_seq: GGG,"
        " trim: 20}\n")
    amps = ["AAAACCCCGG" + "TTTT" + "CCCAAA",
            "ACGTACGTACGTACGTAC" + "TT" + "CCC",
            "ACGTACGTACGTACGTAC" + "TT" + "CCC"]
    want = ["AACCCCGG" + "TTTT" + "CCCAAA",
            "ACGTACGTACGTACGTAC"[3:] + "TT" + "CCC",
            "ACGTACGTACGTACGTAC"[3:] + "TT" + "CCC"]
    assert outputs.expected_products(str(panel), amps, 16) == want


def test_stats_wrong(tmp_path):
    path = tmp_path / "s.stats.yaml"
    path.write_text("n_reads_read: 4\nn_bases_read: 40\n"
                    "n_subreads_ingested: 4\nn_bases_ingested: 40\n"
                    "n_kmers: 24\n")
    assert outputs.stats_wrong(str(path), 4, 40, 24) == 0
    assert outputs.stats_wrong(str(path), 4, 40, 25) == 1
    assert outputs.stats_wrong(str(tmp_path / "none"), 4, 40, 24) == 5
