"""The closure table of ``chip_smoke.py`` (phases 3, 13, 18 and 23 hold
``reach_closure`` and ``probe_rows`` to their plain versions on it),
built on the CPU.

Its random genome holds a few 19-mers more than once, and
``closure_table`` draws a count for each occurrence. Written with one
``index_put_``, the repeated rows took whichever occurrence's count
landed, which CUDA leaves undefined, so two builds on the card could
differ in those rows. ``closure_table`` now gives each repeated row its
first occurrence's count, resolved on the host (``genome_counts``), so
every build is the same table.
"""

import importlib.util
import os

import numpy as np
import torch

from sharkmer_tpu_torch.ops.histogram import revcomp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 1 << 21  # the smallest table that holds the genome's k-mers


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _drawn_counts(cs, n_real: int, n_k: int):
    """``closure_table``'s draws from default_rng(4), in its order: the
    genome and filler, the rows' counts, the genome occurrences'
    counts."""
    rng = np.random.default_rng(4)
    rng.integers(0, 4, size=cs.GENOME_BASES)
    rng.integers(0, 1 << (2 * cs.K), size=ROWS * 3 // 4 - n_k)
    rng.integers(1, 40, size=n_real)
    g_counts = rng.integers(cs.CLOSURE_MC, 40, size=n_k)
    g_counts[rng.random(n_k) < 1e-4] = 1
    return g_counts


def test_repeated_kmers_take_their_first_occurrences_count():
    """The genome of the closure table repeats some 19-mers, with other
    counts drawn for their occurrences; each such row holds its first
    occurrence's count, every other genome row its one occurrence's, and
    two builds are equal."""
    cs = _chip_smoke()
    keys, counts, n_real, fwd = cs.closure_table(np, torch, ROWS, cs.K,
                                                 device="cpu")
    again = cs.closure_table(np, torch, ROWS, cs.K, device="cpu")
    assert torch.equal(keys, again[0]) and torch.equal(counts, again[1])
    g = torch.from_numpy(fwd)
    canonical = torch.minimum(g, revcomp(g, cs.K)).numpy()
    once, first, seen = np.unique(canonical, return_index=True,
                                  return_counts=True)
    g_counts = _drawn_counts(cs, n_real, fwd.shape[0])
    rows = torch.searchsorted(keys[:n_real], torch.from_numpy(once))
    assert torch.equal(keys[rows], torch.from_numpy(once))
    assert torch.equal(counts[rows], torch.from_numpy(g_counts[first]))
    repeated = np.nonzero(seen > 1)[0]
    assert repeated.size > 0
    # the repeats were drawn other counts than their first occurrence's
    # somewhere, so which one lands matters
    assert any(len({int(g_counts[i]) for i in
                    np.nonzero(canonical == once[r])[0]}) > 1
               for r in repeated)


def test_genome_counts_resolves_repeats_on_the_host():
    """A genome whose k-mers repeat, forward and as reverse complements:
    each row once, with the count of the k-mer's first occurrence."""
    cs = _chip_smoke()
    k = 5
    fwd = np.array([3, 100, 3, 7, int(revcomp(torch.tensor([100]), k)[0]),
                    7, 42], np.int64)
    canonical = torch.minimum(torch.from_numpy(fwd),
                              revcomp(torch.from_numpy(fwd), k))
    uniq = torch.unique(torch.cat([canonical, torch.tensor([1, 999])]))
    rows, drawn = cs.genome_counts(np, torch, uniq, fwd,
                                   np.array([10, 11, 12, 13, 14, 15, 16]), k)
    assert rows.tolist() == torch.searchsorted(
        uniq, torch.unique(canonical)).tolist()
    by_key = dict(zip(uniq[rows].tolist(), drawn.tolist()))
    assert by_key == {3: 10, int(canonical[1]): 11, 7: 13, 42: 16}
