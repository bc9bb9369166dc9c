"""The port store's reach closure against the JAX store's.

The same seeded reads or tables go to ``sharkmer_tpu`` (JAX on the CPU)
and ``sharkmer_tpu_torch`` (torch on the CPU, where ``probe_rows`` and
``reach_closure`` run their plain versions; ``tests/test_torch_probe.py``
holds the probe to the Pallas one). Keys and counts are integers, so every comparison is exact: a
closure must give the same keys, counts, ``complete`` flag, ``iters``
and boundary.
"""

import numpy as np
import pytest

from sharkmer_tpu.ops import ascii_to_codes, codes_to_batch
from sharkmer_tpu.ops import reach as jax_reach
from sharkmer_tpu.ops.encoding import revcomp_kmers_np, seq_to_kmer
from sharkmer_tpu.ops.sorted_store import SortedKmerStore as JaxStore
from sharkmer_tpu_torch.kernels import probe
from sharkmer_tpu_torch.ops import reach
from sharkmer_tpu_torch.ops.sorted_store import SortedKmerStore

from util import random_genome, reads_from_genome

EMPTY = np.uint64(0xFFFF_FFFF_FFFF_FFFF)


def _table(n_keys, width, k, seed, max_count=20):
    """A sorted partition: ``n_keys`` distinct canonical keys, counts in
    [1, max_count), sentinel tail up to ``width``."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << (2 * k), size=3 * n_keys, dtype=np.uint64)
    canon = np.unique(np.minimum(raw, revcomp_kmers_np(raw, k)))[:n_keys]
    assert len(canon) == n_keys
    keys = np.full(width, EMPTY, np.uint64)
    keys[:n_keys] = canon
    counts = np.zeros(width, np.uint32)
    counts[:n_keys] = rng.integers(1, max_count, size=n_keys)
    return keys, counts


# -- the store's reach against the JAX store's ---------------------------------


def _codes(genome, n_reads, read_len, seed):
    reads = reads_from_genome(genome, n_reads, read_len, seed=seed)
    return codes_to_batch([ascii_to_codes(r) for r in reads])


def _stores(codes, k, first_reads=0):
    """Both stores fed the same codes; ``first_reads`` go in a first
    batch that a query drains on its own (a ghosted first drain no
    wider than a partition)."""
    jstore = JaxStore.create(k)
    tstore = SortedKmerStore(k, "cpu")
    for s in (jstore, tstore):
        if first_reads:
            s.ingest_codes(codes[:first_reads])
            s.n_unique()
        s.ingest_codes(codes[first_reads:])
    assert tstore.to_dict() == jstore.to_dict()
    return jstore, tstore


def _assert_same(got, want):
    assert got is not None and want is not None
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert (got.complete, got.iters) == (want.complete, want.iters)
    np.testing.assert_array_equal(got.boundary, want.boundary)


@pytest.fixture(scope="module")
def genome_stores():
    genome = random_genome(1500, seed=4)
    return genome, _stores(_codes(genome, 750, 80, seed=1), 11)


def test_reach_complete_closure_matches_jax(genome_stores):
    genome, (jstore, tstore) = genome_stores
    roots = np.array([seq_to_kmer(genome[i : i + 11]) for i in (200, 1100)],
                     np.uint64)
    for mc in (1, 2, 3):
        want = jstore.reach(roots, min_count=mc, depth=4096)
        got = tstore.reach(roots, min_count=mc, depth=4096)
        _assert_same(got, want)
        assert got.complete and len(got.keys) > 100
    assert probe.probe_rows.launches == 0


def test_reach_depth_capped_and_warm_start_match_jax(genome_stores):
    """A depth-capped closure (boundary left), then a re-prefetch from
    its boundary warm-started with its interior, as PrefetchSession
    does."""
    genome, (jstore, tstore) = genome_stores
    roots = np.array([seq_to_kmer(genome[700 : 711])], np.uint64)
    want = jstore.reach(roots, min_count=1, depth=24)
    got = tstore.reach(roots, min_count=1, depth=24)
    _assert_same(got, want)
    assert not got.complete and len(got.boundary)
    roots2 = got.boundary[:8]
    pre = np.setdiff1d(got.keys, np.concatenate([got.boundary, roots2]))
    want2 = jstore.reach(roots2, min_count=1, depth=24, pre=pre)
    got2 = tstore.reach(roots2, min_count=1, depth=24, pre=pre)
    _assert_same(got2, want2)
    assert len(got2.keys) and not np.isin(pre, got2.keys).all()


def test_reach_multi_partition_matches_jax(monkeypatch):
    monkeypatch.setenv("SHARKMER_MAX_AGG", str(1 << 9))  # tiny partitions
    genome = random_genome(800, seed=6)
    jstore, tstore = _stores(_codes(genome, 300, 70, seed=7), 11,
                             first_reads=3)
    assert len(tstore._flushed().parts) > 2
    root = np.array([seq_to_kmer(genome[300:311])], np.uint64)
    got = tstore.reach(root, min_count=1, depth=4096)
    _assert_same(got, jstore.reach(root, min_count=1, depth=4096))
    # the closure crossed partitions
    assert len(got.keys) > 500


def test_reach_spill_past_out_w_matches_jax():
    """More visited rows than the OUT_W prefix: OUT_W + 4000 isolated
    keys, each its own root, all hit at the root level."""
    k = 21
    keys, counts = _table(reach.OUT_W + 4000, 1 << 15, k, seed=7, max_count=50)
    n = reach.OUT_W + 4000
    jstore = JaxStore.create(k)
    jstore.insert_kmers(keys[:n], counts[:n])
    tstore = SortedKmerStore.from_arrays(k, keys[:n], counts[:n], "cpu")
    want = jstore.reach(keys[:n], min_count=2, depth=64)
    got = tstore.reach(keys[:n], min_count=2, depth=64)
    _assert_same(got, want)
    assert got.complete and len(got.keys) == int((counts[:n] >= 2).sum())


def test_reach_overflow_returns_none():
    """A dense k = 9 table is one giant component: with no retries the
    narrow frontier overflows, and both closures give up (None)."""
    k = 9
    keys, counts = _table(60000, 1 << 16, k, seed=8)
    n = 60000
    jstore = JaxStore.create(k)
    jstore.insert_kmers(keys[:n], counts[:n])
    tstore = SortedKmerStore.from_arrays(k, keys[:n], counts[:n], "cpu")
    sidecars, _rc, bases = jstore._spcr_index()
    index = tstore._spcr_index()
    roots = keys[:1]
    assert jax_reach.reach(sidecars, bases, roots, 1, k, depth=64,
                           max_retries=0) is None
    assert reach.reach(index.table, roots, 1, k, depth=64,
                       max_retries=0) is None
