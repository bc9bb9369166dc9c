"""The port's encoding and sorted store against the JAX package's.

The same seeded numpy inputs go through ``sharkmer_tpu`` (JAX on the
CPU) and ``sharkmer_tpu_torch`` (torch on the CPU, where each kernel
wrapper runs its plain version). All data is integer, so every
comparison is exact.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkmer_tpu.ops import encoding as jax_encoding
from sharkmer_tpu.ops.sorted_store import SortedKmerStore as JaxStore
from sharkmer_tpu.pcr.primers import string_to_oligo
from sharkmer_tpu_torch.ops import encoding
from sharkmer_tpu_torch.ops.histogram import revcomp
from sharkmer_tpu_torch.ops.keys import (
    SENTINEL,
    keys_to_device,
    keys_to_numpy,
    pack,
    unpack,
)
from sharkmer_tpu_torch.ops.sorted_store import SortedKmerStore

from util import random_genome, reads_from_genome

MAX_AGG = 1 << 14  # forces many drains, staged merges and partition splits


def _codes(n_reads, width, seed):
    """A code batch with bases, N codes and ragged pad tails."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n_reads, width), dtype=np.uint8)
    codes[rng.random((n_reads, width)) < 0.01] = encoding.CODE_N
    lens = rng.integers(width // 2, width + 1, size=n_reads)
    codes[np.arange(width)[None, :] >= lens[:, None]] = encoding.CODE_PAD
    return codes


@pytest.mark.parametrize("k", [17, 19, 21, 31])
def test_canonical_kmers_matches_jax(k):
    codes = _codes(300, 96, seed=k)
    want_k, want_v = jax_encoding.canonical_kmers(jnp.asarray(codes), k)
    got_k = encoding.canonical_kmers(torch.from_numpy(codes), k)
    got_v = got_k != SENTINEL  # the valid windows: no k-mer is the sentinel
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(
        keys_to_numpy(got_k.reshape(-1)), np.asarray(want_k).reshape(-1)
    )
    assert not bool(got_v.all()) and bool(got_v.any())  # N and pad seen


def test_key_codec_round_trip():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 62, size=1000, dtype=np.uint64)
    keys[::7] = jax_encoding.KMER_SENTINEL
    dev = keys_to_device(keys, "cpu")
    assert int(dev[0]) == SENTINEL and int(dev.min()) >= 0
    np.testing.assert_array_equal(keys_to_numpy(dev), keys)
    # packed words keep unsigned order under the bias, and unpack
    k = 19
    kk = torch.from_numpy(
        rng.integers(0, 1 << (2 * k), size=1000).astype(np.int64))
    cc = torch.from_numpy(rng.integers(0, 1 << 20, size=1000))
    keep = torch.from_numpy(rng.random(1000) < 0.8)
    words = torch.sort(pack(kk, cc, 64 - 2 * k, keep)).values
    uk, uc = unpack(words, 64 - 2 * k)
    order = np.lexsort((cc.numpy()[keep.numpy()], kk.numpy()[keep.numpy()]))
    n = int(keep.sum())
    np.testing.assert_array_equal(uk[:n].numpy(), kk.numpy()[keep.numpy()][order])
    np.testing.assert_array_equal(uc[:n].numpy(), cc.numpy()[keep.numpy()][order])
    assert bool((uk[n:] == SENTINEL).all()) and bool((uc[n:] == 0).all())


def test_revcomp_matches_numpy():
    rng = np.random.default_rng(4)
    for k in (5, 19, 31):
        keys = rng.integers(0, 1 << (2 * k), size=500, dtype=np.uint64)
        got = keys_to_numpy(revcomp(keys_to_device(keys, "cpu"), k))
        np.testing.assert_array_equal(
            got, jax_encoding.revcomp_kmers_np(keys, k))


def _read_batches(k):
    genome = random_genome(20000, seed=11, n_rate=0.002)
    reads = reads_from_genome(genome, 2400, 100, seed=12)
    # sequencing errors, so many k-mers are singletons
    rng = np.random.default_rng(13)
    noisy = []
    for r in reads:
        r = list(r)
        for i in np.nonzero(rng.random(len(r)) < 0.01)[0]:
            r[i] = "ACGT"[(("ACGTN".index(r[i]) + 1) % 4)]
        noisy.append("".join(r))
    step = 300  # uneven batch boundaries vs the buffer
    return [
        jax_encoding.codes_to_batch(
            [jax_encoding.ascii_to_codes(r) for r in noisy[i : i + step]],
            width=128,
        )
        for i in range(0, len(noisy), step)
    ]


@pytest.fixture(scope="module")
def stores(k=21):
    batches = _read_batches(k)
    jstore = JaxStore.create(k)
    jstore.max_agg = MAX_AGG
    tstore = SortedKmerStore(k, "cpu", max_agg=MAX_AGG)
    model = collections.Counter()
    # a small first batch, drained at once by a query: the first
    # (ghosted) drain then seeds one partition. A ghosted run wider than
    # a partition is where the two packages differ on purpose; see
    # test_ghosted_run_wider_than_a_partition.
    first, batches[0] = batches[0][:8], batches[0][8:]
    for i, codes in enumerate([first, *batches]):
        jstore.ingest_codes(codes)
        tstore.ingest_codes(codes)
        for row in codes:
            n = int(np.sum(row < encoding.CODE_PAD))
            seq = "".join("ACGTN"[c] for c in row[:n])
            model.update(jax_encoding.kmers_from_ascii_ref(seq, k))
        if i == 0:
            assert tstore.n_unique() == jstore.n_unique() == len(model)
    return jstore, tstore, model


def test_store_counts_match_jax(stores):
    jstore, tstore, model = stores
    assert tstore.n_unique() == jstore.n_unique() == len(model)
    assert tstore.n_total() == jstore.n_total() == sum(model.values())
    assert tstore.max_count() == max(model.values())
    # the small budget really went through partitions and splits
    assert len(tstore.parts) > 2
    np.testing.assert_array_equal(tstore.histogram(100), jstore.histogram(100))
    np.testing.assert_array_equal(tstore.histogram(3), jstore.histogram(3))


def test_store_lookups_match_jax(stores):
    jstore, tstore, model = stores
    rng = np.random.default_rng(21)
    canon = np.array(list(model)[:500], np.uint64)
    q = np.concatenate([
        canon,
        jax_encoding.revcomp_kmers_np(canon, 21),  # directional forms
        rng.integers(0, 1 << 42, size=500, dtype=np.uint64),
    ])
    np.testing.assert_array_equal(
        tstore.lookup_directional(q), jstore.lookup_directional(q))
    np.testing.assert_array_equal(
        tstore.lookup(canon), np.asarray(jstore.lookup(canon)))


def test_store_export_matches_jax(stores):
    jstore, tstore, _model = stores
    for mc in (1, 2):
        tk, tc = tstore.to_sorted_arrays(min_count=mc)
        jk, jc = jstore.to_sorted_arrays(min_count=mc)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tc, jc)
    assert tstore.to_dict() == jstore.to_dict()


def _requests(k):
    genome = random_genome(20000, seed=11, n_rate=0.002)
    rng = np.random.default_rng(31)
    requests = []
    for olen, n_oligos in ((8, 40), (10, 12), (12, 6), (9, 1)):
        raws = set()
        while len(raws) < n_oligos:
            p = rng.integers(0, len(genome) - olen)
            if "N" not in genome[p : p + olen]:
                raws.add(genome[p : p + olen])
        requests.append((
            np.array(sorted(string_to_oligo(o)[0] for o in raws), np.uint64),
            olen,
        ))
    requests.append(requests[0])  # identical sets give identical rows
    return requests


def test_prefix_scan_many_matches_jax(stores):
    jstore, tstore, _model = stores
    requests = _requests(21)
    got = tstore.prefix_scan_many(requests, max_out=64)  # forces retries
    want = jstore.prefix_scan_many(requests, max_out=64)
    assert len(got) == len(want) == len(requests)
    n_hits = 0
    for (gk, gc), (wk, wc) in zip(got, want):
        assert sorted(zip(gk.tolist(), gc.tolist())) == sorted(
            zip(wk.tolist(), wc.tolist()))
        n_hits += len(gk)
    assert n_hits > 0
    for oligos, olen in requests[:3]:
        gk, gc = tstore.prefix_scan(oligos, olen, min_count=2, max_out=64)
        wk, wc = jstore.prefix_scan(oligos, olen, min_count=2, max_out=64)
        assert sorted(zip(gk.tolist(), gc.tolist())) == sorted(
            zip(wk.tolist(), wc.tolist()))


def test_from_arrays_round_trip(stores):
    """A table exported by the JAX store, rebuilt in the port, answers
    exports, lookups and primer scans the same."""
    jstore, _tstore, model = stores
    keys, counts = jstore.to_sorted_arrays()
    rebuilt = SortedKmerStore.from_arrays(21, keys, counts, "cpu")
    rk, rc = rebuilt.to_sorted_arrays()
    np.testing.assert_array_equal(rk, keys)
    np.testing.assert_array_equal(rc, counts)
    q = np.array(list(model)[:200], np.uint64)
    np.testing.assert_array_equal(
        rebuilt.lookup_directional(q), jstore.lookup_directional(q))
    requests = _requests(21)
    for (gk, gc), (wk, wc) in zip(rebuilt.prefix_scan_many(requests),
                                  jstore.prefix_scan_many(requests)):
        assert sorted(zip(gk.tolist(), gc.tolist())) == sorted(
            zip(wk.tolist(), wc.tolist()))


def test_saturation_exact():
    s = SortedKmerStore(5, "cpu")
    s.insert_kmers(np.array([1], np.uint64), np.array([0xFFFFFFFF], np.uint32))
    s.insert_kmers(np.array([1], np.uint64), np.array([5], np.uint32))
    assert s.to_dict() == {1: 0xFFFFFFFF}


def test_ghosted_drain_then_compacting_drains():
    """The first drain leaves ghost rows in the one partition it seeds;
    later drains compact and merge over them. Counts stay exact through
    every query, as in the JAX store."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 10, size=1500, dtype=np.uint64)
    more = rng.integers(0, 1 << 11, size=9000, dtype=np.uint64)
    model = collections.Counter(keys.tolist())
    jstore = JaxStore.create(21)
    jstore.max_agg = 1 << 12
    store = SortedKmerStore(21, "cpu", max_agg=1 << 12)
    for s in (store, jstore):
        s.insert_kmers(keys)
        assert s.n_unique() == len(model)
        assert sum(p.n for p in s.parts) > len(model)  # ghosts present
        assert s.to_dict() == dict(model)
        s.insert_kmers(more)
    model.update(more.tolist())
    assert store.to_dict() == jstore.to_dict() == dict(model)
    assert store.n_total() == sum(model.values())
    np.testing.assert_array_equal(store.histogram(20), jstore.histogram(20))


def test_ghosted_run_wider_than_a_partition():
    """A first drain wider than a partition: the port compacts the
    ghosted run before cutting it into partitions, so a key whose run
    crosses the cut stays in one partition and later inserts of it add
    up. (The JAX store cuts the ghosted run as is; on this input it
    counts key 702 in two partitions.)"""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 10, size=3000, dtype=np.uint64)
    more = rng.integers(0, 1 << 11, size=9000, dtype=np.uint64)
    model = collections.Counter(keys.tolist())
    store = SortedKmerStore(21, "cpu", max_agg=1 << 12)
    store.insert_kmers(keys)
    assert store.n_unique() == len(model)
    assert len(store.parts) == 1
    store.insert_kmers(more)
    model.update(more.tolist())
    assert store.to_dict() == dict(model)
    assert store.n_unique() == len(model)
    assert store.n_total() == sum(model.values())
    keys_out, _counts = store.to_sorted_arrays()
    assert len(np.unique(keys_out)) == len(keys_out)
