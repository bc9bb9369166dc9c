"""The port's hash backend (``ops/hashtable.KmerTable``) against the JAX
package's ``KmerTable``.

The same seeded numpy inputs go through ``sharkmer_tpu`` (JAX on the
CPU) and ``sharkmer_tpu_torch`` (torch on the CPU, where ``hash_insert``
and ``hash_lookup`` run their plain versions, the JAX claim/probe and
probe loops). Counts are integers, so every comparison is exact: the
table's contents, the grown capacity, lookups, histograms, totals and
primer scans (compared as sorted pairs). A numpy model of the CUDA
kernel's per-entry protocol (probe, CAS claim, freeze-checked add), run
under random interleavings of its threads, must give the JAX table's
contents too: the atomics' order does not matter.
"""

import collections

import numpy as np
import pytest
import torch

from sharkmer_tpu.ops import KmerTable as JaxTable
from sharkmer_tpu.ops import ascii_to_codes, codes_to_batch, kmers_from_ascii_ref
from sharkmer_tpu.ops.encoding import kmer_to_seq, seq_to_kmer
from sharkmer_tpu.ops.hashtable import _mix64
from sharkmer_tpu.ops.histogram import histogram_from_counts
from sharkmer_tpu_torch.kernels import hash as hash_kernels
from sharkmer_tpu_torch.kernels.hash import SAT_THRESHOLD
from sharkmer_tpu_torch.ops.hashtable import KmerTable
from sharkmer_tpu_torch.ops.keys import SENTINEL

EMPTY = np.uint64(0xFFFF_FFFF_FFFF_FFFF)


def both(k, capacity):
    return KmerTable.create(k, capacity, "cpu"), JaxTable.create(k, capacity)


def insert_both(port, jax_table, kmers, counts=None):
    kmers = np.asarray(kmers, np.uint64)
    if counts is not None:
        counts = np.asarray(counts, np.uint32)
    port = port.insert_kmers(kmers, counts)
    jax_table = jax_table.insert_kmers(kmers, counts)
    return port, jax_table


def assert_same(port, jax_table):
    """Equal contents, capacity, totals and max count."""
    assert port.capacity == jax_table.capacity
    assert port.to_dict() == jax_table.to_dict()
    pk, pc = port.to_sorted_arrays()
    jk, jc = jax_table.to_sorted_arrays()
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pc, jc)
    assert pk.dtype == np.uint64 and pc.dtype == np.uint32
    assert port.n_unique() == jax_table.n_unique()
    assert port.n_total() == jax_table.n_total()
    assert port.max_count() == jax_table.max_count()


# -- the cases of tests/test_hashtable.py, each held to the JAX table ------


def _case_insert_and_get():
    p, j = insert_both(*both(5, 1 << 10), [42], [3])
    assert p.to_dict() == {42: 3}
    return p, j


def _case_accumulates():
    p, j = insert_both(*both(5, 1 << 10), [42], [3])
    p, j = insert_both(p, j, [42], [7])
    assert p.to_dict() == {42: 10} and p.n_unique() == 1
    return p, j


def _case_batch_duplicates():
    p, j = insert_both(*both(5, 1 << 10), [7, 7, 7, 9])
    assert p.to_dict() == {7: 3, 9: 1}
    return p, j


def _case_saturating_add():
    p, j = insert_both(*both(5, 1 << 10), [1], [0xFFFFFFFF])
    p, j = insert_both(p, j, [1], [1])
    assert p.to_dict() == {1: 0xFFFFFFFF}
    return p, j


def _case_merge_semantics():
    p, j = insert_both(*both(5, 1 << 10), [1, 2], [10, 20])
    p, j = insert_both(p, j, [2, 3], [5, 15])
    assert p.to_dict() == {1: 10, 2: 25, 3: 15}
    return p, j


def _case_growth():
    rng = np.random.default_rng(1)
    kmers = rng.integers(0, 1 << 10, size=500, dtype=np.uint64)
    p, j = insert_both(*both(5, 64), kmers)
    assert p.capacity > 64
    assert p.to_dict() == dict(collections.Counter(kmers.tolist()))
    return p, j


def _case_randomized_differential():
    rng = np.random.default_rng(7)
    p, j = both(21, 1 << 12)
    model = collections.Counter()
    for _ in range(5):
        batch = rng.integers(0, 1 << 42, size=2000, dtype=np.uint64)
        batch = np.concatenate([batch, batch[: rng.integers(0, 2000)]])
        p, j = insert_both(p, j, batch)
        model.update(batch.tolist())
    assert p.to_dict() == dict(model)
    return p, j


def _case_ingest_canonical_counts():
    p, j = both(3, 64)
    codes = codes_to_batch([ascii_to_codes("ACGT")])
    p, j = p.ingest_codes(codes), j.ingest_codes(codes)
    assert p.n_unique() == 1 and p.n_total() == 2
    return p, j


def _case_ingest_reference_encoder():
    seqs = ["ACGTACGTACGTTTTGGGA", "NTANCACNAGAAAATC", "CCCCCCCCCCCC"]
    p, j = both(7, 1 << 10)
    codes = codes_to_batch([ascii_to_codes(s) for s in seqs])
    p, j = p.ingest_codes(codes), j.ingest_codes(codes)
    model = collections.Counter()
    for s in seqs:
        model.update(kmers_from_ascii_ref(s, 7))
    assert p.to_dict() == dict(model)
    return p, j


CASES = {
    "insert_and_get": _case_insert_and_get,
    "accumulates": _case_accumulates,
    "batch_duplicates": _case_batch_duplicates,
    "saturating_add": _case_saturating_add,
    "merge_semantics": _case_merge_semantics,
    "growth": _case_growth,
    "randomized_differential": _case_randomized_differential,
    "ingest_canonical_counts": _case_ingest_canonical_counts,
    "ingest_reference_encoder": _case_ingest_reference_encoder,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_jax(case):
    port, jax_table = CASES[case]()
    assert_same(port, jax_table)


def test_freeze_is_not_a_clamp():
    """0xE0000000 then 5: the count stays 0xE0000000 (a clamp would give
    0xE0000005); below the threshold an add wraps modulo 2^32."""
    p, j = insert_both(*both(5, 1 << 10), [1, 2], [SAT_THRESHOLD, 0xDFFFFFFF])
    p, j = insert_both(p, j, [1, 2], [5, 5])
    assert p.to_dict() == j.to_dict() == {1: 0xE0000000, 2: 0xE0000004}
    p, j = insert_both(p, j, [2, 2, 2], [0xFFFFFFFF, 7, 0])
    assert p.to_dict() == j.to_dict() == {1: 0xE0000000, 2: 0xE0000004}
    p, j = insert_both(*both(5, 1 << 10), [3, 3], [0xDFFFFFFF, 0x30000000])
    assert p.to_dict() == j.to_dict() == {3: (0xDFFFFFFF + 0x30000000) & 0xFFFFFFFF}


def test_histogram_vector():
    """mod.rs:289-305's expected vector, and the JAX table's at several
    clip points."""
    p, j = insert_both(*both(11, 256), [1, 20, 2, 11, 12], [5, 5, 7, 11, 12])
    vec = p.histogram(histo_max=10)
    np.testing.assert_array_equal(
        vec, np.array([0, 0, 0, 0, 0, 2, 0, 1, 0, 0, 0, 2], np.uint64))
    np.testing.assert_array_equal(
        vec, histogram_from_counts(np.array(list(p.to_dict().values())), 10))
    rng = np.random.default_rng(11)
    kmers = rng.integers(0, 1 << 22, size=5000, dtype=np.uint64)
    counts = rng.integers(1, 60, size=5000).astype(np.uint32)
    counts[:3] = [0xFFFFFFFF, SAT_THRESHOLD, 0x80000000]
    p, j = insert_both(p, j, kmers, counts)
    for histo_max in (1, 10, 50, 10000):
        got, want = p.histogram(histo_max), j.histogram(histo_max)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, want)


def _build_both(k, seq):
    p, j = both(k, 256)
    codes = codes_to_batch([ascii_to_codes(seq)])
    return p.ingest_codes(codes), j.ingest_codes(codes)


def _scan_pairs(table, oligos, oligo_len, min_count):
    kmers, counts = table.prefix_scan(np.asarray(oligos, np.uint64),
                                      oligo_len, min_count)
    kmers, counts = np.asarray(kmers), np.asarray(counts)
    assert kmers.dtype == np.uint64 and counts.dtype == np.uint32
    return sorted(zip(kmers.tolist(), counts.tolist()))


def test_prefix_scan_forward_and_rc():
    """primers.rs:604-696 behaviours, each equal to the JAX scan."""
    k = 5
    cases = [("ACGTACGT", "ACG", 1), ("AAAAAAAAAA", "GGG", 1),
             ("AACCCAACC", "AAC", 2), ("TTTTTTT", "AAA", 1),
             ("ACGTACGT", "ACGT", 1)]
    for seq, oligo, min_count in cases:
        p, j = _build_both(k, seq)
        oligos = [seq_to_kmer(oligo)]
        got = _scan_pairs(p, oligos, len(oligo), min_count)
        assert got == _scan_pairs(j, oligos, len(oligo), min_count), seq
    p, _ = _build_both(k, "ACGTACGT")
    assert _scan_pairs(p, [seq_to_kmer("ACG")], 3, 1)
    p, _ = _build_both(k, "TTTTTTT")
    (kmer, _count), = _scan_pairs(p, [seq_to_kmer("AAA")], 3, 1)
    assert kmer_to_seq(kmer, k) == "AAAAA"
    with pytest.raises(ValueError):
        p.prefix_scan(np.array([seq_to_kmer("ACGTA")], np.uint64), 5, 1)
    with pytest.raises(ValueError):
        p.prefix_scan(np.array([0], np.uint64), 0, 1)


@pytest.mark.parametrize("oligo_len,min_count", [(3, 1), (6, 2), (9, 1),
                                                 (18, 3)])
def test_prefix_scan_random_table(oligo_len, min_count):
    """Sorted (kmer, count) pairs equal to the JAX scan's on a random
    k=19 table: oligos drawn from table k-mers' starts and ends, so both
    strands hit, plus oligos that miss."""
    k = 19
    rng = np.random.default_rng(oligo_len)
    kmers = rng.integers(0, 1 << (2 * k), size=3000, dtype=np.uint64)
    counts = rng.integers(1, 6, size=3000).astype(np.uint32)
    p, j = insert_both(*both(k, 1 << 12), kmers, counts)
    starts = kmers[:40] >> np.uint64(2 * (k - oligo_len))
    ends = kmers[40:80] & np.uint64((1 << (2 * oligo_len)) - 1)
    from sharkmer_tpu_torch.ops.encoding import revcomp_kmer

    rc_ends = [revcomp_kmer(int(e), oligo_len) for e in ends]
    oligos = np.unique(np.concatenate([
        starts, np.array(rc_ends, np.uint64),
        rng.integers(0, 1 << (2 * oligo_len), size=20, dtype=np.uint64)]))
    got = _scan_pairs(p, oligos, oligo_len, min_count)
    assert got == _scan_pairs(j, oligos, oligo_len, min_count)
    assert len(got) >= 40 // min_count // 3


@pytest.mark.parametrize("chunk", [64, 1000, 1 << 12])
def test_prefix_scan_in_chunks(monkeypatch, chunk):
    """The sweep in chunks of slots (ragged, one slot, whole table)
    gives the JAX scan's pairs."""
    from sharkmer_tpu_torch.ops import hashtable

    monkeypatch.setattr(hashtable, "SCAN_CHUNK", chunk)
    k, oligo_len = 11, 4
    rng = np.random.default_rng(chunk)
    kmers = rng.integers(0, 1 << (2 * k), size=2500, dtype=np.uint64)
    p, j = insert_both(*both(k, 1 << 12), kmers)
    oligos = np.unique(kmers[:30] >> np.uint64(2 * (k - oligo_len)))
    got = _scan_pairs(p, oligos, oligo_len, 1)
    assert got and got == _scan_pairs(j, oligos, oligo_len, 1)


@pytest.mark.parametrize("k", [5, 19, 31])
def test_lookup_and_lookup_directional(k):
    """Canonical and directional lookups equal the JAX table's, hits,
    misses and sentinel queries alike."""
    rng = np.random.default_rng(k)
    raw = rng.integers(0, 1 << (2 * k), size=4000, dtype=np.uint64)
    from sharkmer_tpu_torch.ops.encoding import revcomp_kmers_np

    canon = np.minimum(raw, revcomp_kmers_np(raw, k))
    p, j = insert_both(*both(k, 1 << 10), canon)
    queries = np.concatenate([
        canon[:500], raw[:500], revcomp_kmers_np(raw[500:700], k),
        rng.integers(0, 1 << (2 * k), size=500, dtype=np.uint64),
        np.full(3, EMPTY, np.uint64)])
    got = p.lookup(queries)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, np.asarray(j.lookup(queries)))
    got = p.lookup_directional(queries)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, j.lookup_directional(queries))
    assert (got[:700] > 0).all() and (got[-3:] == 0).all()
    assert p.lookup_directional(np.zeros(0, np.uint64)).shape == (0,)


@pytest.mark.parametrize("incoming", [[1000], [300, 300, 300], [5000, 1],
                                      [2869, 2870, 1]])
def test_capacity_after_growth_equals_jax(incoming):
    """The growth rule counts every incoming entry, sentinels too: the
    capacity after the same inserts equals the JAX table's, and the
    rehash keeps every count."""
    rng = np.random.default_rng(len(incoming))
    p, j = both(19, 1 << 12)
    for n in incoming:
        batch = rng.integers(0, 1 << 20, size=n, dtype=np.uint64)
        batch[rng.random(n) < 0.25] = EMPTY  # sentinel padding
        p, j = insert_both(p, j, batch)
        assert p.capacity == j.capacity
    assert_same(p, j)


def test_merge_from_matches_jax():
    """Chunk tables fold into a master in order (the engine's
    consolidation): equal to JAX's merge_from, empty slots skipped."""
    rng = np.random.default_rng(3)
    port_master, jax_master = both(21, 1 << 12)
    for c in range(3):
        p, j = both(21, 1 << 12)
        batch = rng.integers(0, 1 << 12, size=1500, dtype=np.uint64)
        p, j = insert_both(p, j, batch)
        port_master = port_master.merge_from(p)
        jax_master = jax_master.merge_from(j)
        assert_same(port_master, jax_master)
    with pytest.raises(ValueError):
        port_master.merge_from(KmerTable.create(5, 64, "cpu"))


def test_to_sorted_arrays_min_count_and_zero_adds():
    """``min_count`` filters above 1; at 1 every occupied slot is kept,
    a key inserted with an add of 0 too (it claims its slot)."""
    rng = np.random.default_rng(5)
    kmers = rng.integers(0, 1 << 30, size=2000, dtype=np.uint64)
    counts = rng.integers(0, 8, size=2000).astype(np.uint32)
    p, j = insert_both(*both(15, 1 << 12), kmers, counts)
    assert (p.to_sorted_arrays()[1] == 0).any()
    for min_count in (0, 1, 2, 5, 9):
        for got, want in zip(p.to_sorted_arrays(min_count),
                             j.to_sorted_arrays(min_count)):
            np.testing.assert_array_equal(got, want)


def test_create_and_empty_table():
    with pytest.raises(ValueError):
        KmerTable.create(5, 100, "cpu")
    p, j = both(5, 1 << 6)
    assert_same(p, j)
    assert p.to_sorted_arrays()[0].shape == (0,)
    np.testing.assert_array_equal(p.histogram(5), j.histogram(5))
    assert p.keys.dtype == torch.int64 and p.counts.dtype == torch.int32
    assert int(p.keys[0]) == SENTINEL


def test_mix64_matches_jax():
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 1 << 62, size=5000, dtype=np.uint64)
    keys[:2] = [0, (1 << 62) - 1]
    got = hash_kernels.mix64(torch.from_numpy(keys.view(np.int64)))
    import jax.numpy as jnp

    want = np.asarray(_mix64(jnp.asarray(keys)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def test_wrappers_take_the_plain_path_on_cpu():
    """On CPU tensors the wrappers are their plain versions and count
    no launch; the counts' u32 codec round-trips."""
    rng = np.random.default_rng(2)
    kmers = torch.from_numpy(rng.integers(0, 1 << 40, size=3000))
    kmers[::5] = SENTINEL
    tables = []
    for fn in (hash_kernels.hash_insert, hash_kernels.insert_plain):
        keys = torch.full((1 << 13,), SENTINEL, dtype=torch.int64)
        counts = torch.zeros(1 << 13, dtype=torch.int32)
        fn(keys, counts, kmers)
        tables.append((keys, counts))
    assert all(torch.equal(a, b) for a, b in zip(*tables))
    q = kmers[:100]
    np.testing.assert_array_equal(
        hash_kernels.hash_lookup(*tables[0], q).numpy(),
        hash_kernels.lookup_plain(*tables[0], q).numpy())
    assert hash_kernels.hash_insert.launches == 0
    assert hash_kernels.hash_lookup.launches == 0
    u = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])
    assert torch.equal(hash_kernels.as_u32(hash_kernels.as_i32(u)), u)
    full = torch.full((4,), SENTINEL, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="table full"):
        hash_kernels.insert_plain(full, torch.zeros(4, dtype=torch.int32),
                                  torch.arange(5, dtype=torch.int64))


# -- a numpy model of the CUDA kernel's per-entry protocol ------------------


def _mix64_int(x: int) -> int:
    mask = (1 << 64) - 1
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & mask
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & mask
    return x ^ (x >> 33)


def kernel_model(keys, counts, kmers, amounts, rng):
    """``hash_insert_kernel`` thread by thread, in place: each step is
    one memory action of one thread (load the slot's key, CAS it, load
    the count, add), and every step runs a thread drawn at random, so
    the threads interleave as racing warps may. ``keys`` holds Python
    ints, SENTINEL for empty."""
    cap = len(keys)
    threads = [[int(km), int(a), _mix64_int(int(km)) & (cap - 1), "load", 0]
               for km, a in zip(kmers, amounts) if int(km) != SENTINEL]
    while threads:
        i = int(rng.integers(len(threads)))
        t = threads[i]
        key, amount, slot, state, probes = t
        done = False
        if state == "load":
            cur = keys[slot]
            if cur == SENTINEL:
                t[3] = "cas"
            elif cur == key:
                t[3] = "count"
            else:
                t[2], t[4] = (slot + 1) & (cap - 1), probes + 1
        elif state == "cas":
            cur = keys[slot]
            if cur == SENTINEL:
                keys[slot] = cur = key
            if cur == key:
                t[3] = "count"
            else:
                t[2], t[3], t[4] = (slot + 1) & (cap - 1), "load", probes + 1
        elif state == "count":
            if amount != 0 and counts[slot] < SAT_THRESHOLD:
                t[3] = "add"
            else:
                done = True
        else:  # add
            counts[slot] = (counts[slot] + amount) & 0xFFFFFFFF
            done = True
        assert t[4] < cap, "overflow"
        if done:
            threads[i] = threads[-1]
            threads.pop()


@pytest.mark.parametrize("seed", range(4))
def test_kernel_protocol_is_order_independent(seed):
    """Batches with heavy duplication, explicit amounts, zero adds,
    sentinels and a frozen count, into a small table with long probe
    chains: under any interleaving the model's contents equal the JAX
    table's after the same inserts."""
    rng = np.random.default_rng(100 + seed)
    cap = 1 << 9
    keys = [SENTINEL] * cap
    counts = [0] * cap
    _, j = both(21, cap)
    frozen = np.array([12345], np.uint64)
    j = j.insert_kmers(frozen, np.array([SAT_THRESHOLD], np.uint32))
    kernel_model(keys, counts, frozen, [SAT_THRESHOLD], rng)
    for _ in range(3):
        distinct = rng.integers(0, 1 << 42, size=60, dtype=np.uint64)
        batch = rng.choice(np.concatenate([distinct, frozen]), size=300)
        batch[rng.random(300) < 0.1] = EMPTY
        amounts = rng.integers(0, 4, size=300).astype(np.uint32)
        j = j.insert_kmers(batch, amounts)
        dev = [SENTINEL if b == EMPTY else int(b) for b in batch]
        kernel_model(keys, counts, dev, amounts.tolist(), rng)
    got = {key: c for key, c in zip(keys, counts) if key != SENTINEL}
    assert got == j.to_dict()
    assert got[12345] == SAT_THRESHOLD
