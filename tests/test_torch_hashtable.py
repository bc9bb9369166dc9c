"""The port's hash backend (``ops/hashtable.KmerTable``) against the JAX
package's ``KmerTable``.

The same seeded numpy inputs go through ``sharkmer_tpu`` (JAX on the
CPU) and ``sharkmer_tpu_torch`` (torch on the CPU, where ``hash_insert``
and ``hash_lookup`` run their plain versions, the JAX claim/probe and
probe loops). Counts are integers, so every comparison is exact: the
table's contents, the grown capacity, lookups, histograms, totals and
primer scans (compared as sorted pairs), on the 16 B slot layout. A
numpy model of the CUDA kernel's per-entry protocol (one 16 B slot load,
a 16 B compare-and-swap that claims a slot with key and count, a
freeze-checked add, the claim counter, owner routing and the window of a
shard group), run under random interleavings of its threads, must give
the JAX table's contents too, shard for shard, with claim counters equal
to the occupied slots: the atomics' order does not matter.
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
from sharkmer_tpu.parallel import make_mesh
from sharkmer_tpu.parallel.sharded_table import ShardedKmerTable as JaxShardedTable
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
    no launch, on one table and on owner shards, from keys and from
    another table's slots; the claim counters equal the occupied slots;
    the counts' u32 codec round-trips."""
    rng = np.random.default_rng(2)
    kmers = torch.from_numpy(rng.integers(0, 1 << 40, size=3000))
    kmers[::5] = SENTINEL
    for shape in ((1 << 13,), (4, 1 << 11)):
        tables = []
        for fn in (hash_kernels.hash_insert, hash_kernels.insert_plain):
            slots = hash_kernels.new_slots(shape, "cpu")
            claims = torch.zeros(shape[0] if len(shape) == 2 else 1,
                                 dtype=torch.int64)
            fn(slots, claims, kmers)
            tables.append((slots, claims))
            occupied = hash_kernels.slot_keys(slots) != SENTINEL
            assert torch.equal(claims, occupied.reshape(claims.shape[0], -1)
                               .sum(1))
            # a rehash from the slots: the same rows in each shard, the
            # same claims
            again = hash_kernels.new_slots(shape, "cpu")
            again_claims = torch.zeros_like(claims)
            fn(again, again_claims, slots.view(-1, 2))
            assert torch.equal(again_claims, claims)
            for a, b in zip(again.view(claims.shape[0], -1, 2),
                            slots.view(claims.shape[0], -1, 2)):
                assert torch.equal(torch.sort(a[:, 0]).values,
                                   torch.sort(b[:, 0]).values)
                assert torch.equal(a[torch.argsort(a[:, 0])],
                                   b[torch.argsort(b[:, 0])])
        assert all(torch.equal(a, b) for a, b in zip(*tables))
        q = kmers[:100]
        np.testing.assert_array_equal(
            hash_kernels.hash_lookup(tables[0][0], q).numpy(),
            hash_kernels.lookup_plain(tables[0][0], q).numpy())
    assert hash_kernels.hash_insert.launches == 0
    assert hash_kernels.hash_lookup.launches == 0
    u = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])
    assert torch.equal(hash_kernels.as_u32(hash_kernels.as_i32(u)), u)
    full = hash_kernels.new_slots((4,), "cpu")
    with pytest.raises(RuntimeError, match="table full"):
        hash_kernels.insert_plain(full, torch.zeros(1, dtype=torch.int64),
                                  torch.arange(5, dtype=torch.int64))


def test_slot_layout():
    """16 B a slot: the key at byte 0, the u32 count at byte 8, 4 B of
    zeros; the table's ``keys`` and ``counts`` are views of its slots."""
    p, _ = insert_both(*both(11, 1 << 6), [5, 9], [7, 0xFFFFFFFF])
    raw = p.slots.numpy().view(np.uint8).reshape(-1, 16)
    assert p.slots.shape == (1 << 6, 2) and p.slots.dtype == torch.int64
    occupied = raw[:, :8].copy().view(np.int64)[:, 0] != SENTINEL
    assert occupied.sum() == 2 and p.n_unique() == 2
    got = {int(r[:8].copy().view(np.int64)[0]): int(r[8:12].copy().view(
        np.uint32)[0]) for r in raw[occupied]}
    assert got == {5: 7, 9: 0xFFFFFFFF}
    assert not raw[:, 12:].any()
    assert (raw[~occupied, 8:] == 0).all()
    assert p.keys.data_ptr() == p.slots.data_ptr()
    assert p.counts.data_ptr() == p.slots.data_ptr() + 8
    assert p.keys.stride() == (2,) and p.counts.stride() == (4,)


# -- a numpy model of the CUDA kernel's per-entry protocol ------------------


def _mix64_int(x: int) -> int:
    mask = (1 << 64) - 1
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & mask
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & mask
    return x ^ (x >> 33)


U32 = 0xFFFF_FFFF


def kernel_model(keys, counts, claims, kmers, amounts, rng,
                 shard_lo: int = 0, n_shards=None):
    """``hash_insert_kernel`` thread by thread, in place, on the
    ``n_local`` shards ``[shard_lo, shard_lo + n_local)`` of an
    ``n_shards``-way owner route (``keys[s]``, ``counts[s]``: Python ints,
    SENTINEL for an empty key, each count the slot's 8 B count word: the
    u32 count and the pad word above it; by default every shard of the
    route); entries that a shard outside the window owns are skipped.
    ``amounts`` may be another table's count words (a rehash or a merge):
    the amount is the low 32 bits. The call is one launch, with a new
    epoch from ``new_epoch``. Each step
    is one memory action of one thread: the 16 B load of a slot (key and
    count word at once), the 16 B compare-and-swap that claims an empty
    slot with the key, the amount as its count and the epoch as its pad
    (returning the slot as it was), the 8 B compare-and-swap of the count
    word that makes a batch's first add to a key from before it (count
    and epoch at once; on a race the thread decides again on the word it
    found), and the 32-bit add of a later entry, which saw the epoch;
    a count word with a stale pad and a count at or above SAT_THRESHOLD
    takes nothing. Every step runs a thread drawn at random, so the
    threads interleave as racing warps may. A thread that claims a slot
    counts it in its block's counter for its shard, and the blocks'
    counters reach ``claims`` when the launch ends."""
    n_local, cap = len(keys), len(keys[0])
    n_shards = n_local if n_shards is None else n_shards
    epoch = hash_kernels.new_epoch()
    threads = []
    for km, a in zip(kmers, amounts):
        if int(km) == SENTINEL:
            continue
        h = _mix64_int(int(km))
        local = ((h >> 40) % n_shards if n_shards > 1 else 0) - shard_lo
        if 0 <= local < n_local:
            threads.append({"key": int(km), "amount": int(a) & U32,
                            "shard": local, "slot": h & (cap - 1),
                            "state": "load", "probes": 0, "claimed": False})
    block = [0] * n_local
    while threads:
        i = int(rng.integers(len(threads)))
        t = threads[i]
        tk, tc = keys[t["shard"]], counts[t["shard"]]
        slot = t["slot"]

        def decide(word):
            """The add's next step from the count word as loaded."""
            t["word"] = word
            if t["amount"] == 0:
                return "done"
            if word >> 32 == epoch:
                return "add"
            return "done" if word & U32 >= SAT_THRESHOLD else "cas"

        if t["state"] == "load":
            cur, word = tk[slot], tc[slot]
            if cur == t["key"]:
                t["state"] = decide(word)
            elif cur == SENTINEL:
                t["state"] = "claim"
            else:
                t["slot"], t["probes"] = (slot + 1) & (cap - 1), t["probes"] + 1
        elif t["state"] == "claim":
            prev, word = tk[slot], tc[slot]
            if prev == SENTINEL:
                assert word == 0  # an empty slot's count word is 0
                tk[slot], tc[slot] = t["key"], t["amount"] | epoch << 32
                t["claimed"] = True
                t["state"] = "done"
            elif prev == t["key"]:
                t["state"] = decide(word)
            else:
                t["slot"], t["state"] = (slot + 1) & (cap - 1), "load"
                t["probes"] += 1
        elif t["state"] == "cas":
            if tc[slot] == t["word"]:
                tc[slot] = ((t["word"] + t["amount"]) & U32) | epoch << 32
                t["state"] = "done"
            else:
                t["state"] = decide(tc[slot])
        else:  # add: the low 32 bits, the pad untouched
            word = tc[slot]
            tc[slot] = (word & ~U32) | ((word + t["amount"]) & U32)
            t["state"] = "done"
        assert t["probes"] < cap, "overflow"
        if t["state"] == "done":
            block[t["shard"]] += t["claimed"]
            threads[i] = threads[-1]
            threads.pop()
    for s in range(n_local):
        claims[s] += block[s]


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("seed", range(4))
def test_kernel_protocol_is_order_independent(seed, n_shards):
    """Batches with heavy duplication, explicit amounts, zero adds,
    sentinels and a frozen count, into small shards with long probe
    chains: under any interleaving the model's contents equal the JAX
    table's after the same inserts (shard for shard: the JAX sharded
    table on an S-device mesh), and each shard's claim counter equals its
    occupied slots."""
    rng = np.random.default_rng(100 + seed)
    cap = (1 << 9) // n_shards
    keys = [[SENTINEL] * cap for _ in range(n_shards)]
    counts = [[0] * cap for _ in range(n_shards)]
    claims = [0] * n_shards
    if n_shards == 1:
        _, j = both(21, cap)
    else:
        j = JaxShardedTable.create(21, make_mesh(n_shards),
                                   local_capacity=cap)
    frozen = np.array([12345], np.uint64)
    j = j.insert_kmers(frozen, np.array([SAT_THRESHOLD], np.uint32))
    kernel_model(keys, counts, claims, frozen, [SAT_THRESHOLD], rng)
    for _ in range(3):
        distinct = rng.integers(0, 1 << 42, size=60, dtype=np.uint64)
        batch = rng.choice(np.concatenate([distinct, frozen]), size=300)
        batch[rng.random(300) < 0.1] = EMPTY
        amounts = rng.integers(0, 4, size=300).astype(np.uint32)
        j = j.insert_kmers(batch, amounts)
        dev = [SENTINEL if b == EMPTY else int(b) for b in batch]
        kernel_model(keys, counts, claims, dev, amounts.tolist(), rng)
    got = _contents(keys, counts)
    assert claims == [len(g) for g in got]
    if n_shards == 1:
        want = [j.to_dict()]
    else:
        jk, jc = np.asarray(j.keys), np.asarray(j.counts)
        want = [{int(key): int(c) for key, c in zip(jk[s], jc[s])
                 if key != EMPTY} for s in range(n_shards)]
    assert got == want
    assert sum(len(g) for g in got) == j.n_unique()
    assert any(g.get(12345) == SAT_THRESHOLD for g in got)


def _model_tables(n_local: int, cap: int):
    return ([[SENTINEL] * cap for _ in range(n_local)],
            [[0] * cap for _ in range(n_local)], [0] * n_local)


def _contents(keys, counts) -> list[dict]:
    """Each shard's {key: u32 count}: the count words' low 32 bits."""
    return [{key: c & U32 for key, c in zip(ks, cs) if key != SENTINEL}
            for ks, cs in zip(keys, counts)]


# (S of the route, the window's first shard, its shards)
WINDOWS = {"shard 0": (4, 0, 1), "shards 1-3": (4, 1, 3),
           "shards 2-3": (4, 2, 2)}


@pytest.mark.parametrize("layout", sorted(WINDOWS))
@pytest.mark.parametrize("seed", range(2))
def test_kernel_protocol_in_a_window(seed, layout):
    """The batches of ``test_kernel_protocol_is_order_independent`` into
    one group of a 4-way route (a shard group of a table on several
    devices, one windowed launch): under any interleaving the group's
    shards hold the JAX sharded table's contents for those shards, each
    claim counter equals its shard's occupied slots, and the entries
    other groups own are skipped."""
    rng = np.random.default_rng(200 + seed)
    n_shards, lo, n_local = WINDOWS[layout]
    cap = (1 << 9) // n_shards
    keys, counts, claims = _model_tables(n_local, cap)
    j = JaxShardedTable.create(21, make_mesh(n_shards), local_capacity=cap)
    frozen = np.array([12345], np.uint64)
    j = j.insert_kmers(frozen, np.array([SAT_THRESHOLD], np.uint32))
    kernel_model(keys, counts, claims, frozen, [SAT_THRESHOLD], rng, lo,
                 n_shards)
    for _ in range(3):
        distinct = rng.integers(0, 1 << 42, size=60, dtype=np.uint64)
        batch = rng.choice(np.concatenate([distinct, frozen]), size=300)
        batch[rng.random(300) < 0.1] = EMPTY
        amounts = rng.integers(0, 4, size=300).astype(np.uint32)
        j = j.insert_kmers(batch, amounts)
        dev = [SENTINEL if b == EMPTY else int(b) for b in batch]
        kernel_model(keys, counts, claims, dev, amounts.tolist(), rng, lo,
                     n_shards)
    got = _contents(keys, counts)
    assert claims == [len(g) for g in got]
    jk, jc = np.asarray(j.keys), np.asarray(j.counts)
    want = [{int(key): int(c) for key, c in zip(jk[s], jc[s])
             if key != EMPTY} for s in range(lo, lo + n_local)]
    assert got == want
    assert 0 < sum(len(g) for g in got) < j.n_unique()


T = SAT_THRESHOLD


def _jax_contents(j, n_shards: int) -> list[dict]:
    """Each shard's {key: count} of a JAX table (one table: one shard)."""
    if n_shards == 1:
        return [j.to_dict()]
    jk, jc = np.asarray(j.keys), np.asarray(j.counts)
    return [{int(key): int(c) for key, c in zip(jk[s], jc[s])
             if key != EMPTY} for s in range(n_shards)]


def _jax_table(n_shards: int, cap: int, mesh=None):
    if n_shards == 1:
        return JaxTable.create(21, cap)
    return JaxShardedTable.create(21, mesh or make_mesh(n_shards),
                                  local_capacity=cap)


def _port_table(n_shards: int, cap: int):
    from sharkmer_tpu_torch.parallel.sharded_table import ShardedKmerTable

    if n_shards == 1:
        return KmerTable.create(21, cap, "cpu")
    return ShardedKmerTable.create(21, n_shards, local_capacity=cap)


def _port_contents(port, n_shards: int) -> list[dict]:
    """Each shard's {key: u32 count} of a port table (the plain insert)."""
    shards = [port] if n_shards == 1 else port.shards
    return [shard.to_dict() for shard in shards]


@pytest.mark.parametrize("n_shards", [1, 4])
def test_kernel_freeze_is_read_once_a_batch(n_shards):
    """One batch carries a key from SAT_THRESHOLD - 2 past the threshold
    (5 entries of it): JAX reads its count once a round and adds the
    round's sum, SAT_THRESHOLD + 3. The kernel reads the freeze once a
    batch (the launch's epoch in the slot's pad word): every one of 20
    random interleavings gives SAT_THRESHOLD + 3, and every other key
    equals JAX's."""
    rng = np.random.default_rng(7)
    cap = (1 << 8) // n_shards
    key = 987654321
    j = _jax_table(n_shards, cap)
    others = rng.integers(0, 1 << 42, size=20, dtype=np.uint64)
    batch = np.concatenate([np.full(5, key, np.uint64), others, others[:7]])
    batch = batch[rng.permutation(batch.shape[0])]
    j = j.insert_kmers(np.array([key], np.uint64),
                       np.array([SAT_THRESHOLD - 2], np.uint32))
    j = j.insert_kmers(batch, np.ones(batch.shape[0], np.uint32))
    want = {k: c for g in _jax_contents(j, n_shards) for k, c in g.items()}
    assert want[key] == SAT_THRESHOLD + 3
    for _ in range(20):
        keys, counts, claims = _model_tables(n_shards, cap)
        kernel_model(keys, counts, claims, [key], [SAT_THRESHOLD - 2], rng)
        kernel_model(keys, counts, claims, batch.tolist(),
                     [1] * batch.shape[0], rng)
        got = {k: c for g in _contents(keys, counts) for k, c in g.items()}
        assert got == want


# a key's count before the batch, the batch's amounts for it, the JAX
# table's count after (its u32 scatter-add wraps modulo 2^32)
BAND = {"T-1": (T - 1, [1] * 5, T + 4),
        "T": (T, [1] * 5, T),
        "T+5": (T + 5, [1] * 5, T + 5),
        "wrap": (T - 1, [1 << 29, 1 << 29, 3], (T - 1 + (1 << 30) + 3)
                 & U32)}


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("case", sorted(BAND))
def test_freeze_band_matches_jax(case, n_shards):
    """A key at a count near SAT_THRESHOLD and a batch that carries
    several entries of it among other keys: the plain insert (the port's
    table on the CPU), the kernel model under 20 interleavings and the
    JAX table (one table, or the sharded table on a 4-device mesh) hold
    the same contents shard for shard, and the key's count is the
    written JAX value."""
    start, amounts, after = BAND[case]
    rng = np.random.default_rng(10 * sorted(BAND).index(case) + n_shards)
    cap = (1 << 8) // n_shards
    key = 123456789
    others = rng.integers(0, 1 << 42, size=24, dtype=np.uint64)
    batch = np.concatenate([np.full(len(amounts), key, np.uint64), others,
                            others[:9]])
    adds = np.concatenate([np.array(amounts, np.uint32),
                           rng.integers(1, 4, size=33).astype(np.uint32)])
    order = rng.permutation(batch.shape[0])
    batch, adds = batch[order], adds[order]
    first = (np.array([key, 42], np.uint64), np.array([start, 7], np.uint32))
    j = _jax_table(n_shards, cap).insert_kmers(*first)
    j = j.insert_kmers(batch, adds)
    want = _jax_contents(j, n_shards)
    assert {k: c for g in want for k, c in g.items()}[key] == after
    port = _port_table(n_shards, cap).insert_kmers(*first)
    port = port.insert_kmers(batch, adds)
    assert _port_contents(port, n_shards) == want
    for _ in range(20):
        keys, counts, claims = _model_tables(n_shards, cap)
        kernel_model(keys, counts, claims, first[0].tolist(),
                     first[1].tolist(), rng)
        kernel_model(keys, counts, claims, batch.tolist(), adds.tolist(),
                     rng)
        assert _contents(keys, counts) == want
        assert claims == [len(g) for g in want]


def test_new_epoch_is_never_zero(monkeypatch):
    """A batch's epoch is in [1, 2^32): a new one each call, and past
    2^32 - 1 it starts again at 1, never at 0 (the pad of an empty
    slot)."""
    import itertools

    first = hash_kernels.new_epoch()
    assert 0 < first < hash_kernels.new_epoch() <= U32
    monkeypatch.setattr(hash_kernels, "_epochs", itertools.count(U32 - 1))
    assert [hash_kernels.new_epoch() for _ in range(4)] == [U32 - 1, U32, 1,
                                                            2]


def _model_source(keys, counts):
    """A model table's occupied slots in slot order, shard after shard,
    as the kernel reads another table's slots: keys and count words
    (pads included)."""
    rows = [(k, c) for ks, cs in zip(keys, counts)
            for k, c in zip(ks, cs) if k != SENTINEL]
    return [k for k, _ in rows], [c for _, c in rows]


@pytest.mark.parametrize("n_shards", [1, 4])
def test_merge_and_rehash_near_the_freeze_match_jax(n_shards):
    """A merge whose source counts lie near SAT_THRESHOLD into a table
    that holds the same keys near it, and that first grows (a rehash of
    those counts): each key takes the source's count unless its own was
    at or above the threshold, modulo 2^32, as in JAX (one table, or the
    sharded table on a 4-device mesh); a key new to the master takes the
    source's count whatever it is. The plain merge and the kernel model
    (the grows' rehashes and the merge, each a batch of another table's
    count words, pads included) equal the JAX table shard for shard
    under 20 interleavings."""
    rng = np.random.default_rng(31 + n_shards)
    # 25 keys a table: the merge grows the master once (the JAX rule)
    cap = 64 // n_shards
    near = np.array([1001, 1002, 1003, 1004, 1005], np.uint64)
    master = (np.concatenate([near, rng.integers(0, 1 << 42, size=20,
                                                 dtype=np.uint64)]),
              np.concatenate([np.array([T - 2, T - 1, T, T + 5, T - 1],
                                       np.uint32),
                              rng.integers(1, 9, size=20).astype(np.uint32)]))
    fresh = np.array([2001, 2002], np.uint64)
    source = (np.concatenate([near, fresh, rng.integers(
                  0, 1 << 42, size=18, dtype=np.uint64)]),
              np.concatenate([np.array([3, 1, 7, T - 1, 0x3000_0000,
                                        T + 9, T - 3], np.uint32),
                              rng.integers(1, 9, size=18).astype(np.uint32)]))
    mesh = None if n_shards == 1 else make_mesh(n_shards)
    j = _jax_table(n_shards, cap, mesh).insert_kmers(*master)
    j_src = _jax_table(n_shards, cap, mesh).insert_kmers(*source)
    j = j.merge_from(j_src)
    want = _jax_contents(j, n_shards)
    flat = {k: c for g in want for k, c in g.items()}
    assert [flat[int(k)] for k in near] == [
        T + 1, T, T, T + 5, (T - 1 + 0x3000_0000) & U32]
    assert [flat[int(k)] for k in fresh] == [T + 9, T - 3]
    grown = j.capacity if n_shards == 1 else j.local_capacity
    assert grown > cap
    port = _port_table(n_shards, cap).insert_kmers(*master)
    port = port.merge_from(_port_table(n_shards, cap).insert_kmers(*source))
    assert _port_contents(port, n_shards) == want
    for _ in range(20):
        keys, counts, claims = _model_tables(n_shards, cap)
        kernel_model(keys, counts, claims, master[0].tolist(),
                     master[1].tolist(), rng)
        s_keys, s_counts, s_claims = _model_tables(n_shards, cap)
        kernel_model(s_keys, s_counts, s_claims, source[0].tolist(),
                     source[1].tolist(), rng)
        size = cap
        while size < grown:  # the grows: each a rehash into twice the slots
            size *= 2
            old = _model_source(keys, counts)
            keys, counts, claims = _model_tables(n_shards, size)
            kernel_model(keys, counts, claims, *old, rng)
        kernel_model(keys, counts, claims, *_model_source(s_keys, s_counts),
                     rng)
        assert _contents(keys, counts) == want
        assert claims == [len(g) for g in want]
