"""The port's sharded count tables (``sharkmer_tpu_torch.parallel``)
against the JAX package's.

The JAX tables shard over the conftest's 8 virtual CPU devices, so a JAX
table of S shards really runs on an S-device mesh; the port's S logical
shards on the CPU must match it shard for shard: each shard's contents,
the grown local capacity, histograms, lookups, primer scans, the sharded
reach closure (on the port's owner-routed plain probes), the fused
ingest steps (``make_ingest_step``, ``make_sorted_ingest_step``), the
chunked engine's spectra and the CLI's output files
(``test_torch_cli.py`` runs the sorted store under ``--mirror auto``,
``test_torch_hash_cli.py`` loads checkpoints into a sharded table). The
routed insert and lookup are held to their S-masked form, and the claim
counters to a sweep of the slots. Keys and counts are integers, so
every comparison is exact.
"""

import collections
import os

import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from sharkmer_tpu.engine import CountingEngine as JaxEngine
from sharkmer_tpu.main import main as jax_main
from sharkmer_tpu.ops import ascii_to_codes, codes_to_batch
from sharkmer_tpu.ops.encoding import kmers_from_ascii_ref, seq_to_kmer
from sharkmer_tpu.parallel import make_mesh
from sharkmer_tpu.parallel import sharded_table as jax_sharded_table
from sharkmer_tpu.parallel.sharded_table import ShardedKmerTable as JaxTable
from sharkmer_tpu.parallel.sorted_sharded import ShardedSortedStore as JaxStore
from sharkmer_tpu_torch.engine import CountingEngine
from sharkmer_tpu_torch.kernels import closure, probe
from sharkmer_tpu_torch.kernels.hash import owner as _owner
from sharkmer_tpu_torch.kernels.hash import slot_counts, slot_keys
from sharkmer_tpu_torch.main import main as torch_main
from sharkmer_tpu_torch.ops.keys import keys_to_device, keys_to_numpy
from sharkmer_tpu_torch.parallel.sharded_table import ShardedKmerTable
from sharkmer_tpu_torch.parallel.sorted_sharded import ShardedSortedStore

from data_18s import READ_STRING
from test_cli_e2e import PRIMER_SPEC, tiling_reads
from util import random_genome, reads_from_genome, write_fastq

EMPTY = np.uint64(0xFFFF_FFFF_FFFF_FFFF)
VARYING = ("command", "peak_memory_bytes")
CLASSES = {"hash": (JaxTable, ShardedKmerTable),
           "sorted": (JaxStore, ShardedSortedStore)}


@pytest.fixture(autouse=True)
def _torch_on_cpu(monkeypatch):
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")


def test_owner_matches_jax():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 62, size=20000, dtype=np.uint64)
    for n_shards in (2, 3, 4, 8):
        want = np.asarray(jax_sharded_table._owner(jnp.asarray(keys), n_shards))
        got = _owner(keys_to_device(keys, "cpu"), n_shards).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
        assert len(np.unique(got)) == n_shards


# -- the tables against the JAX tables ---------------------------------------------


def _shard_rows(keys, counts):
    """One shard's occupied (key, count) rows in key order."""
    keys = np.asarray(keys).reshape(-1)
    counts = np.asarray(counts).reshape(-1)
    occ = keys != EMPTY
    order = np.argsort(keys[occ])
    return keys[occ][order], counts[occ][order].astype(np.uint32)


def _port_shards(table):
    if isinstance(table, ShardedKmerTable):
        return [_shard_rows(keys_to_numpy(s.keys),
                            s.counts.numpy().view(np.uint32))
                for s in table.shards]
    return [_shard_rows(keys_to_numpy(k), c.numpy())
            for k, c in zip(table.kmers, table.counts)]


def _assert_same_tables(got, want):
    """Shard for shard: contents, capacity, totals, histogram."""
    assert got.n_shards == want.n_shards
    assert got.local_capacity == want.local_capacity
    for s, (gk, gc) in enumerate(_port_shards(got)):
        wk, wc = _shard_rows(want.keys[s] if hasattr(want, "keys")
                             else want.kmers[s],
                             want.counts[s])
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gc, wc)
    assert got.n_unique() == want.n_unique()
    assert got.n_total() == want.n_total()
    assert got.max_count() == want.max_count()
    np.testing.assert_array_equal(got.histogram(60), want.histogram(60))
    for mc in (1, 3):
        for a, b in zip(got.to_sorted_arrays(mc), want.to_sorted_arrays(mc)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def reads():
    genome = random_genome(3000, seed=21, n_rate=0.005)
    return genome, reads_from_genome(genome, 900, read_len=100, seed=22)


def _batches(reads, n=3):
    step = -(-len(reads) // n)
    return [codes_to_batch([ascii_to_codes(r) for r in reads[i : i + step]])
            for i in range(0, len(reads), step)]


@pytest.mark.parametrize("backend", ["hash", "sorted"])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_table_matches_jax(backend, n_shards, reads):
    """Batches of reads into a small table (it grows), then lookups of
    hits and misses and primer scans (both orientations)."""
    genome, rs = reads
    jax_cls, cls = CLASSES[backend]
    k = 17
    want = jax_cls.create(k, make_mesh(n_shards), local_capacity=1 << 8)
    got = cls.create(k, n_shards, 1 << 8, ["cpu"])
    for codes in _batches(rs):
        want = want.ingest_codes(codes)
        got = got.ingest_codes(codes)
    _assert_same_tables(got, want)
    assert got.local_capacity > 1 << 8

    rng = np.random.default_rng(3)
    keys, _ = want.to_sorted_arrays()
    queries = np.concatenate([keys[::7], rng.integers(0, 1 << 34, size=300,
                                                      dtype=np.uint64)])
    np.testing.assert_array_equal(got.lookup_directional(queries),
                                  want.lookup_directional(queries))
    oligos = np.array([seq_to_kmer(genome[i : i + 6]) for i in (40, 900)],
                      np.uint64)
    for mc in (1, 2):
        gk, gc = got.prefix_scan(oligos, 6, mc)
        wk, wc = want.prefix_scan(oligos, 6, mc)
        assert len(gk) > 0
        if backend == "sorted":  # the order: shard by shard, rows in order
            np.testing.assert_array_equal(gk, wk)
            np.testing.assert_array_equal(gc, wc)
        else:  # slot order within a shard
            assert sorted(zip(gk.tolist(), gc.tolist())) == \
                sorted(zip(wk.tolist(), wc.tolist()))


@pytest.mark.parametrize("backend", ["hash", "sorted"])
def test_sharded_growth_and_merge_match_jax(backend, reads):
    """A table that grows many times from 2^6 slots a shard, explicit
    counts, and ``merge_from`` of two halves, against JAX."""
    _genome, rs = reads
    jax_cls, cls = CLASSES[backend]
    k, n_shards = 19, 4
    mesh = make_mesh(n_shards)
    kms = np.array([m for r in rs for m in kmers_from_ascii_ref(r, k)],
                   np.uint64)
    half = len(kms) // 2
    tables = {}
    for name, make in (("jax", lambda c: jax_cls.create(k, mesh, c)),
                       ("torch",
                        lambda c: cls.create(k, n_shards, c, ["cpu"]))):
        one = make(1 << 6).insert_kmers(kms)
        a = make(1 << 8).insert_kmers(kms[:half])
        b = make(1 << 7).insert_kmers(kms[half:])
        merged = a.merge_from(b)
        model = collections.Counter(kms.tolist())
        counts = np.array(list(model.values()), np.uint32)
        explicit = make(1 << 6).insert_kmers(
            np.array(list(model.keys()), np.uint64), counts)
        tables[name] = (one, merged, explicit)
        assert one.to_dict() == merged.to_dict() == explicit.to_dict() \
            == dict(model)
    for got, want in zip(tables["torch"], tables["jax"]):
        _assert_same_tables(got, want)


def test_sorted_prefix_scan_many_does_not_filter(reads):
    """``prefix_scan_many`` returns every match (min count 1), where
    ``prefix_scan`` filters, in both packages."""
    genome, rs = reads
    k, n_shards = 15, 4
    want = JaxStore.create(k, make_mesh(n_shards), local_capacity=1 << 10)
    got = ShardedSortedStore.create(k, n_shards, 1 << 10, ["cpu"])
    for codes in _batches(rs, 2):
        want.ingest_codes(codes)
        got.ingest_codes(codes)
    requests = [(np.array([seq_to_kmer(genome[i : i + 7])], np.uint64), 7)
                for i in (10, 500, 2000)]
    requests.append((np.array([seq_to_kmer(genome[70:79]),
                               seq_to_kmer(genome[1500:1509])], np.uint64), 9))
    got_many = got.prefix_scan_many(requests)
    for (gk, gc), (wk, wc) in zip(got_many, want.prefix_scan_many(requests)):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gc, wc)
    oligos, olen = requests[0]
    fk, fc = got.prefix_scan(oligos, olen, 3)
    assert len(fk) < len(got_many[0][0]) and (fc >= 3).all()


# -- the sharded reach closure -----------------------------------------------------


def _assert_same_reach(got, want):
    assert got is not None and want is not None
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert (got.complete, got.iters) == (want.complete, want.iters)
    np.testing.assert_array_equal(got.boundary, want.boundary)


@pytest.fixture(scope="module")
def reach_stores():
    k = 11
    genome = random_genome(900, seed=21)
    rs = reads_from_genome(genome, 600, 70, seed=22)
    codes = codes_to_batch([ascii_to_codes(r) for r in rs])
    want = JaxStore.create(k, make_mesh(4), local_capacity=1 << 10)
    got = ShardedSortedStore.create(k, 4, 1 << 10, ["cpu"])
    want.ingest_codes(codes)
    got.ingest_codes(codes)
    assert got.to_dict() == want.to_dict()
    return genome, want, got


def test_sharded_reach_matches_jax(reach_stores):
    genome, want, got = reach_stores
    k = 11
    roots = np.array([seq_to_kmer(genome[i : i + k]) for i in (30, 400, 700)],
                     np.uint64)
    for mc in (1, 3):
        res = got.reach(roots, min_count=mc, depth=4096)
        _assert_same_reach(res, want.reach(roots, min_count=mc, depth=4096))
        assert res.complete and len(res.keys) > 50
    # a depth-capped closure, then a re-prefetch from its boundary
    # warm-started with its interior (PrefetchSession's pattern)
    for mc in (1, 3):
        first = got.reach(roots[:1], min_count=mc, depth=16)
        _assert_same_reach(first, want.reach(roots[:1], min_count=mc,
                                             depth=16))
        assert not first.complete and len(first.boundary)
        roots2 = first.boundary[:4]
        pre = np.setdiff1d(first.keys, np.concatenate([first.boundary,
                                                        roots2]))
        second = got.reach(roots2, min_count=mc, depth=16, pre=pre)
        _assert_same_reach(second, want.reach(roots2, min_count=mc, depth=16,
                                              pre=pre))
        assert len(second.keys)


def test_owner_routed_probes(reach_stores, monkeypatch):
    """The index is owner-routed, its row ids are shard * capacity + row,
    and the plain probe and closure route each key to its owner: the
    same answers as probing every shard with every key."""
    import torch

    genome, _want, got = reach_stores
    table = got._spcr_index().table
    assert table.n_shards == 4
    assert table.bases == tuple(s * got.local_capacity for s in range(4))
    keys = torch.cat(got.kmers)
    keys = keys[keys != (1 << 63) - 1]
    rng = np.random.default_rng(9)
    misses = keys_to_device(rng.integers(0, 1 << 22, size=500,
                                         dtype=np.uint64), "cpu")
    cand = torch.cat([keys, misses])
    own = table.route(cand)
    np.testing.assert_array_equal(own.numpy(), _owner(cand, 4).numpy())
    ids = probe.probe_rows(table, cand, 1)
    every = torch.full_like(ids, probe.INF32)
    for sc, base in zip(table.sidecars, table.bases):
        row = probe.probe_window_plain(sc.keys1d, sc.counts1d, sc.lut,
                                       sc.shift, cand, 1, sc.probe_blocks)
        every = torch.where(row >= 0, row + base, every)
    assert torch.equal(ids, every)
    assert torch.equal(closure.lookup_plain(table, cand, 1), every)
    # in five chunks of candidates, the last one short: the same ids
    window = closure.stack_parts(table, "cpu")[-1] * probe.BLOCK
    chunk = cand.shape[0] // 5 + 1
    monkeypatch.setattr(closure, "LOOKUP_CHUNK_ELEMS", chunk * 4 * window)
    assert torch.equal(closure.lookup_plain(table, cand, 1), every)
    hit = ids[: keys.shape[0]]
    assert bool((hit // got.local_capacity == own[: keys.shape[0]]).all())


# -- owner routing in one launch, the claim counter, the fused steps --------------


def test_routed_insert_and_lookup_match_the_masked_form():
    """One routed insert into ``[S, cap, 2]`` slots, from keys with
    amounts and from another table's slots, gives each shard the rows and
    the claim count of S inserts into separate tables, each of the batch
    masked to the shard's keys; one routed lookup equals the sum of the S
    masked lookups."""
    import torch

    from sharkmer_tpu_torch.kernels import hash as hk

    rng = np.random.default_rng(12)
    k, S, cap = 15, 4, 1 << 10
    kmers = torch.from_numpy(rng.integers(0, 1 << 30, size=1500))
    kmers = torch.cat([kmers, kmers[:700]])
    kmers[rng.random(kmers.numel()) < 0.1] = hk.SENTINEL
    amounts = torch.from_numpy(rng.integers(0, 5, size=kmers.numel())
                               .astype(np.int32))
    own = _owner(kmers, S)
    routed = hk.new_slots((S, cap), "cpu")
    claims = torch.zeros(S, dtype=torch.int64)
    hk.hash_insert(routed, claims, kmers, amounts)
    again = hk.new_slots((S, cap), "cpu")
    again_claims = torch.zeros(S, dtype=torch.int64)
    hk.hash_insert(again, again_claims, routed.view(-1, 2))
    masked = []
    for s in range(S):
        slots = hk.new_slots((cap,), "cpu")
        one = torch.zeros(1, dtype=torch.int64)
        hk.hash_insert(slots, one, torch.where(own == s, kmers, hk.SENTINEL),
                       amounts)
        masked.append(slots)
        want = _shard_rows(keys_to_numpy(hk.slot_keys(slots)),
                           hk.slot_counts(slots).numpy().view(np.uint32))
        for table, counters in ((routed, claims), (again, again_claims)):
            got = _shard_rows(keys_to_numpy(hk.slot_keys(table[s])),
                              hk.slot_counts(table[s]).numpy()
                              .view(np.uint32))
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert int(counters[s]) == int(one) == len(want[0])
    from sharkmer_tpu_torch.ops.histogram import revcomp

    queries = torch.cat([kmers[:800], revcomp(kmers[800:1200], k),
                         torch.from_numpy(rng.integers(0, 1 << 30, size=300))])
    for kk in (0, k):
        canon = queries if not kk else torch.minimum(queries,
                                                     revcomp(queries, kk))
        got = hk.hash_lookup(routed, queries, kk)
        own_q = _owner(canon, S)
        want = sum(hk.as_u32(hk.hash_lookup(
            masked[s], torch.where(own_q == s, canon, hk.SENTINEL)))
            for s in range(S))
        assert torch.equal(hk.as_u32(got), want)
        assert int((got != 0).sum()) > 300


@pytest.mark.parametrize("n_shards", [1, 4])
def test_n_unique_reads_the_claim_counter(tmp_path, reads, n_shards):
    """``n_unique()`` is the claim counter, and equals a sweep of the
    slots after inserts that grow the table, ``merge_from`` and a
    checkpoint load."""
    from sharkmer_tpu_torch.io.checkpoint import load_table, save_table
    from sharkmer_tpu_torch.ops.hashtable import KmerTable

    _genome, rs = reads
    k = 19

    def make(cap):
        if n_shards == 1:
            return KmerTable.create(k, cap, "cpu")
        return ShardedKmerTable.create(k, n_shards, cap // n_shards, ["cpu"])

    def groups(table):  # (slots, claims) tensors of the table's groups
        if n_shards == 1:
            return [table.slots], [table.claims]
        return table.group_slots, table.group_claims

    def check(table):
        slots, claims = groups(table)
        occupied = sum(int((s[..., 0] != (1 << 63) - 1).sum()) for s in slots)
        assert table.n_unique() == sum(int(c.sum()) for c in claims) \
            == occupied > 0
        assert table.n_unique() == len(table.to_dict())

    batches = _batches(rs, 3)
    table = make(1 << 8)
    for codes in batches[:2]:
        table = table.ingest_codes(codes)
        check(table)
    assert sum(s[..., 0].numel() for s in groups(table)[0]) > 1 << 8  # grew
    other = make(1 << 9).ingest_codes(batches[2])
    check(other)
    table = table.merge_from(other)
    check(table)
    path = str(tmp_path / "t.npz")
    save_table(path, table)
    loaded, _ = load_table(path, "cpu", n_shards=n_shards, backend="hash")
    assert type(loaded) is type(table)
    check(loaded)
    assert loaded.to_dict() == table.to_dict()


def _shard_codes(rs, n_shards, per):
    """uint8 [n_shards, per, width]: consecutive reads, ``per`` a shard."""
    codes = codes_to_batch([ascii_to_codes(r) for r in rs[: n_shards * per]])
    return codes.reshape(n_shards, per, codes.shape[-1])


def _jax_sharded(mesh, codes):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(codes, NamedSharding(mesh, P(jax_sharded_table.AXIS,
                                                        None, None)))


def test_make_ingest_step_matches_jax(reads):
    """Two fused steps on a 4-device mesh (JAX) and on 4 logical shards
    (the port, one routed insert a step): each shard's rows, its claim
    count and the summed histogram equal."""
    from sharkmer_tpu.parallel.sharded_table import (
        make_ingest_step as jax_make_ingest_step,
    )
    from sharkmer_tpu_torch.parallel.sharded_table import make_ingest_step

    _genome, rs = reads
    k, S, histo_max, per = 17, 4, 60, 100
    mesh = make_mesh(S)
    jax_step = jax_make_ingest_step(mesh, k, histo_max)
    step = make_ingest_step(["cpu"], k, histo_max)
    want = JaxTable.create(k, mesh, local_capacity=1 << 12)
    keys, counts = want.keys, want.counts
    got = ShardedKmerTable.create(k, S, 1 << 12, ["cpu"])
    slots, claims = got.group_slots, got.group_claims
    for half in (rs[: S * per], rs[S * per :]):
        codes = _shard_codes(half, S, per)
        keys, counts, jax_histo = jax_step(keys, counts,
                                           _jax_sharded(mesh, codes))
        slots, claims, histo = step(slots, claims, codes)
        assert histo.dtype == np.uint64
        np.testing.assert_array_equal(histo, np.asarray(jax_histo))
        for s in range(S):
            wk, wc = _shard_rows(keys[s], counts[s])
            gk, gc = _shard_rows(keys_to_numpy(slot_keys(slots[0][s])),
                                 slot_counts(slots[0][s]).numpy()
                                 .view(np.uint32))
            np.testing.assert_array_equal(gk, wk)
            np.testing.assert_array_equal(gc, wc)
            assert int(claims[0][s]) == len(wk)
    assert slots[0] is got.group_slots[0] and got.n_unique() == int(np.sum(histo[1:]))
    with pytest.raises(ValueError):
        step(ShardedKmerTable.create(k, 2, 1 << 6, ["cpu"]).group_slots, claims,
             codes)


@pytest.mark.parametrize("cap", [1 << 12, 1 << 8])
def test_make_sorted_ingest_step_matches_jax(reads, cap):
    """Two fused sorted steps on a 4-device mesh (JAX) and on 4 logical
    shards (the port): each shard's master row, its counts and the summed
    histogram equal; at 2^8 a shard's keys pass ``cap`` and both cut the
    largest keys away."""
    import torch

    from sharkmer_tpu.parallel.sorted_sharded import (
        make_sorted_ingest_step as jax_make_sorted_ingest_step,
    )
    from sharkmer_tpu_torch.parallel.sorted_sharded import (
        make_sorted_ingest_step,
    )

    _genome, rs = reads
    k, S, histo_max, per = 17, 4, 60, 100
    mesh = make_mesh(S)
    jax_step = jax_make_sorted_ingest_step(mesh, k, histo_max, cap)
    step = make_sorted_ingest_step(["cpu"], k, histo_max, cap)
    want = JaxStore.create(k, mesh, local_capacity=cap)
    jk, jc = want.kmers, want.counts
    got = ShardedSortedStore.create(k, S, cap, ["cpu"])
    pk, pc = got.kmers, got.counts
    for half in (rs[: S * per], rs[S * per :]):
        codes = _shard_codes(half, S, per)
        jk, jc, jax_histo = jax_step(jk, jc, _jax_sharded(mesh, codes))
        pk, pc, histo = step(pk, pc, codes)
        np.testing.assert_array_equal(histo, np.asarray(jax_histo))
        np.testing.assert_array_equal(keys_to_numpy(torch.stack(pk)),
                                      np.asarray(jk))
        np.testing.assert_array_equal(torch.stack(pc).numpy()
                                      .astype(np.uint32), np.asarray(jc))
    full = bool((torch.stack(pk) != (1 << 63) - 1).all())
    assert full == (cap == 1 << 8)


# -- the engine and the CLI ----------------------------------------------------------


@pytest.mark.parametrize("backend", ["hash", "sorted"])
def test_sharded_engine_matches_jax(backend, reads):
    """``CountingEngine(n_shards=4, n_chunks=3)``: stats and every
    histogram snapshot equal the JAX engine's."""
    _genome, rs = reads
    raw = [r.encode() for r in rs]
    engines = [cls(k=17, n_chunks=3, histo_max=60, initial_capacity=1 << 12,
                   n_shards=4, backend=backend, **kw)
               for cls, kw in ((JaxEngine, {}), (CountingEngine,
                                                 {"device": "cpu"}))]
    snaps = []
    for engine in engines:
        engine.ingest(iter(raw))
        snaps.append(engine.consolidate())
    want, got = engines
    assert type(got.table).__name__ == type(want.table).__name__
    assert got.stats.__dict__ == want.stats.__dict__
    assert len(snaps[0]) == len(snaps[1]) == 3
    for a, b in zip(*snaps):
        np.testing.assert_array_equal(b, a)
    assert got.table.to_dict() == want.table.to_dict()


@pytest.fixture(scope="module")
def fastq_18s(tmp_path_factory):
    path = tmp_path_factory.mktemp("reads") / "reads.fastq"
    write_fastq(path, tiling_reads(READ_STRING) + [READ_STRING] * 5)
    return str(path)


def _run(main, out, args):
    rc = main(["-s", "samp", "-k", "21", "-o", str(out),
               "--pcr-primers", PRIMER_SPEC, *args])
    assert rc == 0, args
    return out


def _assert_same_outputs(a_dir, b_dir):
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir))
    assert "samp_18s.fasta" in names
    for name in names:
        a = (a_dir / name).read_bytes()
        b = (b_dir / name).read_bytes()
        if name.endswith(".stats.yaml"):
            a, b = yaml.safe_load(a), yaml.safe_load(b)
            for key in VARYING:
                a.pop(key), b.pop(key)
        assert a == b, name


@pytest.mark.parametrize("extra", [
    ["--mirror", "full"],
    ["--backend", "hash", "--chunks", "4"],
    ["--backend", "hash", "--mirror", "device"],
], ids=["sorted-full", "hash-chunks", "hash-device"])
def test_cli_sharded_outputs_identical(tmp_path, fastq_18s, extra):
    """``--n-shards 4`` in both CLIs, byte-identical outputs (the sorted
    store under ``--mirror auto`` is in ``test_torch_cli.py``)."""
    args = [fastq_18s, "--n-shards", "4", *extra]
    _assert_same_outputs(_run(jax_main, tmp_path / "jax", args),
                         _run(torch_main, tmp_path / "torch", args))
