"""The port's owner shards placed on a list of devices
(``SHARKMER_TORCH_DEVICES``, ``device.shard_devices``), on the CPU.

Every case runs the per-group layout with ``devices = ["cpu"] * D``: D
groups of contiguous shards in separate allocations, one windowed
``hash_insert`` a group, lookups through the shards' pointer table, the
reach closure over per-shard sidecars, gathers and copies between the
groups. The code path is the one that D cards run; on the CPU the plain
versions run it. Each case is held shard for shard to two references:
the JAX package's sharded tables on the conftest's CPU mesh of S
devices, and the port's one-group table (D = 1). (S, D) = (4, 4), (4, 2)
and (8, 3), the last with uneven groups of 3, 3 and 2 shards. Keys and
counts are integers, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from sharkmer_tpu.main import main as jax_main
from sharkmer_tpu.ops import ascii_to_codes, codes_to_batch
from sharkmer_tpu.ops.encoding import seq_to_kmer
from sharkmer_tpu.parallel import make_mesh
from sharkmer_tpu.parallel.sharded_table import ShardedKmerTable as JaxTable
from sharkmer_tpu.parallel.sharded_table import (
    make_ingest_step as jax_make_ingest_step,
)
from sharkmer_tpu.parallel.sorted_sharded import ShardedSortedStore as JaxStore
from sharkmer_tpu.parallel.sorted_sharded import (
    make_sorted_ingest_step as jax_make_sorted_ingest_step,
)
from sharkmer_tpu_torch import device as dev_mod
from sharkmer_tpu_torch.engine import CountingEngine
from sharkmer_tpu_torch.io.checkpoint import load_table, save_table
from sharkmer_tpu_torch.kernels import hash as hk
from sharkmer_tpu_torch.kernels import peer
from sharkmer_tpu_torch.main import main as torch_main
from sharkmer_tpu_torch.ops.histogram import revcomp
from sharkmer_tpu_torch.ops.keys import keys_to_numpy
from sharkmer_tpu_torch.parallel.sharded_table import (
    ShardedKmerTable,
    make_ingest_step,
)
from sharkmer_tpu_torch.parallel.sorted_sharded import (
    ShardedSortedStore,
    make_sorted_ingest_step,
)

from test_torch_sharded import (
    _assert_same_outputs,
    _assert_same_reach,
    _assert_same_tables,
    _batches,
    _jax_sharded,
    _port_shards,
    _run,
    _shard_codes,
    _shard_rows,
)
from util import random_genome, reads_from_genome

LAYOUTS = [(4, 4), (4, 2), (8, 3)]
IDS = [f"S{s}-D{d}" for s, d in LAYOUTS]
CLASSES = {"hash": (JaxTable, ShardedKmerTable),
           "sorted": (JaxStore, ShardedSortedStore)}


@pytest.fixture(autouse=True)
def _torch_on_cpu(monkeypatch):
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    monkeypatch.delenv(dev_mod.DEVICES_ENV, raising=False)


@pytest.fixture(scope="module")
def reads():
    genome = random_genome(3000, seed=21, n_rate=0.005)
    return genome, reads_from_genome(genome, 900, read_len=100, seed=22)


def _cpus(n):
    return ["cpu"] * n


def _assert_same_shards(got, want):
    """Shard for shard, equal rows (the slot layout aside)."""
    assert got.n_shards == want.n_shards
    assert got.local_capacity == want.local_capacity
    for (gk, gc), (wk, wc) in zip(_port_shards(got), _port_shards(want)):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gc, wc)


def _assert_grouped(table, n_shards, n_devices):
    """The table's shards in D groups of contiguous shards, each group in
    its own allocation."""
    assert len(table.devices) == n_devices
    if isinstance(table, ShardedKmerTable):
        sizes = [g.shape[0] for g in table.group_slots]
        ptrs = {g.data_ptr() for g in table.group_slots}
        assert [c.shape[0] for c in table.group_claims] == sizes
    else:
        homes = [table.shard_device(s) for s in range(n_shards)]
        assert homes == [table.devices[s * n_devices // n_shards]
                         for s in range(n_shards)]
        sizes = [sum(1 for s in range(n_shards)
                     if s * n_devices // n_shards == d)
                 for d in range(n_devices)]
        ptrs = {k.data_ptr() for k in table.kmers}
        assert len(ptrs) == n_shards
    assert sizes == [hi - lo for lo, hi in
                     dev_mod.shard_groups(n_shards, n_devices)]
    assert len(ptrs) >= n_devices


# -- the device list ---------------------------------------------------------------


def test_shard_groups_are_contiguous_and_even():
    assert dev_mod.shard_groups(8, 3) == [(0, 3), (3, 6), (6, 8)]
    assert dev_mod.shard_groups(4, 4) == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert dev_mod.shard_groups(4, 1) == [(0, 4)]
    for n_shards in range(1, 17):
        for n_devices in range(1, n_shards + 1):
            groups = dev_mod.shard_groups(n_shards, n_devices)
            for d, (lo, hi) in enumerate(groups):
                assert lo < hi
                assert all(s * n_devices // n_shards == d
                           for s in range(lo, hi))
            assert groups[0][0] == 0 and groups[-1][1] == n_shards
    with pytest.raises(ValueError):
        dev_mod.shard_groups(2, 3)


def test_shard_devices(monkeypatch):
    """The variable wins, repeats allowed; unset on the CPU, one device;
    a missing card, a CUDA list without CUDA, a mixed list and more
    devices than shards raise."""
    cpu = torch.device("cpu")
    assert dev_mod.shard_devices(4, "cpu") == [cpu]
    monkeypatch.setenv(dev_mod.DEVICES_ENV, "cpu,cpu, cpu")
    assert dev_mod.shard_devices(8, "cpu") == [cpu] * 3
    with pytest.raises(ValueError, match="at most one a shard"):
        dev_mod.shard_devices(2, "cpu")
    if not torch.cuda.is_available():
        monkeypatch.setenv(dev_mod.DEVICES_ENV, "cuda:0,cuda:0")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dev_mod.shard_devices(4, "cpu")
    # a machine with one card, as torch would report it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv(dev_mod.DEVICES_ENV, "cuda:0,cuda:3")
    with pytest.raises(RuntimeError, match="does not exist"):
        dev_mod.shard_devices(4, "cpu")
    monkeypatch.setenv(dev_mod.DEVICES_ENV, "cpu,cuda:0")
    with pytest.raises(ValueError, match="mixes"):
        dev_mod.shard_devices(4, "cpu")
    monkeypatch.setenv(dev_mod.DEVICES_ENV, "cuda:0,cuda:0,cuda:0,cuda:0")
    assert dev_mod.shard_devices(4, "cpu") == [torch.device("cuda", 0)] * 4
    monkeypatch.delenv(dev_mod.DEVICES_ENV)
    # unset: the first min(S, cards) cards
    assert dev_mod.shard_devices(4, "cuda") == [torch.device("cuda", 0)]
    # a kernel on the CPU reads no CUDA tensor, and the other way round
    with pytest.raises(ValueError, match="cannot read"):
        peer.check_readable("cpu", "cuda:0")
    with pytest.raises(ValueError, match="cannot read"):
        peer.check_readable("cuda:0", "cpu")
    peer.check_readable("cpu", "cpu")


def test_engine_takes_the_device_list(monkeypatch):
    monkeypatch.setenv(dev_mod.DEVICES_ENV, "cpu,cpu")
    engine = CountingEngine(k=17, device="cpu", n_shards=4, backend="hash")
    assert engine.devices == [torch.device("cpu")] * 2
    assert len(engine.table.group_slots) == 2
    for n_chunks, backend in ((3, "hash"), (3, "sorted")):
        engine = CountingEngine(k=17, device="cpu", n_shards=4,
                                n_chunks=n_chunks, backend=backend)
        assert len(engine._chunk_table(0).devices) == 2
    assert CountingEngine(k=17, device="cpu").devices == [torch.device("cpu")]


@pytest.mark.parametrize("n_devices", [1, 2])
def test_lookup_reads_one_group_without_pointers(monkeypatch, reads,
                                                 n_devices):
    """A table in one group looks up in its ``[S, cap, 2]`` tensor (the
    kernel's one-allocation mode), several groups through the pointer
    table; the answers are the same. A device name that is not a list
    raises."""
    from sharkmer_tpu_torch.parallel import sharded_table

    _genome, rs = reads
    seen = []

    def spy(slots, queries, k=0, pointers=None):
        seen.append(isinstance(slots, torch.Tensor))
        return hk.hash_lookup(slots, queries, k, pointers)

    monkeypatch.setattr(sharded_table, "hash_lookup", spy)
    one = ShardedKmerTable.create(17, 4, 1 << 8, ["cpu"])
    got = ShardedKmerTable.create(17, 4, 1 << 8, _cpus(n_devices))
    for codes in _batches(rs, 2):
        one.ingest_codes(codes)
        got.ingest_codes(codes)
    keys, _ = one.to_sorted_arrays()
    want = one.lookup_directional(keys[::5])
    np.testing.assert_array_equal(got.lookup_directional(keys[::5]), want)
    assert want.min() > 0 and seen == [True, n_devices == 1]
    for cls in (ShardedKmerTable, ShardedSortedStore):
        with pytest.raises(TypeError, match="list of devices"):
            cls.create(17, 4, 1 << 8, "cpu")


# -- the kernels' plain versions on groups -----------------------------------------


@pytest.mark.parametrize("n_shards,n_devices", LAYOUTS, ids=IDS)
def test_windowed_insert_and_pointer_lookup(n_shards, n_devices):
    """One windowed ``hash_insert`` a group equals the one-launch routed
    insert into ``[S, cap, 2]``, shard for shard and claim for claim,
    from keys with amounts and from another table's slots; the lookup
    over the groups equals the routed lookup; a window that does not fit
    the route raises."""
    rng = np.random.default_rng(12)
    k, cap = 15, 1 << 9
    kmers = torch.from_numpy(rng.integers(0, 1 << 30, size=1500))
    kmers = torch.cat([kmers, kmers[:700]])
    kmers[rng.random(kmers.numel()) < 0.1] = hk.SENTINEL
    amounts = torch.from_numpy(rng.integers(0, 5, size=kmers.numel())
                               .astype(np.int32))
    routed = hk.new_slots((n_shards, cap), "cpu")
    claims = torch.zeros(n_shards, dtype=torch.int64)
    hk.hash_insert(routed, claims, kmers, amounts)
    groups = dev_mod.shard_groups(n_shards, n_devices)
    for source in ("keys", "slots"):
        slots = [hk.new_slots((hi - lo, cap), "cpu") for lo, hi in groups]
        counters = [torch.zeros(hi - lo, dtype=torch.int64)
                    for lo, hi in groups]
        for (lo, _), g_slots, g_claims in zip(groups, slots, counters):
            if source == "keys":
                hk.hash_insert(g_slots, g_claims, kmers, amounts,
                               shard_lo=lo, n_shards=n_shards)
            else:
                hk.hash_insert(g_slots, g_claims, routed.view(-1, 2),
                               shard_lo=lo, n_shards=n_shards)
        flat = torch.cat(slots)
        for s in range(n_shards):
            want = _shard_rows(keys_to_numpy(hk.slot_keys(routed[s])),
                               hk.slot_counts(routed[s]).numpy()
                               .view(np.uint32))
            got = _shard_rows(keys_to_numpy(hk.slot_keys(flat[s])),
                              hk.slot_counts(flat[s]).numpy().view(np.uint32))
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        assert torch.equal(torch.cat(counters), claims)

    queries = torch.cat([kmers[:800], revcomp(kmers[800:1200], k),
                         torch.from_numpy(rng.integers(0, 1 << 30, size=300))])
    for kk in (0, k):
        want = hk.hash_lookup(routed, queries, kk)
        assert torch.equal(hk.hash_lookup(slots, queries, kk), want)
        assert torch.equal(hk.lookup_plain(slots, queries, kk), want)
        assert int((want != 0).sum()) > 300
    # the pointer table: each shard's slot 0, shards in order
    ptrs = hk.slot_pointers(slots, "cpu")
    assert ptrs.tolist() == [g.data_ptr() + j * cap * 16
                             for g in slots for j in range(g.shape[0])]
    lo, hi = groups[-1]
    with pytest.raises(ValueError, match="window"):
        hk.hash_insert(slots[-1], counters[-1], kmers, shard_lo=lo + 1,
                       n_shards=n_shards)


# -- the tables against JAX and the one-group table -----------------------------------


@pytest.mark.parametrize("n_shards,n_devices", LAYOUTS, ids=IDS)
@pytest.mark.parametrize("backend", ["hash", "sorted"])
def test_tables_on_device_groups(backend, n_shards, n_devices, reads):
    """Batches into a small table (it grows), ``merge_from`` of a second
    table, then lookups and primer scans: the D-group table equals the
    JAX table on its S-device mesh and the port's one-group table."""
    genome, rs = reads
    jax_cls, cls = CLASSES[backend]
    k = 17
    batches = _batches(rs, 3)
    want = jax_cls.create(k, make_mesh(n_shards), local_capacity=1 << 6)
    one = cls.create(k, n_shards, 1 << 6, ["cpu"])
    got = cls.create(k, n_shards, 1 << 6, devices=_cpus(n_devices))
    other_j = jax_cls.create(k, make_mesh(n_shards), local_capacity=1 << 7)
    other_1 = cls.create(k, n_shards, 1 << 7, ["cpu"])
    other_g = cls.create(k, n_shards, 1 << 7, devices=_cpus(n_devices))
    for codes in batches[:2]:
        want, one, got = (t.ingest_codes(codes) for t in (want, one, got))
    other_j, other_1, other_g = (t.ingest_codes(batches[2])
                                 for t in (other_j, other_1, other_g))
    want, one, got = (want.merge_from(other_j), one.merge_from(other_1),
                      got.merge_from(other_g))
    _assert_grouped(got, n_shards, n_devices)
    assert got.local_capacity > 1 << 6  # it grew
    _assert_same_tables(got, want)
    _assert_same_shards(got, one)
    if backend == "hash":
        assert torch.equal(torch.cat(got.group_claims), one.group_claims[0])

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
        ok, oc = one.prefix_scan(oligos, 6, mc)
        np.testing.assert_array_equal(gk, ok)  # shard order, as one group
        np.testing.assert_array_equal(gc, oc)
        wk, wc = want.prefix_scan(oligos, 6, mc)
        assert sorted(zip(gk.tolist(), gc.tolist())) == \
            sorted(zip(wk.tolist(), wc.tolist())) and len(gk)


@pytest.mark.parametrize("n_shards,n_devices", LAYOUTS, ids=IDS)
def test_reach_over_device_groups(n_shards, n_devices):
    """The sharded reach closure over per-shard sidecars in D groups:
    keys, counts, ``complete``, ``iters`` and boundary equal JAX's and
    the one-group store's, cold and warm-started."""
    k = 11
    genome = random_genome(900, seed=21)
    rs = reads_from_genome(genome, 600, 70, seed=22)
    codes = codes_to_batch([ascii_to_codes(r) for r in rs])
    want = JaxStore.create(k, make_mesh(n_shards), local_capacity=1 << 9)
    one = ShardedSortedStore.create(k, n_shards, 1 << 9, ["cpu"])
    got = ShardedSortedStore.create(k, n_shards, 1 << 9,
                                    devices=_cpus(n_devices))
    for store in (want, one, got):
        store.ingest_codes(codes)
    table = got._spcr_index().table
    assert table.n_shards == n_shards and table.device.type == "cpu"
    assert len({sc.keys1d.data_ptr() for sc in table.sidecars}) == n_shards
    roots = np.array([seq_to_kmer(genome[i : i + k]) for i in (30, 400)],
                     np.uint64)
    for mc in (1, 3):
        res = got.reach(roots, min_count=mc, depth=4096)
        _assert_same_reach(res, want.reach(roots, min_count=mc, depth=4096))
        _assert_same_reach(res, one.reach(roots, min_count=mc, depth=4096))
        assert res.complete and len(res.keys) > 50
    first = got.reach(roots[:1], min_count=1, depth=16)
    _assert_same_reach(first, want.reach(roots[:1], min_count=1, depth=16))
    assert not first.complete and len(first.boundary)
    roots2 = first.boundary[:4]
    pre = np.setdiff1d(first.keys, np.concatenate([first.boundary, roots2]))
    second = got.reach(roots2, min_count=1, depth=16, pre=pre)
    _assert_same_reach(second, want.reach(roots2, min_count=1, depth=16,
                                          pre=pre))
    _assert_same_reach(second, one.reach(roots2, min_count=1, depth=16,
                                         pre=pre))


@pytest.mark.parametrize("n_shards,n_devices", LAYOUTS, ids=IDS)
def test_checkpoint_through_device_groups(tmp_path, monkeypatch, reads,
                                          n_shards, n_devices):
    """A D-group table saves the one-group table's arrays, and a load
    with the device list set (or passed) builds the groups again."""
    _genome, rs = reads
    k = 19
    one = ShardedKmerTable.create(k, n_shards, 1 << 7, ["cpu"])
    got = ShardedKmerTable.create(k, n_shards, 1 << 7,
                                  devices=_cpus(n_devices))
    for codes in _batches(rs, 2):
        one.ingest_codes(codes)
        got.ingest_codes(codes)
    paths = [str(tmp_path / f"{name}.npz") for name in ("one", "groups")]
    save_table(paths[0], one)
    save_table(paths[1], got)
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        for name in ("keys", "counts", "meta"):
            np.testing.assert_array_equal(a[name], b[name])
    monkeypatch.setenv(dev_mod.DEVICES_ENV, ",".join(_cpus(n_devices)))
    for backend in ("hash", "sorted"):  # n_shards > 1: a ShardedKmerTable
        loaded, _ = load_table(paths[1], "cpu", n_shards=n_shards,
                               backend=backend)
        assert type(loaded) is ShardedKmerTable
        _assert_grouped(loaded, n_shards, n_devices)
        assert loaded.to_dict() == one.to_dict()
        assert loaded.n_unique() == one.n_unique() == len(one.to_dict())
    monkeypatch.delenv(dev_mod.DEVICES_ENV)
    passed, _ = load_table(paths[0], "cpu", n_shards=n_shards,
                           devices=_cpus(n_devices))
    _assert_grouped(passed, n_shards, n_devices)
    _assert_same_shards(passed, loaded)


# -- the fused ingest steps ------------------------------------------------------------


@pytest.mark.parametrize("n_shards,n_devices", LAYOUTS, ids=IDS)
@pytest.mark.parametrize("backend", ["hash", "sorted"])
def test_ingest_steps_on_device_groups(reads, backend, n_shards, n_devices):
    """``make_ingest_step`` / ``make_sorted_ingest_step`` on D groups:
    two steps equal JAX's on the S-device mesh, shard for shard, with
    equal summed histograms (the sorted one at a ``cap`` that cuts)."""
    _genome, rs = reads
    k, histo_max, per = 17, 60, 50
    mesh = make_mesh(n_shards)
    devices = _cpus(n_devices)
    if backend == "hash":
        jax_step = jax_make_ingest_step(mesh, k, histo_max)
        step = make_ingest_step(devices, k, histo_max)
        want = JaxTable.create(k, mesh, local_capacity=1 << 10)
        got = ShardedKmerTable.create(k, n_shards, 1 << 10, devices=devices)
        jstate, state = (want.keys, want.counts), (got.group_slots,
                                                   got.group_claims)
    else:
        cap = 1 << 8
        jax_step = jax_make_sorted_ingest_step(mesh, k, histo_max, cap)
        step = make_sorted_ingest_step(devices, k, histo_max, cap)
        want = JaxStore.create(k, mesh, local_capacity=cap)
        got = ShardedSortedStore.create(k, n_shards, cap, devices=devices)
        jstate, state = (want.kmers, want.counts), (got.kmers, got.counts)
    for i in range(2):
        codes = _shard_codes(rs[i * n_shards * per :], n_shards, per)
        *jstate, jax_histo = jax_step(*jstate, _jax_sharded(mesh, codes))
        *state, histo = step(*state, codes)
        np.testing.assert_array_equal(histo, np.asarray(jax_histo))
        if backend == "hash":
            shards = [g[j] for g in state[0] for j in range(g.shape[0])]
            rows = [_shard_rows(keys_to_numpy(hk.slot_keys(s)),
                                hk.slot_counts(s).numpy().view(np.uint32))
                    for s in shards]
            assert [int(c) for c in torch.cat(state[1])] == \
                [len(r[0]) for r in rows]
        else:
            rows = [(keys_to_numpy(mk), mc.numpy().astype(np.uint32))
                    for mk, mc in zip(*state)]
        for s, (gk, gc) in enumerate(rows):
            wk, wc = _shard_rows(jstate[0][s], jstate[1][s])
            if backend == "sorted":  # the master row itself, sentinels too
                np.testing.assert_array_equal(gk, np.asarray(jstate[0][s]))
                np.testing.assert_array_equal(gc, np.asarray(jstate[1][s]))
            else:
                np.testing.assert_array_equal(gk, wk)
                np.testing.assert_array_equal(gc, wc)


# -- the CLI ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fastq_18s(tmp_path_factory):
    from data_18s import READ_STRING
    from test_cli_e2e import tiling_reads
    from util import write_fastq

    path = tmp_path_factory.mktemp("reads") / "reads.fastq"
    write_fastq(path, tiling_reads(READ_STRING) + [READ_STRING] * 5)
    return str(path)


@pytest.mark.parametrize("extra", [
    [],
    ["--backend", "hash", "--chunks", "3"],
    ["--backend", "hash", "--mirror", "device"],
], ids=["sorted-reach", "hash-chunks", "hash-device"])
def test_cli_on_device_groups(tmp_path, monkeypatch, fastq_18s, extra):
    """``SHARKMER_TORCH_DEVICES=cpu,cpu,cpu,cpu --n-shards 4``: the port's
    CLI on four device groups gives the JAX CLI's output files."""
    args = [fastq_18s, "--n-shards", "4", *extra]
    want = _run(jax_main, tmp_path / "jax", args)
    monkeypatch.setenv(dev_mod.DEVICES_ENV, "cpu,cpu,cpu,cpu")
    _assert_same_outputs(want, _run(torch_main, tmp_path / "torch", args))
