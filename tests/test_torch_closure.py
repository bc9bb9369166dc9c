"""The port's one-launch reach closure (``kernels/closure.py``) and its
key-range routing, against the JAX package.

On the CPU the ``reach_closure`` wrapper runs its plain version (the
closure loop over ``probe_window_plain``); ``chip_smoke.py`` holds the
CUDA kernel to that plain version on the card. Keys and counts are
integers, so every comparison is exact.
"""

import collections

import numpy as np
import pytest
import torch

from sharkmer_tpu.ops.encoding import revcomp_kmers_np, seq_to_kmer
from sharkmer_tpu.ops.sorted_store import SortedKmerStore as JaxStore
from sharkmer_tpu_torch.kernels import closure, probe
from sharkmer_tpu_torch.ops import reach
from sharkmer_tpu_torch.ops.histogram import revcomp
from sharkmer_tpu_torch.ops.keys import SENTINEL, keys_to_device
from sharkmer_tpu_torch.ops.sorted_store import SortedKmerStore
from sharkmer_tpu_torch.parallel.sorted_sharded import ShardedSortedStore

from test_torch_reach import _assert_same, _codes, _stores, _table
from util import random_genome


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU paths run many small torch ops (the plain closure
    loop a level at a time): on one intra-op thread they take a fraction
    of the time they take on several beside other busy processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


K = 11


def _genome_stores(first_reads=0, n_bases=1500, n_reads=750, read_len=80,
                   seeds=(4, 1), with_jax=True):
    """(genome, (JAX store, port store)) fed the same reads; without
    ``with_jax`` only the port's store (the JAX one is None)."""
    genome = random_genome(n_bases, seed=seeds[0])
    codes = _codes(genome, n_reads, read_len, seed=seeds[1])
    if with_jax:
        return genome, _stores(codes, K, first_reads=first_reads)
    tstore = SortedKmerStore(K, "cpu")
    if first_reads:
        tstore.ingest_codes(codes[:first_reads])
        tstore.n_unique()
    tstore.ingest_codes(codes[first_reads:])
    return genome, (None, tstore)


def _case_complete(monkeypatch, with_jax=True):
    genome, (jstore, tstore) = _genome_stores(with_jax=with_jax)
    roots = np.array([seq_to_kmer(genome[i : i + K]) for i in (200, 1100)],
                     np.uint64)
    return jstore, tstore, [dict(roots=roots, min_count=2, depth=4096)]


def _case_depth_capped_pre(monkeypatch, with_jax=True):
    """A depth-capped call, then a re-prefetch from its boundary warm-
    started with its interior, as PrefetchSession does."""
    genome, (jstore, tstore) = _genome_stores(with_jax=with_jax)
    roots = np.array([seq_to_kmer(genome[700 : 700 + K])], np.uint64)
    first = tstore.reach(roots, min_count=1, depth=24)
    roots2 = first.boundary[:8]
    pre = np.setdiff1d(first.keys, np.concatenate([first.boundary, roots2]))
    return jstore, tstore, [dict(roots=roots, min_count=1, depth=24),
                            dict(roots=roots2, min_count=1, depth=24, pre=pre)]


def _case_multi_partition(monkeypatch, with_jax=True):
    monkeypatch.setenv("SHARKMER_MAX_AGG", str(1 << 9))  # tiny partitions
    genome, (jstore, tstore) = _genome_stores(
        first_reads=3, n_bases=800, n_reads=300, read_len=70, seeds=(6, 7),
        with_jax=with_jax)
    assert len(tstore._flushed().parts) > 2
    root = np.array([seq_to_kmer(genome[300 : 300 + K])], np.uint64)
    return jstore, tstore, [dict(roots=root, min_count=1, depth=4096),
                            dict(roots=root, min_count=1, depth=40)]


def _case_spill(monkeypatch, with_jax=True):
    """More visited rows than the OUT_W prefix: each key its own root."""
    k, n = 21, reach.OUT_W + 4000
    keys, counts = _table(n, 1 << 15, k, seed=7, max_count=50)
    jstore = JaxStore.create(k) if with_jax else None
    if with_jax:
        jstore.insert_kmers(keys[:n], counts[:n])
    tstore = SortedKmerStore.from_arrays(k, keys[:n], counts[:n], "cpu")
    return jstore, tstore, [dict(roots=keys[:n], min_count=2, depth=64)]


CASES = {
    "complete": _case_complete,
    "depth_capped_pre": _case_depth_capped_pre,
    "multi_partition": _case_multi_partition,
    "spill": _case_spill,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_closure_wrapper_matches_jax(case, monkeypatch):
    """Every closure of the case goes through ``reach_closure``'s CPU
    dispatch and gives the JAX closure's keys, counts, ``complete``,
    ``iters`` and boundary."""
    jstore, tstore, calls = CASES[case](monkeypatch)
    seen = []
    wrapped = reach.reach_closure

    def spy(table, c0, pre_ids, min_count, k, depth, f_cap, f_narrow):
        out = wrapped(table, c0, pre_ids, min_count, k, depth, f_cap,
                      f_narrow)
        seen.append((table, depth, f_cap, out))
        return out

    monkeypatch.setattr(reach, "reach_closure", spy)
    for call in calls:
        n_seen = len(seen)
        got = tstore.reach(**call)
        _assert_same(got, jstore.reach(**call))
        assert len(seen) > n_seen
        # the iters of _drive_closure's calls add up to the result's; retries
        # that overflowed are discarded
        kept = [closure.unpack_state(out[2]) for *_, out in seen[n_seen:]]
        assert sum(s[1] for s in kept if not s[2]) == got.iters
    for table, depth, f_cap, (log, boundary, state) in seen:
        assert log.shape == (closure.closure_log_w(depth, f_cap),)
        assert boundary.shape == (f_cap,) and state.shape == (4,)
    assert reach.reach_closure is spy
    assert closure.reach_closure.launches == 0  # CPU: no kernel launch
    if case == "spill":
        assert len(got.keys) > reach.OUT_W


# -- key-range routing -----------------------------------------------------------


def _multi_partition_store(monkeypatch):
    monkeypatch.setenv("SHARKMER_MAX_AGG", str(1 << 10))
    _genome, (_jstore, tstore) = _genome_stores(
        first_reads=3, n_bases=800, n_reads=300, read_len=70, seeds=(6, 7))
    return tstore, K


def _ghost_cut_store(monkeypatch):
    """The input of test_torch_store.py::test_ghosted_run_wider_than_a_
    partition (a ghosted first drain wider than a partition) at a quarter
    of its drain budget, so that the table spans several partitions."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 10, size=3000, dtype=np.uint64)
    more = rng.integers(0, 1 << 11, size=9000, dtype=np.uint64)
    store = SortedKmerStore(21, "cpu", max_agg=1 << 10)
    store.insert_kmers(keys)
    store.insert_kmers(more)
    model = collections.Counter(keys.tolist() + more.tolist())
    assert store.to_dict() == dict(model)
    return store, 21


ROUTING = {"multi_partition": _multi_partition_store,
           "ghost_cut": _ghost_cut_store}


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_routed_probe_equals_all_partition_lookup(case, monkeypatch):
    """``route_plain`` (a searchsorted of the partitions' first keys)
    sends each key to the one partition that can hold it: the routed
    probe equals probing every partition, at every min count."""
    store, k = ROUTING[case](monkeypatch)
    index = store._spcr_index()
    table = index.table
    assert len(table.sidecars) > 1
    held = [sc.keys1d[sc.keys1d != SENTINEL] for sc in table.sidecars]
    for i, part_keys in enumerate(held):
        assert (probe.route_plain(table.first_keys, part_keys) == i).all()
    rng = np.random.default_rng(9)
    table_keys = torch.cat(held)
    cand = torch.cat([
        table_keys, table_keys + 1, table_keys - 1,
        keys_to_device(rng.integers(0, 1 << (2 * k), size=2000,
                                    dtype=np.uint64), "cpu"),
        torch.full((50,), SENTINEL, dtype=torch.int64),
    ])
    cand = cand[cand >= 0]
    for mc in (1, 2, 3):
        want = closure.lookup_plain(table, cand, mc)
        got = probe.probe_rows(table, cand, mc)
        assert got.dtype == torch.int32
        assert torch.equal(got, want)
        assert int((got != probe.INF32).sum()) > 0
        # in five chunks of candidates, the last one short: the same ids
        window = closure.stack_parts(table, "cpu")[-1] * probe.BLOCK
        chunk = cand.shape[0] // 5 + 1
        monkeypatch.setattr(closure, "LOOKUP_CHUNK_ELEMS",
                            chunk * len(table.sidecars) * window)
        assert torch.equal(closure.lookup_plain(table, cand, mc), want)
        monkeypatch.undo()
    assert probe.probe_rows.launches == 0  # CPU: no kernel launch


# -- scratch sizing, state unpacking, partition descriptors ----------------------


def test_scratch_and_state_give_reach_call_tuple(monkeypatch):
    """The kernel's scratch has the shapes of ``_reach_call``'s outputs,
    and the packed state unpacks to its scalars (and the JAX result's)."""
    jstore, tstore, (call,) = _case_complete(monkeypatch)
    index = tstore._spcr_index()
    table = index.table
    depth, f_cap, f_narrow = call["depth"], reach.F_CAP, reach.F_NARROW
    c0 = np.full(8 * f_cap, reach.EMPTY, np.uint64)
    c0[:2] = np.unique(call["roots"])
    keys, counts, boundary, scalars, log_sorted = reach._reach_call(
        table, keys_to_device(c0, "cpu"), call["min_count"], K, depth, f_cap,
        f_narrow)
    scratch = closure.closure_scratch(table.n_rows, depth, f_cap, "cpu")
    assert scratch["log"].shape == log_sorted.shape
    assert scratch["log"].dtype == log_sorted.dtype == torch.int32
    assert (scratch["log"] == probe.INF32).all()
    assert scratch["boundary"].shape == boundary.shape == (f_cap,)
    assert scratch["bitmap"].dtype == torch.int32
    assert 32 * scratch["bitmap"].numel() - 32 < table.n_rows
    assert table.n_rows <= 32 * scratch["bitmap"].numel()
    assert not scratch["bitmap"].any()
    assert scratch["front"].shape == (4 * f_cap,)
    assert scratch["state"].shape == (4,)

    want = jstore.reach(call["roots"], min_count=call["min_count"],
                        depth=depth)
    n_vis, iters, overflow, done = scalars
    assert [n_vis, iters, overflow, done] == [
        len(want.keys), want.iters, 0, int(want.complete)]
    np.testing.assert_array_equal(
        keys[:n_vis].numpy().astype(np.uint64), want.keys)
    state = torch.tensor(scalars, dtype=torch.int64)
    assert closure.unpack_state(state) == scalars
    assert all(type(v) is int for v in closure.unpack_state(state))


def test_part_descriptors_follow_the_kernel_layout(monkeypatch):
    """``PartTable.desc`` packs each partition as ``csrc/probe_rows.cuh``
    ``PartDesc`` reads it: three pointers (the LUT's is ``table.luts``',
    the partition's own LUT on the launching device), the first key, then
    int32 n_lut, shift and base."""
    store, _k = _multi_partition_store(monkeypatch)
    index = store._spcr_index()
    table = index.table
    desc = table.desc
    assert desc.shape == (len(table.sidecars), 6) and desc.dtype == torch.int64
    words = desc.view(torch.int32).reshape(-1, 12)
    assert table.lut_copy_bytes == 0
    for row, half, sc, base, lut in zip(desc, words, table.sidecars,
                                        table.bases, table.luts):
        assert lut is sc.lut
        assert row[:3].tolist() == [sc.keys1d.data_ptr(),
                                    sc.counts1d.data_ptr(), lut.data_ptr()]
        assert int(row[3]) == sc.first_key
        assert half[8:11].tolist() == [sc.lut.shape[0], sc.shift, base]
    assert table.first_keys.tolist() == [p.first_key for p in store.parts]
    assert table.first_keys[0] == 0
    assert (table.first_keys[1:] > table.first_keys[:-1]).all()


# -- the kernel's claim protocol, as a model ----------------------------------


def _claim_model(table, c0, pre_ids, min_count, k, depth, f_cap, f_narrow,
                 n_cta, rng, found=None):
    """``csrc/reach_closure.cu``'s claim protocol in numpy, on one
    attempt's arguments: each level's candidates go out in units of 4 (a
    warp's round), unit u to CTA ``u % n_cta``; the CTAs' units arrive
    interleaved at random, the groups of a unit claim in a random order
    (a row's first claim sets its visited bit, later ones find it set),
    and a unit's first visits take consecutive slots in lane order (one
    counter add a warp). Slots below the level's width feed the next
    frontier and the log. More claims than the width keep the ``width``
    smallest ids, found by the kernel's bisection (``keep_smallest``),
    and clear the others' bits. The phase loops and the state update
    are the kernel's. ``found``: a dict of the keys' row ids
    (``lookup_plain``) that calls on the same table and floor share.
    Returns (n_vis, iters, overflow, done, visited ids, boundary keys)."""
    inf = probe.INF32
    visited = np.zeros(table.n_rows + 1, bool)
    visited[table.n_rows] = True  # stands for INF: no row, never claimed
    if pre_ids is not None:
        pre = pre_ids.numpy()
        visited[pre[pre != inf]] = True
    u64 = np.uint64
    kmask, top = u64((1 << (2 * k)) - 1), u64(2 * (k - 1))
    base = np.arange(4, dtype=np.uint64)
    found = {} if found is None else found

    def lookup(keys):
        """``lookup_plain``'s row id of each key, each new key probed once."""
        new = np.unique(keys[[key not in found for key in keys.tolist()]])
        if len(new):
            ids = closure.lookup_plain(
                table, torch.from_numpy(new.astype(np.int64)),
                min_count).numpy()
            found.update(zip(new.tolist(), ids.tolist()))
        return np.array([found[key] for key in keys.tolist()], np.int64)

    def expand(keys, rcs):
        """The kernel's 8 candidates of each walker, canonical, with
        their reverse complements."""
        f, r = keys[:, None], rcs[:, None]
        c = np.concatenate([((f << u64(2)) | base) & kmask,
                            (base << top) | (f >> u64(2))], axis=1)
        c_rc = np.concatenate([((u64(3) - base) << top) | (r >> u64(2)),
                               ((r << u64(2)) | (u64(3) - base)) & kmask],
                              axis=1)
        return (np.minimum(c, c_rc).reshape(-1),
                np.maximum(c, c_rc).reshape(-1))

    def level(keys, rcs, width):
        ids = lookup(keys)
        unit = np.arange(len(keys)) // 4
        n_units = (len(keys) + 3) // 4
        # each CTA's units in their order, the CTAs interleaved at random
        t = rng.random(n_units)
        for r in range(n_cta):
            t[r::n_cta] = np.sort(t[r::n_cta])
        arrival = np.argsort(np.argsort(t))[unit]
        order = np.lexsort((rng.random(len(keys)), arrival))
        order = order[~visited[np.minimum(ids[order], table.n_rows)]]
        _, first = np.unique(ids[order], return_index=True)
        claims = order[first]
        visited[ids[claims]] = True
        claims = claims[np.lexsort((claims, arrival[claims]))]  # slot order
        n = len(claims)
        if n > width:
            lo, hi = 0, inf - 1
            while lo < hi:
                mid = lo + (hi - lo) // 2
                if (ids[claims] <= mid).sum() >= width:
                    hi = mid
                else:
                    lo = mid + 1
            visited[ids[claims][ids[claims] > lo]] = False
            claims = claims[ids[claims] <= lo]
            assert len(claims) == width
            claims = claims[rng.permutation(width)]
        return keys[claims], rcs[claims], ids[claims], n

    roots = c0.numpy()
    roots = roots[roots != int(SENTINEL)].astype(np.uint64)
    roots_rc = revcomp(torch.from_numpy(roots.astype(np.int64)), k).numpy()
    roots_rc = roots_rc.astype(np.uint64)
    state = {"n_vis": 0, "it": 0, "overflow": 0, "done": 0}
    log = []

    def step(keys, rcs, width):
        keys, rcs, ids, n = level(keys, rcs, width)
        log.extend(ids.tolist())
        state["overflow"] |= int(n > width)
        state["n_vis"] += min(n, width)
        state["it"] += 1
        state["done"] = int(min(n, width) == 0)
        return keys, rcs

    def running():
        return (state["it"] <= depth and not state["done"]
                and not state["overflow"])

    front = step(np.minimum(roots, roots_rc), np.maximum(roots, roots_rc),
                 f_cap)
    if f_narrow < f_cap:
        while running() and len(front[0]) > f_narrow:
            front = step(*expand(*front), f_cap)
        while running():
            for _ in range(4):
                front = step(*expand(*front), f_narrow)
    else:
        while running():
            front = step(*expand(*front), f_cap)
    return (state["n_vis"], state["it"], state["overflow"], state["done"],
            sorted(log), sorted(set(front[0].astype(np.int64).tolist())))


def _case_narrow_overflow(monkeypatch, with_jax=False):
    """Every canonical 7-mer, counts in [1, 4), floor 2: from one root the
    closure branches ~5 ways a level, so an attempt overflows in its
    narrow phase (the root claims one row) and _drive_closure retries it
    wider until none is left."""
    k = 7
    everything = np.arange(1 << (2 * k), dtype=np.uint64)
    keys = np.unique(np.minimum(everything, revcomp_kmers_np(everything, k)))
    counts = np.random.default_rng(3).integers(1, 4, size=len(keys))
    tstore = SortedKmerStore.from_arrays(k, keys, counts.astype(np.uint32),
                                         "cpu")
    root = keys[counts >= 2][:1]
    return None, tstore, [dict(roots=root, min_count=2, depth=64)]


MODEL_CASES = {**CASES, "narrow_overflow": _case_narrow_overflow}
# a case's attempts, each with its closure_plain result and its lookups,
# shared by the n_cta cases of one process
_MODEL_ATTEMPTS = {}


def _model_attempts(case, monkeypatch):
    """[(args, closure_plain's (log, boundary, state), lookups)] of every
    ``reach_closure`` attempt of the case's closures."""
    if case not in _MODEL_ATTEMPTS:
        _jstore, tstore, calls = MODEL_CASES[case](monkeypatch,
                                                   with_jax=False)
        attempts = []
        wrapped = reach.reach_closure

        def spy(*args):
            out = wrapped(*args)  # the CPU path: closure_plain
            attempts.append((args, out, {}))
            return out

        monkeypatch.setattr(reach, "reach_closure", spy)
        for call in calls:
            tstore.reach(**call)
        _MODEL_ATTEMPTS[case] = attempts
    return _MODEL_ATTEMPTS[case]


@pytest.mark.parametrize("n_cta", [1, 16])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_claim_protocol_model_matches_plain(case, n_cta, monkeypatch):
    """Every attempt of the case's closures, through the model of the
    kernel's claim protocol with a level's candidates split over
    ``n_cta`` CTAs and lane groups in two random arrival orders, gives
    ``closure_plain``'s ``n_vis``, ``iters``, ``overflow``, ``done``,
    visited set and boundary set: overflowed attempts included."""
    attempts = _model_attempts(case, monkeypatch)
    assert attempts
    n_overflow = 0
    for j, (args, (log, boundary, state), found) in enumerate(attempts):
        n_vis, iters, overflow, done = closure.unpack_state(state)
        n_overflow += overflow
        want_log = sorted(log[log != probe.INF32].tolist())
        want_b = sorted(set(boundary[boundary != SENTINEL].tolist()))
        for seed in (2 * j, 2 * j + 1):
            got = _claim_model(*args, n_cta=n_cta,
                               rng=np.random.default_rng(seed), found=found)
            assert got == (n_vis, iters, overflow, done, want_log, want_b)
    if case == "narrow_overflow":
        assert n_overflow >= 1


@pytest.mark.parametrize("n_devices", [2, 4])
def test_cpu_groups_point_at_each_shards_own_lut(n_devices, monkeypatch):
    """A sharded store on ``cpu`` x D groups: every shard lies on the
    launching device, so the owner-routed ``PartTable`` copies no LUT
    (bytes 0): ``table.luts`` are the shards' own LUTs, each descriptor
    points at its shard's, and the probes through the table equal every
    shard's own probe. (The copy a peer shard's LUT gets on another card
    is held to its shard's own by ``chip_smoke.py`` on several cards.)"""
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    genome = random_genome(900, seed=21)
    store = ShardedSortedStore.create(K, 4, 1 << 9,
                                      devices=["cpu"] * n_devices)
    store.ingest_codes(_codes(genome, 600, 70, seed=22))
    table = store._spcr_index().table
    assert table.n_shards == 4 and len(table.luts) == 4
    assert table.lut_copy_bytes == 0
    for row, lut, sc in zip(table.desc, table.luts, table.sidecars):
        assert lut.device == table.device
        assert torch.equal(lut, sc.lut)
        assert int(row[2]) == lut.data_ptr()
    held = torch.cat([sc.keys1d[sc.keys1d != SENTINEL]
                      for sc in table.sidecars])
    assert torch.equal(probe.probe_rows(table, held, 1),
                       closure.lookup_plain(table, held, 1))
