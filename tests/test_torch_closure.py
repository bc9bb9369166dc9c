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

from sharkmer_tpu.ops.encoding import seq_to_kmer
from sharkmer_tpu.ops.sorted_store import SortedKmerStore as JaxStore
from sharkmer_tpu_torch.kernels import closure, probe
from sharkmer_tpu_torch.ops import reach
from sharkmer_tpu_torch.ops.keys import SENTINEL, keys_to_device
from sharkmer_tpu_torch.ops.sorted_store import SortedKmerStore

from test_torch_reach import _assert_same, _codes, _stores, _table
from util import random_genome

K = 11


def _genome_stores(first_reads=0, n_bases=1500, n_reads=750, read_len=80,
                   seeds=(4, 1)):
    genome = random_genome(n_bases, seed=seeds[0])
    codes = _codes(genome, n_reads, read_len, seed=seeds[1])
    return genome, _stores(codes, K, first_reads=first_reads)


def _case_complete(monkeypatch):
    genome, (jstore, tstore) = _genome_stores()
    roots = np.array([seq_to_kmer(genome[i : i + K]) for i in (200, 1100)],
                     np.uint64)
    return jstore, tstore, [dict(roots=roots, min_count=2, depth=4096)]


def _case_depth_capped_pre(monkeypatch):
    """A depth-capped call, then a re-prefetch from its boundary warm-
    started with its interior, as PrefetchSession does."""
    genome, (jstore, tstore) = _genome_stores()
    roots = np.array([seq_to_kmer(genome[700 : 700 + K])], np.uint64)
    first = tstore.reach(roots, min_count=1, depth=24)
    roots2 = first.boundary[:8]
    pre = np.setdiff1d(first.keys, np.concatenate([first.boundary, roots2]))
    return jstore, tstore, [dict(roots=roots, min_count=1, depth=24),
                            dict(roots=roots2, min_count=1, depth=24, pre=pre)]


def _case_multi_partition(monkeypatch):
    monkeypatch.setenv("SHARKMER_MAX_AGG", str(1 << 10))  # tiny partitions
    genome, (jstore, tstore) = _genome_stores(
        first_reads=3, n_bases=800, n_reads=300, read_len=70, seeds=(6, 7))
    assert len(tstore._flushed().parts) > 2
    root = np.array([seq_to_kmer(genome[300 : 300 + K])], np.uint64)
    return jstore, tstore, [dict(roots=root, min_count=1, depth=4096),
                            dict(roots=root, min_count=1, depth=40)]


def _case_spill(monkeypatch):
    """More visited rows than the OUT_W prefix: each key its own root."""
    k, n = 21, reach.OUT_W + 4000
    keys, counts = _table(n, 1 << 15, k, seed=7, max_count=50)
    jstore = JaxStore.create(k)
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
    ``PartDesc`` reads it: three pointers, the first key, then int32
    n_lut, shift and base."""
    store, _k = _multi_partition_store(monkeypatch)
    index = store._spcr_index()
    table = index.table
    desc = table.desc
    assert desc.shape == (len(table.sidecars), 6) and desc.dtype == torch.int64
    words = desc.view(torch.int32).reshape(-1, 12)
    for row, half, sc, base in zip(desc, words, table.sidecars, table.bases):
        assert row[:3].tolist() == [sc.keys1d.data_ptr(),
                                    sc.counts1d.data_ptr(), sc.lut.data_ptr()]
        assert int(row[3]) == sc.first_key
        assert half[8:11].tolist() == [sc.lut.shape[0], sc.shift, base]
    assert table.first_keys.tolist() == [p.first_key for p in store.parts]
    assert table.first_keys[0] == 0
    assert (table.first_keys[1:] > table.first_keys[:-1]).all()
