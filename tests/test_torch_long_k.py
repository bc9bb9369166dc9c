"""The port at k past the packed count field (k = 23 .. 31) against the
JAX package.

Past k = 21 a key and its count no longer share one 64-bit word
(``packed_count_bits`` is 0): the sorted store compacts with the
key/count sort, drain v2 (``stitch_rows``) is off, and at k >= 27 the
JAX package's reach takes its unpacked XLA gather probe while the port
runs its ``reach_closure`` at every k. The same seeded inputs go through
``sharkmer_tpu`` (JAX on the CPU) and ``sharkmer_tpu_torch`` (torch on
the CPU, each kernel wrapper on its plain version). Keys and counts are
integers, so every comparison is exact.
"""

import collections

import numpy as np
import pytest
import torch

from sharkmer_tpu.ops import ascii_to_codes, codes_to_batch
from sharkmer_tpu.ops import encoding as jax_encoding
from sharkmer_tpu.ops.encoding import revcomp_kmers_np, seq_to_kmer
from sharkmer_tpu.ops.sorted_store import SortedKmerStore as JaxStore
from sharkmer_tpu.pcr.primers import string_to_oligo
from sharkmer_tpu_torch.ops import sorted_store
from sharkmer_tpu_torch.ops.sorted_store import SortedKmerStore

from test_torch_cli import _assert_same_outputs, fastq_18s  # noqa: F401
from test_torch_reach import _assert_same, _codes, _stores
from util import random_genome, reads_from_genome


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU paths run many small torch ops (the plain closure
    loop a level at a time): on one intra-op thread they take a fraction
    of the time they take on several."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the smallest drain width that the card's drain-v2 rule admits (one
# run-scan tile): the store below runs at it with that rule, so only the
# count field keeps drain v2 off
MAX_AGG = sorted_store._V2_TILE


def _noisy_batches(genome, n_reads, seed):
    """Reads of ``genome`` with 1% substitutions (many singletons), in
    uneven batches of code rows."""
    reads = reads_from_genome(genome, n_reads, 150, seed=seed)
    rng = np.random.default_rng(seed + 1)
    noisy = []
    for r in reads:
        r = list(r)
        for i in np.nonzero(rng.random(len(r)) < 0.01)[0]:
            r[i] = "ACGT"[("ACGTN".index(r[i]) + 1) % 4]
        noisy.append("".join(r))
    step = 700
    return [codes_to_batch([ascii_to_codes(r) for r in noisy[i : i + step]],
                           width=160)
            for i in range(0, len(noisy), step)]


@pytest.fixture(scope="module", params=[23, 31])
def long_k_stores(request):
    """Both stores at ``MAX_AGG`` fed the same noisy reads: a first batch
    of 12 reads (4 repeated) drained alone by a query (the ghosted first
    drain, one partition), then drains of the full buffer (compacting,
    key/count), staged merges and partition splits. The port's drains run
    under the card's drain rule; ``calls`` counts its ``stitch_rows`` and
    key/count sorts."""
    k = request.param
    genome = random_genome(60_000, seed=k, n_rate=0.001)
    batches = _noisy_batches(genome, 3600, seed=k + 100)
    calls = collections.Counter()
    patch = pytest.MonkeyPatch()
    original = {name: getattr(sorted_store, name)
                for name in ("_drain_v2_wanted", "stitch_rows", "_sort_kv")}
    patch.setattr(sorted_store, "_drain_v2_wanted",
                  lambda width, cb, _device: original["_drain_v2_wanted"](
                      width, cb, "cuda"))
    for name in ("stitch_rows", "_sort_kv"):
        def counted(*a, _name=name, **kw):
            calls[_name] += 1
            return original[_name](*a, **kw)

        patch.setattr(sorted_store, name, counted)
    jstore = JaxStore.create(k)
    jstore.max_agg = MAX_AGG
    tstore = SortedKmerStore(k, "cpu", max_agg=MAX_AGG)
    model = collections.Counter()
    # 8 reads and 4 of them again: the duplicates leave ghost rows
    first = np.concatenate([batches[0][:8], batches[0][:4]])
    batches[0] = batches[0][8:]
    try:
        for i, codes in enumerate([first, *batches]):
            jstore.ingest_codes(codes)
            tstore.ingest_codes(codes)
            for row in codes:
                n = int(np.sum(row < jax_encoding.CODE_PAD))
                seq = "".join("ACGTN"[c] for c in row[:n])
                model.update(jax_encoding.kmers_from_ascii_ref(seq, k))
            if i == 0:
                assert tstore.n_unique() == jstore.n_unique() == len(model)
                assert sum(p.n for p in tstore.parts) > len(model)  # ghosts
        tstore.n_unique()  # the last drain and fold
    finally:
        patch.undo()
    return k, genome, jstore, tstore, model, calls


def test_drain_rule_has_no_count_field_past_k21():
    """The card's drain-v2 rule takes every whole-tile width at k = 21
    and none at k >= 23, where no 20-bit count fits beside the key."""
    for width in (MAX_AGG, 1 << 24, 1 << 27):
        assert sorted_store._drain_v2_wanted(
            width, sorted_store.packed_count_bits(21), "cuda")
        for k in (23, 25, 27, 29, 31):
            assert sorted_store.packed_count_bits(k) == 0
            assert not sorted_store._drain_v2_wanted(
                width, sorted_store.packed_count_bits(k), "cuda")


def test_long_k_store_counts_match_jax(long_k_stores):
    k, _genome, jstore, tstore, model, calls = long_k_stores
    assert tstore.n_unique() == jstore.n_unique() == len(model)
    assert tstore.n_total() == jstore.n_total() == sum(model.values())
    assert tstore.max_count() == max(model.values())
    # several drains, merges and splits, all on the key/count sort
    assert sum(model.values()) > 3 * MAX_AGG
    assert len(tstore.parts) > 2
    assert calls["stitch_rows"] == 0 and calls["_sort_kv"] > 8
    for histo_max in (100, 3):
        np.testing.assert_array_equal(tstore.histogram(histo_max),
                                      jstore.histogram(histo_max))


def test_long_k_store_lookups_and_export_match_jax(long_k_stores):
    k, _genome, jstore, tstore, model, _calls = long_k_stores
    rng = np.random.default_rng(k)
    canon = np.array(list(model)[:2000], np.uint64)
    q = np.concatenate([
        canon,
        revcomp_kmers_np(canon, k),  # directional forms
        rng.integers(0, 1 << (2 * k), size=2000, dtype=np.uint64),
    ])
    np.testing.assert_array_equal(tstore.lookup_directional(q),
                                  jstore.lookup_directional(q))
    np.testing.assert_array_equal(tstore.lookup(canon),
                                  np.asarray(jstore.lookup(canon)))
    for mc in (1, 2):
        tk, tc = tstore.to_sorted_arrays(min_count=mc)
        jk, jc = jstore.to_sorted_arrays(min_count=mc)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tc, jc)
    # the largest keys sit near the top of the int64 codec at k = 31
    assert int(tk[-1]) > 1 << (2 * k - 2)


@pytest.mark.parametrize("trim", [15, 20])
def test_long_k_prefix_scans_match_jax(long_k_stores, trim):
    """Primer scans of oligos ``trim`` bases long (the shift
    ``2 * (k - trim)``), batched and one at a time, forcing retries."""
    k, genome, jstore, tstore, _model, _calls = long_k_stores
    rng = np.random.default_rng(trim)
    requests = []
    for n_oligos in (120, 12, 1):
        raws = set()
        while len(raws) < n_oligos:
            p = rng.integers(0, len(genome) - trim)
            if "N" not in genome[p : p + trim]:
                raws.add(genome[p : p + trim])
        requests.append((np.array(sorted(string_to_oligo(o)[0] for o in raws),
                                  np.uint64), trim))
    got = tstore.prefix_scan_many(requests, max_out=64)
    want = jstore.prefix_scan_many(requests, max_out=64)
    n_hits = 0
    for (gk, gc), (wk, wc) in zip(got, want, strict=True):
        assert sorted(zip(gk.tolist(), gc.tolist())) == sorted(
            zip(wk.tolist(), wc.tolist()))
        n_hits += len(gk)
    assert n_hits > 64
    oligos, olen = requests[0]
    gk, gc = tstore.prefix_scan(oligos, olen, min_count=2, max_out=64)
    wk, wc = jstore.prefix_scan(oligos, olen, min_count=2, max_out=64)
    assert sorted(zip(gk.tolist(), gc.tolist())) == sorted(
        zip(wk.tolist(), wc.tolist()))


# -- reach at k = 31 (JAX: the unpacked gather probe) and k = 25 (packed) -----


@pytest.fixture(scope="module", params=[31, 25])
def reach_stores(request):
    k = request.param
    genome = random_genome(1500, seed=k)
    return k, genome, _stores(_codes(genome, 750, 80, seed=k + 1), k)


def test_long_k_reach_complete_closure_matches_jax(reach_stores):
    k, genome, (jstore, tstore) = reach_stores
    roots = np.array([seq_to_kmer(genome[i : i + k]) for i in (200, 1100)],
                     np.uint64)
    for mc in (1, 2, 3):
        want = jstore.reach(roots, min_count=mc, depth=4096)
        got = tstore.reach(roots, min_count=mc, depth=4096)
        _assert_same(got, want)
        assert got.complete and len(got.keys) > 100


def test_long_k_reach_depth_capped_and_warm_start_match_jax(reach_stores):
    """A depth-capped closure (boundary left), then a closure from part
    of its boundary warm-started with its interior, as the sPCR prefetch
    session does."""
    k, genome, (jstore, tstore) = reach_stores
    roots = np.array([seq_to_kmer(genome[700 : 700 + k])], np.uint64)
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


# the saturating count field of JAX's packed probe at k = 25: 64 - 2k bits
PACKED_CAP = (1 << 14) - 1


@pytest.fixture(scope="module")
def deep_count_stores():
    """k = 25 with 17,500 more reads of one 80-base window: its k-mers'
    counts pass the 14-bit field of JAX's packed probe."""
    k = 25
    genome = random_genome(1500, seed=125)
    reads = (reads_from_genome(genome, 750, 80, seed=126)
             + [genome[600:680]] * 17_500)
    codes = codes_to_batch([ascii_to_codes(r) for r in reads])
    return k, genome, _stores(codes, k)


@pytest.mark.parametrize("mc", [2, PACKED_CAP - 1, PACKED_CAP, 17_000])
def test_long_k_reach_counts_past_the_packed_field_match_jax(
        deep_count_stores, mc):
    """JAX's packed probe (floors below PACKED_CAP) tests the floor
    against min(count, PACKED_CAP); from PACKED_CAP on it takes its
    unpacked probe. Either way the keys, the true counts (above the
    field) and the boundary must be the port's."""
    k, genome, (jstore, tstore) = deep_count_stores
    roots = np.array([seq_to_kmer(genome[620 : 620 + k])], np.uint64)
    want = jstore.reach(roots, min_count=mc, depth=4096)
    got = tstore.reach(roots, min_count=mc, depth=4096)
    _assert_same(got, want)
    assert got.complete and int(got.counts.max()) > PACKED_CAP
    if mc > 2:  # only the window's k-mers pass
        assert len(got.keys) == 80 - k + 1


def test_long_k_reach_multi_partition_matches_jax(monkeypatch):
    """k = 31 on a table cut into several key-range partitions."""
    monkeypatch.setenv("SHARKMER_MAX_AGG", str(1 << 9))
    k = 31
    genome = random_genome(800, seed=36)
    jstore, tstore = _stores(_codes(genome, 300, 70, seed=37), k,
                             first_reads=3)
    assert len(tstore._flushed().parts) > 2
    root = np.array([seq_to_kmer(genome[300 : 300 + k])], np.uint64)
    got = tstore.reach(root, min_count=1, depth=4096)
    _assert_same(got, jstore.reach(root, min_count=1, depth=4096))
    assert len(got.keys) > 500  # the closure crossed partitions


# -- both CLIs at -k 31 -------------------------------------------------------


@pytest.mark.parametrize("extra", [
    ["--mirror", "auto"],
    ["--mirror", "full"],
    ["--backend", "hash"],
    ["--chunks", "5"],
    ["--n-shards", "4"],
], ids=["mirror_auto", "mirror_full", "hash", "chunks5", "shards4"])
def test_cli_k31_outputs_identical(tmp_path, monkeypatch, fastq_18s, extra):
    """Both CLIs on the 18S fixture at ``-k 31``: ``.histo``,
    ``.final.histo`` and FASTA byte-identical, ``stats.yaml`` equal but
    for ``command`` and ``peak_memory_bytes``."""
    from sharkmer_tpu.main import main as jax_main
    from sharkmer_tpu_torch.main import main as torch_main

    from test_cli_e2e import PRIMER_SPEC

    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    outs = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / name
        rc = main([fastq_18s, "-s", "samp", "-k", "31", "-o", str(out),
                   "--pcr-primers", PRIMER_SPEC, *extra])
        assert rc == 0, name
        outs[name] = out
    _assert_same_outputs(outs["jax"], outs["torch"],
                         expect_histo=extra[0] == "--chunks")


@pytest.mark.parametrize("extra", [[], ["--backend", "hash"]],
                         ids=["sorted", "hash"])
def test_cli_k27_outputs_identical(tmp_path, monkeypatch, fastq_18s, extra):
    """Both CLIs on the 18S fixture at ``-k 27``, where the JAX reach
    takes its unpacked gather probe (64 - 2k < 12 from k = 27 on):
    FASTA byte-identical, ``stats.yaml`` equal but for ``command`` and
    ``peak_memory_bytes``."""
    from sharkmer_tpu.main import main as jax_main
    from sharkmer_tpu_torch.main import main as torch_main

    from test_cli_e2e import PRIMER_SPEC

    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    outs = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / name
        rc = main([fastq_18s, "-s", "samp", "-k", "27", "-o", str(out),
                   "--pcr-primers", PRIMER_SPEC, *extra])
        assert rc == 0, name
        outs[name] = out
    _assert_same_outputs(outs["jax"], outs["torch"], expect_histo=False)
