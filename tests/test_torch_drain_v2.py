"""The port's drain v2 and ``stitch_rows`` against the JAX package's.

The JAX side runs its Pallas kernels (``stitch_rows``, ``run_starts``)
in interpret mode on the CPU; the port's wrappers run their plain
PyTorch versions there (``chip_smoke.py`` compares each CUDA kernel
with its plain version on the card). Inputs are seeded numpy arrays
handed to both packages; every comparison is exact.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkmer_tpu.ops import pallas_kernels
from sharkmer_tpu.ops import sorted_store as jax_ss
from sharkmer_tpu_torch.kernels import stitch
from sharkmer_tpu_torch.ops import sorted_store as ss
from sharkmer_tpu_torch.ops.keys import (
    counts_to_numpy,
    keys_to_device,
    keys_to_numpy,
)

ALL_ONES = np.uint64(0xFFFF_FFFF_FFFF_FFFF)


def _stitch_case(row_counts, width, seed):
    """[R, W] u64 rows: each row's first ``cnt`` words ascending, then
    random words (the tail that later rows overwrite), and the offsets
    as the exclusive prefix sum of the counts."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 62, size=(len(row_counts), width),
                        dtype=np.uint64)
    for r, cnt in enumerate(row_counts):
        rows[r, :cnt] = np.sort(rows[r, :cnt])
    offs = np.concatenate([[0], np.cumsum(row_counts)[:-1]]).astype(np.int32)
    return rows, offs


# counts are multiples of 1024, as the TPU kernel needs for u64 rows
STITCH_CASES = {
    "mixed": ([1024, 3072, 0, 2048], 4096),
    "full_and_empty_rows": ([2048, 0, 2048, 1024, 0], 2048),
    "one_row": ([1024], 2048),
}


@pytest.mark.parametrize("case", sorted(STITCH_CASES))
def test_stitch_rows_plain_matches_pallas(case):
    row_counts, width = STITCH_CASES[case]
    rows, offs = _stitch_case(row_counts, width, seed=len(row_counts))
    want = np.asarray(pallas_kernels.stitch_rows(
        jnp.asarray(rows), jnp.asarray(offs), ALL_ONES, interpret=True))
    before = stitch.stitch_rows.launches
    got = stitch.stitch_rows(torch.from_numpy(rows.view(np.int64)),
                             torch.from_numpy(offs), -1)
    assert got.dtype == torch.int64 and got.shape == (rows.size,)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    assert stitch.stitch_rows.launches == before  # CPU: no kernel launch


def _raw_buffer(seed, n=2 * ss.ROW_W):
    """The JAX drain-v2 test's buffer: heavy duplication, runs across
    row boundaries, one massive run and a sentinel tail."""
    rng = np.random.default_rng(seed)
    uniq = rng.integers(0, 1 << 42, size=n // 5, dtype=np.uint64)
    raw = uniq[rng.integers(0, len(uniq), size=n)]
    raw[: n // 64] = uniq[0]
    raw[-1000:] = jax_ss.EMPTY
    return raw


@pytest.mark.parametrize("seed", [7, 8])
def test_aggregate_ingest_v2_matches_jax(seed):
    raw = _raw_buffer(seed)
    cb = 64 - 2 * 21
    want_k, want_c, want_p, want_r = jax_ss._aggregate_ingest_v2_jit(
        jnp.asarray(raw), count_bits=cb, interpret=True)
    got_k, got_c, got_p, got_r = ss._aggregate_ingest_v2(
        keys_to_device(raw, "cpu"), cb)
    assert (got_p, got_r) == (int(want_p), int(want_r))
    assert got_p > got_r and got_p % ss.GHOST_Q == 0  # ghosts present
    np.testing.assert_array_equal(keys_to_numpy(got_k), np.asarray(want_k))
    np.testing.assert_array_equal(counts_to_numpy(got_c), np.asarray(want_c))
    assert stitch.stitch_rows.launches == 0


def test_aggregate_ingest_v2_packed_overflow_falls_back():
    """A run total that overflows the packed count field (a 16-bit
    field here, a run of 70000) takes the exact key/count compaction in
    both packages: no ghosts, the run counted in full."""
    raw = _raw_buffer(9)
    raw[:70000] = raw[0]
    cb = 16
    want_k, want_c, want_p, want_r = jax_ss._aggregate_ingest_v2_jit(
        jnp.asarray(raw), count_bits=cb, interpret=True)
    got_k, got_c, got_p, got_r = ss._aggregate_ingest_v2(
        keys_to_device(raw, "cpu"), cb)
    assert got_p == got_r == int(want_p) == int(want_r)
    np.testing.assert_array_equal(keys_to_numpy(got_k), np.asarray(want_k))
    np.testing.assert_array_equal(counts_to_numpy(got_c), np.asarray(want_c))
    assert int(got_c.max()) >= 70000


def test_v2_rule_is_the_jax_rule_on_the_card_only():
    cb = 26
    assert ss._drain_v2_wanted(1 << 27, cb, "cuda")
    assert ss._drain_v2_wanted(1 << 17, cb, "cuda")
    assert not ss._drain_v2_wanted(1 << 16, cb, "cuda")  # not a whole tile
    assert not ss._drain_v2_wanted(1 << 27, 18, "cuda")  # k too large
    assert not ss._drain_v2_wanted(1 << 27, cb, "cpu")


def test_store_through_v2_drains(monkeypatch):
    """A store taking v2 on the CPU (the rule patched) keeps exact
    counts through ghosted stages, merges and partition splits: the
    same table as the JAX store's, which drains with v1 on the CPU."""
    monkeypatch.setattr(
        ss, "_drain_v2_wanted",
        lambda width, count_bits, device: (width % ss.ROW_W == 0
                                           and count_bits >= 20))
    v2_drains = []
    v2 = ss._aggregate_ingest_v2
    monkeypatch.setattr(ss, "_aggregate_ingest_v2",
                        lambda *a: v2_drains.append(1) or v2(*a))
    rng = np.random.default_rng(11)
    uniq = rng.integers(0, 1 << 42, size=60000, dtype=np.uint64)
    batches = [uniq[rng.integers(0, len(uniq), size=n)]
               for n in (20000, 150000, 150000, 90000)]
    batches[2][:5000] = uniq[3]  # one run across many rows
    store = ss.SortedKmerStore(21, "cpu", max_agg=1 << 17)
    jstore = jax_ss.SortedKmerStore.create(21)
    jstore.max_agg = 1 << 17
    model = collections.Counter()
    for i, keys in enumerate(batches):
        store.insert_kmers(keys)
        jstore.insert_kmers(keys)
        model.update(keys.tolist())
        if i == 0:
            store.n_unique()  # a small ghosted first drain
            jstore.n_unique()
    assert len(v2_drains) >= 3
    assert store.to_dict() == jstore.to_dict() == dict(model)
    assert store.n_unique() == jstore.n_unique() == len(model)
    assert store.n_total() == sum(model.values())
    np.testing.assert_array_equal(store.histogram(50), jstore.histogram(50))
    assert stitch.stitch_rows.launches == 0
