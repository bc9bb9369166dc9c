"""The hash tables' lookup wave (``kernels.hash.LookupWaves``: numpy
queries in, numpy counts out, one call a wave) against the JAX
package's ``lookup_directional``.

On the CPU a wave runs ``lookup_plain`` on the key codec's int64 keys;
on the card the same wave is one ``shk_hash_lookup_wave`` call
(``chip_smoke.py`` phases 8 and 18 hold it to ``lookup_plain`` there).
Tables are built from one numpy seed in both packages: one
``KmerTable``, a ``ShardedKmerTable`` of 4 shards in one group, and the
same 4 shards in two groups (``cpu,cpu``, the pointer-table path), at
k = 19 and k = 31. Waves of 0, 1, 5, 64 and 4097 queries mix keys of the
table in either orientation, absent keys and both sentinels
(``KMER_SENTINEL``, all ones, and the port's ``SENTINEL``, INT64_MAX).
Counts are integers: every comparison is exact.

JAX answers an INT64_MAX query with the count of the k-mer it
canonicalizes to (its reverse complement over k bases is poly-A, key
0); the port answers 0, since INT64_MAX is the device form of
``KMER_SENTINEL`` and never a k-mer. The random tables here hold no
poly-A, so the two agree; ``test_int64_max_answers_zero`` pins the
difference on a table that does.
"""

import threading

import numpy as np
import pytest
import torch

from sharkmer_tpu.ops import KmerTable as JaxTable
from sharkmer_tpu.parallel import make_mesh
from sharkmer_tpu.parallel.sharded_table import ShardedKmerTable as JaxSharded
from sharkmer_tpu_torch.kernels import hash as hk
from sharkmer_tpu_torch.ops.encoding import revcomp_kmers_np
from sharkmer_tpu_torch.ops.hashtable import KmerTable
from sharkmer_tpu_torch.parallel.sharded_table import ShardedKmerTable

EMPTY = np.uint64(0xFFFF_FFFF_FFFF_FFFF)  # KMER_SENTINEL
INT64_MAX = np.uint64((1 << 63) - 1)  # the port's SENTINEL
WAVES = (0, 1, 5, 64, 4097)
LAYOUTS = ("one table", "4 shards", "2 groups")
N_THREADS = 7  # the gene threads of a cnidaria run: one a gene


@pytest.fixture(autouse=True)
def _torch_on_cpu(monkeypatch):
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")


def _tables(k: int, layout: str, seed: int = 17):
    """(port table, JAX table, canonical keys, raw keys) holding 3000
    random keys with counts 1-59, from one numpy seed."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << (2 * k), size=3000, dtype=np.uint64)
    canon = np.minimum(raw, revcomp_kmers_np(raw, k))
    counts = rng.integers(1, 60, size=raw.size).astype(np.uint32)
    if layout == "one table":
        port = KmerTable.create(k, 1 << 10, "cpu")
        jax_table = JaxTable.create(k, 1 << 10)
    else:
        devices = ["cpu"] if layout == "4 shards" else ["cpu", "cpu"]
        port = ShardedKmerTable.create(k, 4, 1 << 8, devices)
        jax_table = JaxSharded.create(k, make_mesh(4), local_capacity=1 << 8)
    port = port.insert_kmers(canon, counts)
    jax_table = jax_table.insert_kmers(canon, counts)
    assert 0 not in canon.tolist()  # no poly-A: see the module docstring
    return port, jax_table, canon, raw


def _waves(rng, k: int, canon, raw, n: int) -> list[np.ndarray]:
    """Waves of ``n`` queries: the table's keys as stored and as
    reverse complements, absent keys, one of each sentinel; below 4
    queries, one wave of each kind."""
    present = np.concatenate([canon, revcomp_kmers_np(raw, k)])
    absent = rng.integers(0, 1 << (2 * k), size=max(n, 1), dtype=np.uint64)
    if n < 4:
        kinds = [present[:1], absent[:1], np.array([EMPTY]),
                 np.array([INT64_MAX])]
        return [np.tile(kind, n)[:n] for kind in kinds]
    wave = np.where(rng.random(n) < 0.5, rng.choice(present, n), absent)
    wave[rng.choice(n, 2, replace=False)] = [EMPTY, INT64_MAX]
    return [wave.astype(np.uint64)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("k", [19, 31])
def test_wave_equals_jax(k, layout):
    """Every wave equals the JAX table's ``lookup_directional`` (on one
    table, ``lookup`` also equals the JAX ``lookup``); it is uint32, as
    long as its queries, and launches nothing on the CPU."""
    port, jax_table, canon, raw = _tables(k, layout)
    rng = np.random.default_rng(k)
    launches = hk.hash_lookup.launches
    found = 0
    for n in WAVES:
        for wave in _waves(rng, k, canon, raw, n):
            got = port.lookup_directional(wave)
            assert got.dtype == np.uint32 and got.shape == (n,)
            np.testing.assert_array_equal(got,
                                          jax_table.lookup_directional(wave))
            sentinel = (wave == EMPTY) | (wave == INT64_MAX)
            assert not got[sentinel].any()
            found += int((got != 0).sum())
            if layout == "one table":
                np.testing.assert_array_equal(
                    port.lookup(wave), np.asarray(jax_table.lookup(wave)))
    assert found > 2000  # about half of the 4097-query wave
    assert hk.hash_lookup.launches == launches


@pytest.mark.parametrize("layout", LAYOUTS)
def test_seven_threads_answer_as_one(layout):
    """Waves issued from 7 threads at once, as the gene threads issue
    them, each answer what the same wave answers from one thread."""
    k = 19
    port, _jax_table, canon, raw = _tables(k, layout, seed=5)
    rng = np.random.default_rng(5)
    waves = [wave for n in rng.integers(1, 300, size=12)
             for wave in _waves(rng, k, canon, raw, int(n))]
    want = [port.lookup_directional(wave) for wave in waves]
    failures = []
    start = threading.Barrier(N_THREADS)

    def issue(offset: int) -> None:
        start.wait()
        for i in range(len(waves)):
            j = (i + offset) % len(waves)
            if not np.array_equal(port.lookup_directional(waves[j]),
                                  want[j]):
                failures.append((offset, j))

    threads = [threading.Thread(target=issue, args=(t,))
               for t in range(N_THREADS)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert not failures


def test_int64_max_answers_zero():
    """On a table that holds poly-A (key 0), JAX answers an INT64_MAX
    directional query with poly-A's count (it canonicalizes INT64_MAX to
    0); the port answers 0, as to ``KMER_SENTINEL``. Every other query
    agrees."""
    k = 19
    keys = np.array([0, 5, 1 << 30], np.uint64)
    counts = np.array([7, 3, 2], np.uint32)
    port = KmerTable.create(k, 1 << 8, "cpu").insert_kmers(keys, counts)
    jax_table = JaxTable.create(k, 1 << 8).insert_kmers(keys, counts)
    wave = np.array([INT64_MAX, EMPTY, 0, 5, 1 << 30, 9], np.uint64)
    want = np.array(jax_table.lookup_directional(wave))
    assert want[0] == 7
    want[0] = 0
    np.testing.assert_array_equal(port.lookup_directional(wave), want)


def test_waves_follow_a_grow():
    """A table's wave path is made again when a grow replaces its slots:
    waves before and after the grow equal the JAX table's; a tensor of
    queries is taken as its int64 bit patterns."""
    k = 19
    for layout in ("one table", "2 groups"):
        port, jax_table, canon, raw = _tables(k, layout, seed=3)
        wave = np.concatenate([canon[:50], raw[:50]])
        first = port.lookup_directional(wave)
        np.testing.assert_array_equal(first,
                                      jax_table.lookup_directional(wave))
        more = np.random.default_rng(4).integers(0, 1 << (2 * k), size=5000,
                                                 dtype=np.uint64)
        more = np.minimum(more, revcomp_kmers_np(more, k))
        port = port.insert_kmers(more)
        jax_table = jax_table.insert_kmers(more)
        wave = np.concatenate([wave, more[:100]])
        got = port.lookup_directional(wave)
        np.testing.assert_array_equal(got, jax_table.lookup_directional(wave))
        as_tensor = torch.from_numpy(wave.view(np.int64))
        np.testing.assert_array_equal(port.lookup_directional(as_tensor), got)


def test_wave_checks():
    """k out of range raises; a table on a device that is neither the CPU
    nor a card has no wave path."""
    port, _jax_table, canon, _raw = _tables(19, "one table", seed=2)
    waves = hk.LookupWaves(port.slots, "cpu", port.fence)
    with pytest.raises(ValueError, match="out of range"):
        waves(canon[:3], 32)
    meta = hk.new_slots((1 << 4,), "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hk.LookupWaves(meta, "meta", hk.WriteFence(["meta"]))
