"""The port's bucket LUT and ``probe_rows`` against the JAX package's.

The same seeded tables go to ``sharkmer_tpu`` (JAX on the CPU, the
Pallas ``probe_rows`` in interpret mode on its probe plane) and
``sharkmer_tpu_torch`` (torch on the CPU, where ``probe_rows`` runs its
plain version over a one-partition table; ``chip_smoke.py`` compares the
CUDA kernel with it on the card). Every comparison is exact.
"""

import collections
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkmer_tpu.ops import pallas_kernels
from sharkmer_tpu.ops import reach as jax_reach
from sharkmer_tpu.parallel.sharded_table import _owner as jax_owner
from sharkmer_tpu_torch.kernels import probe
from sharkmer_tpu_torch.ops import reach
from sharkmer_tpu_torch.ops.keys import (SENTINEL, counts_to_device,
                                         keys_to_device)

from test_torch_reach import EMPTY, _table


def _pair(keys, counts):
    return keys_to_device(keys, "cpu"), counts_to_device(counts, "cpu")


def test_probe_rows_plain_matches_pallas():
    """k = 21, C = 128 candidates: hits, keys below the min count,
    absent keys and empty slots."""
    k, mc = 21, 5
    keys, counts = _table(3000, 4096, k, seed=1)
    rng = np.random.default_rng(2)
    real = keys[:3000]
    high = real[counts[:3000] >= mc]
    low = real[counts[:3000] < mc]
    absent = rng.integers(0, 1 << (2 * k), size=40, dtype=np.uint64)
    absent = absent[~np.isin(absent, real)]
    cand = np.concatenate([
        rng.choice(high, 40), rng.choice(low, 30), absent,
        np.full(128 - 70 - len(absent), EMPTY, np.uint64),
    ])
    rng.shuffle(cand)

    jk, jc = jnp.asarray(keys), jnp.asarray(counts)
    side = jax_reach.build_sidecar(jk, jc, k)
    assert side.probe_blocks <= 16  # the Pallas window covers it
    cj = jnp.asarray(cand)
    lut = side.lut
    b = jnp.minimum(cj >> jnp.uint64(side.shift),
                    jnp.uint64(lut.shape[0] - 2)).astype(jnp.int64)
    s, e = lut[b], lut[b + 1]
    live = (cj != jnp.uint64(EMPTY)) & (e > s)
    plane = pallas_kernels.build_probe_plane(
        jax_reach._pack_counts_kernel(jk, jc, k))
    r16 = jnp.clip((s >> 6) & ~jnp.int32(7), 0, plane.shape[0] - 16)
    want = np.asarray(pallas_kernels.probe_rows(
        plane, r16, cj.astype(jnp.uint32),
        (cj >> jnp.uint64(32)).astype(jnp.uint32)
        & jnp.uint32((1 << (2 * k - 32)) - 1),
        jnp.where(live, s, 0), jnp.where(live, e, 0), jnp.uint32(mc), k,
        interpret=True,
    ))

    tk, tc = _pair(keys, counts)
    sc = reach.build_sidecar(tk, tc, k)
    tcand = keys_to_device(cand, "cpu")
    window = probe.probe_window_plain(tk, tc, sc.lut, sc.shift, tcand, mc,
                                      sc.probe_blocks)
    np.testing.assert_array_equal(window.numpy(), want)
    # the wrapper on one partition: its row, or INF32 for a miss
    got = probe.probe_rows(probe.PartTable([sc], [0]), tcand, mc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        np.where(got.numpy() == probe.INF32, -1, got.numpy()), want)
    n_hits = int((want >= 0).sum())
    assert n_hits == 40  # only the keys at or above the min count
    assert probe.probe_rows.launches == 0  # CPU: no kernel launch


def _overfull_bucket():
    """test_reach.py's dense cluster: 200 contiguous keys in one
    cap-width bucket at k = 21, plus scattered keys."""
    base = 5 << 16
    cluster = np.arange(base, base + 200, dtype=np.uint64)
    scattered = (np.arange(40, dtype=np.uint64) + 1) << np.uint64(22)
    keys = np.full(256, EMPTY, np.uint64)
    keys[:240] = np.concatenate([cluster, scattered])
    counts = np.zeros(256, np.uint32)
    counts[:240] = 7
    return keys, counts


SIDECAR_CASES = {
    "random": lambda: _table(3000, 4096, 21, seed=3),
    "full_width": lambda: _table(1024, 1024, 19, seed=4),
    "small_k": lambda: _table(200, 256, 5, seed=5),
    "overfull_bucket": _overfull_bucket,
}


@pytest.mark.parametrize("case", sorted(SIDECAR_CASES))
def test_sidecar_matches_jax(case):
    keys, counts = SIDECAR_CASES[case]()
    k = {"small_k": 5, "full_width": 19}.get(case, 21)
    want = jax_reach.build_sidecar(jnp.asarray(keys), jnp.asarray(counts), k)
    tk, tc = _pair(keys, counts)
    got = reach.build_sidecar(tk, tc, k)
    assert (got.bits, got.shift, got.probe_blocks) == (
        want.bits, want.shift, want.probe_blocks)
    np.testing.assert_array_equal(got.lut.numpy(), np.asarray(want.lut))
    if case == "overfull_bucket":
        assert got.probe_blocks > 2
    for bits in (6, 9, 12):
        shift = 2 * k - bits
        if shift < 0:
            continue
        lut, max_occ = reach._build_lut(tk, bits, shift)
        jlut, jmax = jax_reach._build_lut_kernel(jnp.asarray(keys), bits,
                                                 shift)
        np.testing.assert_array_equal(lut.numpy(), np.asarray(jlut))
        assert max_occ == int(jmax)


# -- a numpy model of the CUDA launch (csrc/probe_rows.cu) ------------------

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "sharkmer_tpu_torch", "csrc")
MC = 5  # the count floor of the launch cases
K_LAUNCH = 21
# the Pallas call's shapes in every case: those of
# test_probe_rows_plain_matches_pallas, so that interpret mode compiles once
PLANE_ROWS = 4096
PALLAS_C = 128  # candidates a call, sentinel-padded


def _constant(source: str, name: str) -> int:
    with open(os.path.join(CSRC, source)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


def _launch_constants() -> dict:
    """The launch's shape as csrc/probe_rows.cu and probe_rows.cuh define
    it, so that the model cannot drift from the source."""
    return {"threads": _constant("probe_rows.cu", "kThreads"),
            "group": _constant("probe_rows.cu", "kGroup"),
            "smem_parts": _constant("probe_rows.cu", "kSmemParts"),
            "bucket_rows": _constant("probe_rows.cuh", "kBucketRows")}


def _mix64(x: int) -> int:
    mask = (1 << 64) - 1
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & mask
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & mask
    return x ^ (x >> 33)


def _route(parts, n_shards: int, key: int) -> int:
    """probe_rows.cuh ``route``: the owner shard, or ``route_part``'s
    binary search for the last partition whose first key is <= key."""
    if n_shards:
        return (_mix64(key & ((1 << 64) - 1)) >> 40) % n_shards
    lo, hi = 0, len(parts) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if parts[mid]["first_key"] <= key:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _lane_row(p, key: int, min_count: int, lane: int, c, stats) -> int:
    """probe_rows.cuh ``probe_lane``: lane ``lane`` of a group loads rows
    ``s + lane + G * i`` of the bucket's first kBucketRows (predicated on
    ``r < e``), then the rest of an overfull bucket in a loop; its largest
    matching row, or -1."""
    if key == SENTINEL:
        return -1
    b = min(key >> p["shift"], p["n_lut"] - 2)
    s, e = int(p["lut"][b]), int(p["lut"][b + 1])
    group = c["group"]
    best = -1
    for i in range(c["bucket_rows"] // group):
        r = s + lane + group * i
        if r < e and p["keys"][r] == key and p["counts"][r] >= min_count:
            best = r
    for r in range(s + c["bucket_rows"] + lane, e, group):
        stats["tail_rows"] += 1
        if p["keys"][r] == key and p["counts"][r] >= min_count:
            best = r
            stats["tail_hits"] += 1
    return best


def launch_model(table, cand, min_count: int):
    """``probe_rows_kernel`` block by block and group by group: each block
    of kThreads threads takes kThreads / kGroup candidates; it copies the
    descriptors (as ``PartTable.desc`` packs them) into its shared memory
    when there are at most kSmemParts of them and routes over that copy,
    else over the descriptors in global memory; each group of kGroup
    lanes probes one candidate (a group past the end probes the
    sentinel) and takes its lanes' max. Returns (global row id or INF32
    per candidate, counts of what the launch did)."""
    c = _launch_constants()
    per_block = c["threads"] // c["group"]
    desc = table.desc.numpy()
    words = desc.view(np.int32).reshape(-1, 12)
    parts = [{"keys": sc.keys1d.numpy(), "counts": sc.counts1d.numpy(),
              "lut": lut.numpy(), "first_key": int(row[3]),
              "n_lut": int(w[8]), "shift": int(w[9]), "base": int(w[10])}
             for sc, lut, row, w in zip(table.sidecars, table.luts, desc,
                                        words)]
    cand = cand.numpy()
    out = np.full(cand.shape, -2, np.int64)  # each candidate written once
    stats = collections.Counter()
    for block in range(-(-len(cand) // per_block)):
        in_smem = len(parts) <= c["smem_parts"]
        stats["smem_route" if in_smem else "global_route"] += 1
        view = [dict(p) for p in parts] if in_smem else parts
        for g in range(per_block):
            i = block * per_block + g
            key = int(cand[i]) if i < len(cand) else SENTINEL
            p = view[_route(view, table.n_shards, key)]
            best = max(_lane_row(p, key, min_count, lane, c, stats)
                       for lane in range(c["group"]))
            if i < len(cand):
                assert out[i] == -2
                out[i] = p["base"] + best if best >= 0 else probe.INF32
    assert (out != -2).all()
    return out, stats


def _pallas_rows(parts_np, part_of, cand):
    """The JAX package's Pallas ``probe_rows`` (interpret mode) on the
    partitions laid end to end in one plane: each candidate's bucket rows
    ``[s, e)`` from its partition's JAX LUT (``jax_reach.build_sidecar``),
    shifted by the partition's base; global row id or INF32."""
    k = K_LAUNCH
    keys = np.full(PLANE_ROWS, EMPTY, np.uint64)
    counts = np.zeros(PLANE_ROWS, np.uint32)
    s = np.zeros(len(cand), np.int32)
    e = np.zeros(len(cand), np.int32)
    base = 0
    for i, (pk, pc) in enumerate(parts_np):
        keys[base : base + len(pk)], counts[base : base + len(pk)] = pk, pc
        side = jax_reach.build_sidecar(jnp.asarray(pk), jnp.asarray(pc), k)
        lut = np.asarray(side.lut)
        mine = np.flatnonzero((part_of == i) & (cand != EMPTY))
        b = np.minimum(cand[mine] >> np.uint64(side.shift),
                       len(lut) - 2).astype(np.int64)
        s[mine], e[mine] = base + lut[b], base + lut[b + 1]
        base += len(pk)
    assert base <= PLANE_ROWS
    plane = pallas_kernels.build_probe_plane(jax_reach._pack_counts_kernel(
        jnp.asarray(keys), jnp.asarray(counts), k))
    n = -(-len(cand) // PALLAS_C) * PALLAS_C
    cj = np.full(n, EMPTY, np.uint64)
    cj[: len(cand)] = cand
    s, e = np.pad(s, (0, n - len(cand))), np.pad(e, (0, n - len(cand)))
    r16 = np.clip((s >> 6) & ~7, 0, plane.shape[0] - 16)
    rows = []
    for a in range(0, n, PALLAS_C):
        c = jnp.asarray(cj[a : a + PALLAS_C])
        rows.append(np.asarray(pallas_kernels.probe_rows(
            plane, jnp.asarray(r16[a : a + PALLAS_C]), c.astype(jnp.uint32),
            (c >> jnp.uint64(32)).astype(jnp.uint32)
            & jnp.uint32((1 << (2 * k - 32)) - 1),
            jnp.asarray(s[a : a + PALLAS_C]), jnp.asarray(e[a : a + PALLAS_C]),
            jnp.uint32(MC), k, interpret=True)))
    row = np.concatenate(rows)[: len(cand)]
    return np.where(row >= 0, row, probe.INF32).astype(np.int64)


def _keys(n_keys: int, seed: int):
    """``n_keys`` sorted distinct canonical keys at K_LAUNCH with counts in
    [1, 10) (about half below MC)."""
    return _table(n_keys, n_keys, K_LAUNCH, seed, max_count=10)


def _padded(keys, counts, width: int):
    pk = np.full(width, EMPTY, np.uint64)
    pc = np.zeros(width, np.uint32)
    pk[: len(keys)], pc[: len(keys)] = keys, counts
    return pk, pc


def _key_range(keys, counts, n_parts: int, width: int):
    """The keys cut into ``n_parts`` key-range partitions of ``width``
    rows (sentinel tails), as the store's: (PartTable, numpy partitions,
    first keys)."""
    parts_np, sidecars, bases, firsts = [], [], [], []
    for i in range(n_parts):
        a, b = len(keys) * i // n_parts, len(keys) * (i + 1) // n_parts
        pk, pc = _padded(keys[a:b], counts[a:b], width)
        first = 0 if i == 0 else int(keys[a])
        tk, tc = _pair(pk, pc)
        sidecars.append(reach.build_sidecar(tk, tc, K_LAUNCH, first))
        parts_np.append((pk, pc))
        bases.append(i * width)
        firsts.append(first)
    return probe.PartTable(sidecars, bases), parts_np, np.array(
        firsts, np.uint64)


def _mixed(rng, keys, counts, n: int):
    """``n`` candidates: keys at or above MC (hits), keys below it, keys
    absent from the table, and sentinels."""
    absent = rng.integers(0, 1 << (2 * K_LAUNCH), size=n, dtype=np.uint64)
    absent = absent[~np.isin(absent, keys)]
    pool = [rng.choice(keys[counts >= MC], n // 2),
            rng.choice(keys[counts < MC], n // 6), absent[: n // 6]]
    cand = np.concatenate(pool)
    cand = np.concatenate([cand, np.full(n - len(cand), EMPTY, np.uint64)])
    rng.shuffle(cand)
    return cand


def _case_key_range(rng):
    """21 key-range partitions: each partition's first key, the keys just
    below and above it, keys below partition 0's first real key and
    above the last partition's last, then a mixed batch."""
    keys, counts = _keys(21 * 150, 11)
    table, parts_np, firsts = _key_range(keys, counts, 21, 192)
    ends = [0, 1, int(keys[0]) - 1, int(keys[0]), int(keys[-1]),
            int(keys[-1]) + 1, (1 << (2 * K_LAUNCH)) - 1]
    cand = np.concatenate([firsts[1:], firsts[1:] - np.uint64(1),
                           firsts[1:] + np.uint64(1), np.array(ends, np.uint64),
                           _mixed(rng, keys, counts, 700)])
    part_of = np.searchsorted(firsts[1:], cand, side="right")
    return table, parts_np, part_of, cand


def _case_sentinels(rng):
    """21 partitions, a batch of 77 (a ragged last warp and block), most
    of it sentinels between hits."""
    keys, counts = _keys(21 * 150, 12)
    table, parts_np, firsts = _key_range(keys, counts, 21, 192)
    cand = np.full(77, EMPTY, np.uint64)
    cand[::5] = rng.choice(keys[counts >= MC], len(cand[::5]))
    part_of = np.searchsorted(firsts[1:], cand, side="right")
    return table, parts_np, part_of, cand


def _case_owner_shards(rng):
    """4 owner shards (the JAX sharded table's ``_owner``), one width,
    global row id ``shard * width + row``."""
    keys, counts = _keys(3000, 13)
    own = np.asarray(jax_owner(jnp.asarray(keys), 4))
    width = 1024
    parts_np, sidecars = [], []
    for shard in range(4):
        pk, pc = _padded(keys[own == shard], counts[own == shard], width)
        parts_np.append((pk, pc))
        sidecars.append(reach.build_sidecar(*_pair(pk, pc), K_LAUNCH))
    table = probe.PartTable(sidecars, [s * width for s in range(4)],
                            by_owner=True)
    cand = _mixed(rng, keys, counts, 900)
    return table, parts_np, np.asarray(jax_owner(jnp.asarray(cand), 4)), cand


def _case_past_cap(rng):
    """300 key-range partitions of 13 rows, past the kernel's kSmemParts
    descriptors: the route from global memory. Every first key, then a
    mixed batch."""
    keys, counts = _keys(300 * 10, 14)
    table, parts_np, firsts = _key_range(keys, counts, 300, 13)
    cand = np.concatenate([firsts[1:], _mixed(rng, keys, counts, 600)])
    part_of = np.searchsorted(firsts[1:], cand, side="right")
    return table, parts_np, part_of, cand


WIDE_CAP_BITS = 12


def _case_wide_buckets(rng, monkeypatch):
    """Buckets of 256 rows at the LUT's bits cap, lowered to
    WIDE_CAP_BITS in both packages (at K_LAUNCH the real cap, 26 bits,
    would build a 2^26-entry LUT a partition): 8 clusters of 256 keys that
    share all but their low 8 bits, cut into 3 key-range partitions;
    every cluster key with a count at or above MC is a hit, some past a
    bucket's first 32 rows."""
    for module in (reach, jax_reach):
        monkeypatch.setattr(module, "_lut_bits_cap",
                            lambda k: WIDE_CAP_BITS)
    tops = np.sort(rng.choice(1 << (2 * K_LAUNCH - 8), 8, replace=False))
    keys = ((tops.astype(np.uint64) << np.uint64(8))[:, None]
            + np.arange(256, dtype=np.uint64)[None, :]).reshape(-1)
    counts = rng.integers(1, 10, size=len(keys)).astype(np.uint32)
    table, parts_np, firsts = _key_range(keys, counts, 3, 1024)
    assert all(sc.bits == WIDE_CAP_BITS for sc in table.sidecars)
    assert max(int((sc.lut[1:] - sc.lut[:-1]).max())
               for sc in table.sidecars) == 256
    cand = np.concatenate([keys, _mixed(rng, keys, counts, 200)])
    part_of = np.searchsorted(firsts[1:], cand, side="right")
    return table, parts_np, part_of, cand


LAUNCH_CASES = {"key_range": _case_key_range, "sentinels": _case_sentinels,
                "owner_shards": _case_owner_shards, "past_cap": _case_past_cap,
                "wide_buckets": _case_wide_buckets}


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_launch_model_matches_plain_and_pallas(case, monkeypatch):
    """The model of the CUDA launch gives every candidate the same global
    row id (or INF32) as ``probe_rows_plain`` and as the JAX package's
    Pallas ``probe_rows`` in interpret mode, on both routes, through
    shared or global descriptors, and past a bucket's first 32 rows."""
    rng = np.random.default_rng(20 + sorted(LAUNCH_CASES).index(case))
    build = LAUNCH_CASES[case]
    table, parts_np, part_of, cand = (build(rng, monkeypatch)
                                      if case == "wide_buckets" else build(rng))
    tcand = keys_to_device(cand, "cpu")
    got, stats = launch_model(table, tcand, MC)
    plain = probe.probe_rows(table, tcand, MC)
    assert probe.probe_rows.launches == 0  # CPU: the plain version
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, _pallas_rows(parts_np, part_of, cand))
    hits = int((got != probe.INF32).sum())
    assert 0 < hits < len(cand)
    routed = "global_route" if case == "past_cap" else "smem_route"
    assert set(stats) - {"tail_rows", "tail_hits"} == {routed}
    if case == "wide_buckets":
        assert stats["tail_hits"] > 0
    else:
        assert stats["tail_rows"] == 0
    if case == "owner_shards":
        assert table.n_shards == 4
        live = cand != EMPTY
        assert (table.route(tcand).numpy()[live] == part_of[live]).all()


def test_launch_shape():
    """The launch as csrc/probe_rows.cu sizes it: the closure's 8-lane
    groups and descriptor cap (reach_closure.cu), a bucket's first 32 rows
    in predicated loads of 4 a lane, and the warm start's PRE_W keys in
    one wave of blocks on the H100's 132 SMs."""
    c = _launch_constants()
    assert c["group"] == _constant("reach_closure.cu", "kGroup") == 8
    assert c["smem_parts"] == _constant("reach_closure.cu", "kSmemParts")
    assert c["bucket_rows"] // c["group"] == 4
    per_block = c["threads"] // c["group"]
    assert -(-reach.PRE_W // per_block) <= 132
