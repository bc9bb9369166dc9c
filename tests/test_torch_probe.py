"""The port's bucket LUT and ``probe_rows`` against the JAX package's.

The same seeded tables go to ``sharkmer_tpu`` (JAX on the CPU, the
Pallas ``probe_rows`` in interpret mode on its probe plane) and
``sharkmer_tpu_torch`` (torch on the CPU, where ``probe_rows`` runs its
plain version over a one-partition table; ``chip_smoke.py`` compares the
CUDA kernel with it on the card). Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkmer_tpu.ops import pallas_kernels
from sharkmer_tpu.ops import reach as jax_reach
from sharkmer_tpu_torch.kernels import probe
from sharkmer_tpu_torch.ops import reach
from sharkmer_tpu_torch.ops.keys import counts_to_device, keys_to_device

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
