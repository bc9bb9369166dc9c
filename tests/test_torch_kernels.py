"""The port's run-scan wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernel
needs the card; ``chip_smoke.py`` compares the two there). The oracle
is the Pallas kernel in interpret mode, on the same seeded keys, at one
and two of its 131072-element tiles. All comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkmer_tpu.ops import pallas_kernels
from sharkmer_tpu.ops.encoding import KMER_SENTINEL
from sharkmer_tpu_torch.kernels import run_scan
from sharkmer_tpu_torch.ops.keys import keys_to_device

TILE = 256 * pallas_kernels.LANES  # the Pallas kernel's default tile


def _sorted_keys_with_runs(n, n_distinct, seed, sentinel_tail=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 62, size=n_distinct, dtype=np.uint64)
    out = np.sort(rng.choice(keys, size=n - sentinel_tail))
    return np.concatenate(
        [out, np.full(sentinel_tail, KMER_SENTINEL, np.uint64)]
    )


def _cases():
    return {
        # ~1/3 distinct, runs crossing tile boundaries, sentinel tail
        "runs_1tile": _sorted_keys_with_runs(TILE, TILE // 3, 1, TILE // 7),
        "runs_2tiles": _sorted_keys_with_runs(2 * TILE, 2 * TILE // 3, 2,
                                              2 * TILE // 7),
        "all_equal": np.zeros(2 * TILE, np.uint64),
        "all_distinct": np.arange(TILE, dtype=np.uint64),
        # runs of 4 straddling the tile boundary exactly
        "runs_of_4": np.repeat(np.arange(TILE // 2, dtype=np.uint64), 4),
        "all_sentinel_tail": np.concatenate([
            np.arange(TILE // 2, dtype=np.uint64),
            np.full(TILE + TILE // 2, KMER_SENTINEL, np.uint64),
        ]),
    }


CASES = sorted(_cases())


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.mark.parametrize("case", CASES)
def test_run_ends_plain_matches_pallas(cases, case):
    sk = cases[case]
    want = np.asarray(pallas_kernels.run_ends(jnp.asarray(sk), interpret=True))
    before = run_scan.run_ends.launches
    got = run_scan.run_ends(keys_to_device(sk, "cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert run_scan.run_ends.launches == before  # CPU: no kernel launch


@pytest.mark.parametrize("case", CASES)
def test_run_starts_plain_matches_pallas(cases, case):
    sk = cases[case]
    want = np.asarray(
        pallas_kernels.run_starts(jnp.asarray(sk), interpret=True)
    )
    before = run_scan.run_starts.launches
    got = run_scan.run_starts(keys_to_device(sk, "cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert run_scan.run_starts.launches == before


def test_launch_counters_stay_zero_on_cpu():
    keys = keys_to_device(np.arange(1000, dtype=np.uint64) // 3, "cpu")
    run_scan.run_ends(keys)
    run_scan.run_starts(keys)
    assert run_scan.run_ends.launches == 0
    assert run_scan.run_starts.launches == 0


@pytest.mark.parametrize("n", [0, 1, 2, 1023, 1025])
def test_plain_versions_on_ragged_lengths(n):
    """Lengths the Pallas kernel does not take (it needs whole tiles):
    the plain versions against a direct numpy construction."""
    rng = np.random.default_rng(n)
    sk = np.sort(rng.integers(0, max(n // 2, 1), size=n)).astype(np.int64)
    t = torch.from_numpy(sk)
    ends = np.array([np.searchsorted(sk, v, side="right") - 1 for v in sk],
                    np.int32)
    starts = np.array([np.searchsorted(sk, v, side="left") for v in sk],
                      np.int32)
    np.testing.assert_array_equal(run_scan.run_ends(t).numpy(), ends)
    np.testing.assert_array_equal(run_scan.run_starts(t).numpy(), starts)


@pytest.mark.parametrize("case", CASES)
def test_plain_versions_are_searchsorted(cases, case):
    """The identity the CUDA kernels rest on: in sorted keys a run starts
    at the lower bound of its key and ends at the upper bound less one."""
    t = keys_to_device(cases[case], "cpu")
    np.testing.assert_array_equal(
        run_scan.run_starts_plain(t).numpy(),
        torch.searchsorted(t, t, out_int32=True).numpy())
    np.testing.assert_array_equal(
        run_scan.run_ends_plain(t).numpy(),
        (torch.searchsorted(t, t, right=True, out_int32=True) - 1).numpy())


# The one-pass kernels of csrc/run_scan.cu, modelled in numpy: a tile's
# run starts (ends) are a local scan, and the start (end) of a run that
# enters it from before (after) is the warp search ``run_edge``.
LANES = 32
KERNEL_TILE = 512 * 8  # kThreads * kPer in csrc/run_scan.cu
INT32_MAX = 0x7FFF_FFFF
INT64_MAX_KEY = (1 << 63) - 1  # the sentinel as the port stores it


class _Step:
    """Keys 0 before ``edge`` and 1 from it on, over ``n`` positions,
    without the array: the search reads only the positions it probes."""

    def __init__(self, edge, n):
        self.edge, self.n = edge, n

    def __getitem__(self, idx):
        idx = np.asarray(idx)
        assert ((0 <= idx) & (idx < self.n)).all(), "probe out of range"
        return (idx >= self.edge).astype(np.int64)


def _run_edge(keys, e, d, t_max, x):
    """``run_edge`` of csrc/run_scan.cu, a warp as 32 numpy lanes: the
    positions e + d*t, 0 <= t <= t_max, hold x up to t* and differ
    beyond. Returns (e + d*t*, rounds of 32 loads)."""
    lanes = np.arange(LANES, dtype=np.int64)
    rounds = 0

    def hits(t):
        nonlocal rounds
        rounds += 1
        hit = keys[e + d * t] == x
        h = int(np.count_nonzero(hit))
        assert hit[:h].all(), "the ballot's hits are not a prefix"
        return h

    h = hits(np.minimum(lanes + 1, t_max))
    if h < LANES:
        return e + d * h, rounds
    if t_max <= LANES:
        return e + d * t_max, rounds
    h = hits(np.minimum(32 << lanes, t_max))  # the gallop
    if h == LANES:
        return e + d * t_max, rounds
    lo_t = min(32 << max(h - 1, 0), t_max)
    hi_t = min(32 << h, t_max)
    while hi_t - lo_t > 1:
        length = hi_t - lo_t
        h = hits(lo_t + length * (lanes + 1) // 33)
        base = lo_t
        if h > 0:
            lo_t = base + length * h // 33
        if h < LANES:
            hi_t = base + length * (h + 1) // 33
    return e + d * lo_t, rounds


def _one_pass(keys, tile):
    """(run_starts, run_ends) as the kernels compute them, tile by tile:
    local scans, each tile's carry from ``_run_edge`` where its first
    (last) key's run crosses into it."""
    n = keys.shape[0]
    pos = np.arange(n, dtype=np.int64)
    first = np.ones(n, bool)
    first[1:] = keys[1:] != keys[:-1]
    last = np.ones(n, bool)
    last[:-1] = keys[:-1] != keys[1:]
    starts = np.empty(n, np.int64)
    ends = np.empty(n, np.int64)
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        carry = -1
        if lo > 0 and keys[lo - 1] == keys[lo]:
            carry = _run_edge(keys, lo - 1, -1, lo - 1, keys[lo])[0]
        local = np.maximum.accumulate(np.where(first[lo:hi], pos[lo:hi], -1))
        starts[lo:hi] = np.maximum(local, carry)
        carry = INT32_MAX
        if hi < n and keys[hi - 1] == keys[hi]:
            carry = _run_edge(keys, hi, 1, n - 1 - hi, keys[hi])[0]
        local = np.where(last[lo:hi], pos[lo:hi], INT32_MAX)
        local = np.minimum.accumulate(local[::-1])[::-1]
        ends[lo:hi] = np.minimum(local, carry)
    return starts, ends


def _model_inputs():
    tile = 64
    rng = np.random.default_rng(7)
    ends_on_boundary = np.repeat(np.arange(12), tile)  # runs of one tile
    ends_on_boundary[5 * tile - 3:] += 1  # and one that ends 3 short of it
    return {
        # (keys, tile)
        "short_runs": (np.sort(rng.integers(0, 300, size=1000)), tile),
        "one_run_spans_every_tile": (
            np.concatenate([[0], np.ones(40 * tile), [2]]), tile),
        "all_equal": (np.zeros(40 * tile, np.int64), tile),
        "runs_end_on_tile_boundaries": (ends_on_boundary, tile),
        "long_runs_and_tail": (np.concatenate([
            np.repeat(np.arange(20), rng.integers(1, 900, size=20)),
            np.full(5000, INT64_MAX_KEY)]), tile),
        "ragged_kernel_tile": (np.sort(rng.integers(
            0, 9000, size=3 * KERNEL_TILE + 5)), KERNEL_TILE),
        **{f"pallas_{name}": (keys_to_device(keys, "cpu").numpy(),
                              KERNEL_TILE)
           for name, keys in _cases().items()},
    }


MODEL_INPUTS = sorted(_model_inputs())


@pytest.mark.parametrize("case", MODEL_INPUTS)
def test_one_pass_model_is_searchsorted(case):
    keys, tile = _model_inputs()[case]
    keys = np.asarray(keys, np.int64)
    starts, ends = _one_pass(keys, tile)
    np.testing.assert_array_equal(starts, np.searchsorted(keys, keys))
    np.testing.assert_array_equal(
        ends, np.searchsorted(keys, keys, side="right") - 1)


@pytest.mark.parametrize("run", [1, 2, 31, 32, 33, 64, 1000, 33 * 32 + 1,
                                 (1 << 20) + 3, (1 << 27) - 1])
@pytest.mark.parametrize("clamped", [False, True])
def test_run_edge_finds_the_bound(run, clamped):
    """The carry search on runs of every scale: back to the lower bound
    (``run_starts``) and forward to the upper bound less one
    (``run_ends``), with the run reaching position 0 (n-1) when
    ``clamped``; at most 8 rounds of loads for a run of 2^27."""
    n = 1 << 28
    # run_starts: the run [edge, e] of key 1, keys 0 before it
    edge = 0 if clamped else n // 2 - run
    e = edge + run - 1
    got, rounds = _run_edge(_Step(edge, n), e, -1, e, 1)
    assert got == edge
    assert rounds <= 8
    # run_ends: the run [e, edge - 1] of key 0, keys 1 from edge on
    e = n - run if clamped else n // 2
    edge = e + run
    got, rounds = _run_edge(_Step(edge, n), e, 1, n - 1 - e, 0)
    assert got == edge - 1
    assert rounds <= 8
