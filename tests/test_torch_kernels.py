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
