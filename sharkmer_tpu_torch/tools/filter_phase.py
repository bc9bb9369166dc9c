"""Time Pass 2's read filter (``pcr/read_filter.py``) on the host, with
its k-mer windows built by doubling (``read_filter._windows``, the one
the CLI runs) and by a plain roll of k shifts (``roll_windows``), in
turns on the same reads.

Run from the root of a checkout:

    python3 -m sharkmer_tpu_torch.tools.filter_phase [--reads N] [--k K ...]

The reads are N 150-base windows of a random 200 kb genome (seed 0),
the primer k-mers 40 random words and a k-mer of each of the first two
reads. Each method filters them ``--turns`` times in alternation
(doubling, roll, doubling, roll, ...); the two must keep the same
reads. One line a k: ``k K doubling [s ...] roll
[s ...]`` (host-clock seconds of each ``filter_reads`` call).
"""

from __future__ import annotations

import argparse
import time
import types

import numpy as np

from ..ops.encoding import kmers_from_ascii_ref
from ..pcr import read_filter
from ..pcr.read_filter import PrimerReadFilter


def roll_windows(base: np.ndarray, k: int, reverse: bool = False):
    """``read_filter._windows`` by k shifts of the whole slab."""
    n_win = base.shape[1] - k + 1
    out = np.zeros((base.shape[0], n_win), np.uint64)
    for i in range(k):
        part = base[:, i : i + n_win]
        if reverse:
            out |= part << np.uint64(2 * i)
        else:
            out <<= np.uint64(2)
            out |= part
    return out


def reads(n: int) -> list:
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), 200_000))
    return [types.SimpleNamespace(sequence=genome[p : p + 150])
            for p in rng.integers(0, len(genome) - 150, n)]


def time_methods(records: list, k: int, turns: int) -> dict:
    """{method: [seconds of each filter_reads call]}; the reads each
    keeps must agree."""
    rng = np.random.default_rng(k)
    primers = {int(x) for x in rng.integers(0, 1 << (2 * k), 40)}
    # and a k-mer of the first two reads, which must then be kept
    primers |= {kmers_from_ascii_ref(r.sequence, k)[0] for r in records[:2]}
    doubling = read_filter._windows
    times, kept = {"doubling": [], "roll": []}, {}
    try:
        for _ in range(turns):
            for name, fn in (("doubling", doubling), ("roll", roll_windows)):
                read_filter._windows = fn
                start = time.perf_counter()
                got = PrimerReadFilter(primers, k).filter_reads(records)
                times[name].append(time.perf_counter() - start)
                kept.setdefault(name, [id(r) for r in got])
                assert kept[name] == [id(r) for r in got]
    finally:
        read_filter._windows = doubling
    assert kept["doubling"] == kept["roll"] and len(kept["roll"]) >= 2
    return times


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=250_000)
    ap.add_argument("--k", type=int, nargs="+", default=[19, 31])
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    records = reads(args.reads)
    for k in args.k:
        times = time_methods(records, k, args.turns)
        print(f"k {k} " + " ".join(
            f"{name} {' '.join(f'{t:.3f}' for t in ts)}"
            for name, ts in times.items()), flush=True)


if __name__ == "__main__":
    main()
