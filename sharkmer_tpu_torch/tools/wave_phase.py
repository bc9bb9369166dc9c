"""Time the hash tables' lookup waves as the CLI pays for them, numpy to
numpy, and the sPCR wall of the runs that look up every wave on the
card, for the tree in the current directory, on the GPU.

Run from the root of a checkout:

    python3 <path of this file> --fastq F [--cli]

``F`` is the cnidaria FASTQ of 8M reads that ``chip_smoke.py`` makes
(``benchmarks/work/synth/cnidaria_synthetic-seed0_8000000.fastq.gz``).
The package is imported from the current directory, so two trees (two
commits) are compared in one call by running this file from each in
turns: ``(cd <tree> && python3 <path of this file> --fastq F)``. It
calls only the tables' public methods, so it times an older tree as it
is.

1. The 1M cnidaria cell with ``--backend hash --mirror device``, in
   process, every ``lookup_directional`` call's queries kept, and its
   table.
2. On that table, then on its keys and counts inserted into 4 shards in
   one group and into 4 groups on the card (``cuda:0`` x4, read through
   the pointer table): ``lookup_directional``, numpy to numpy, the
   host-clock median of 200 calls (20 past 4096 queries) at the run's
   median and largest wave, 4096 and 2^20 queries (half keys of the
   table, every other one reverse-complemented, half random); then the
   run's own waves replayed in order from one thread, and the same waves
   dealt over 7 threads started together (each after one untimed wave):
   waves a second.
3. With ``--cli``: the sPCR wall (the CLI's ``stage walls:`` line) of
   the 1M cell with ``--backend hash --mirror device``, again with
   ``--n-shards 4``, again on ``SHARKMER_TORCH_DEVICES=cuda:0`` x4, and
   of ``-k 31 --backend hash`` at 8M reads (its table is past
   ``pcr/counts.py``'s MIRROR_MAX_UNIQUE keys: a lookup on the card a
   wave). The 1M runs' FASTA must equal the committed cell's; the k=31
   run's FASTA digest is printed, to compare across trees.

Outputs go to ``build/wave_phase/<label>/``. The last line is ``RESULT
<tree> <card> <JSON>``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import statistics
import subprocess
import sys
import threading
import time

M = 1_000_000
THREADS = 7  # the gene threads of -t 8
SIZES = (4096, 1 << 20)  # besides the run's median and largest wave
DEVICES_ENV = "SHARKMER_TORCH_DEVICES"
GROUPS = ",".join(["cuda:0"] * 4)
CELL = os.path.join("benchmarks", "work", "cnidaria", "synthetic-seed0",
                    "1000000")


class _Walls(logging.Handler):
    """Keeps the CLI's ``stage walls:`` lines."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        msg = record.getMessage()
        if "stage walls:" in msg:
            self.lines.append(msg.strip())


def run_cli(walls: _Walls, label: str, fastq: str, n_reads: int, k: int,
            extra=()) -> float:
    """One in-process CLI run of the cnidaria panel; its sPCR wall (s)."""
    from sharkmer_tpu_torch.main import main

    out = out_dir(label)
    argv = ["-s", f"synthetic-seed0_{n_reads}", "-k", str(k), "-t", "8",
            "-o", out, "--pcr-panel-file",
            os.path.join("sharkmer_tpu_torch", "panels", "cnidaria.yaml"),
            *extra, "-m", str(n_reads), fastq]
    n_lines = len(walls.lines)
    if main(argv) != 0:
        raise SystemExit(f"wave_phase: the {label} run failed")
    line = walls.lines[n_lines]
    wall = float(line.split("sPCR ")[1].split(" s")[0])
    print(f"{label}: {line}", flush=True)
    return wall


def digest(found: dict) -> str:
    """One sha256 of a run's FASTA files, to compare runs across trees."""
    h = hashlib.sha256()
    for name, data in found.items():
        h.update(name.encode() + b"\0" + data)
    return h.hexdigest()


def fasta(out: str) -> dict:
    """The FASTA files of the directory ``out``, by name."""
    found = {}
    for name in sorted(os.listdir(out)):
        if name.endswith(".fasta"):
            with open(os.path.join(out, name), "rb") as f:
                found[name] = f.read()
    return found


def out_dir(label: str) -> str:
    return os.path.join("build", "wave_phase", label)


def same_fasta(label: str, want: dict) -> None:
    got = fasta(out_dir(label))
    if not got or got != want:
        raise SystemExit(f"wave_phase: {label}'s FASTA differ")


def wave_of(np, rng, keys, k: int, n: int):
    """``n`` directional queries: half keys of the table, every other one
    reverse-complemented, half random keys."""
    from sharkmer_tpu_torch.ops.encoding import revcomp_kmers_np

    pick = rng.choice(keys, n // 2)
    pick[::2] = revcomp_kmers_np(pick[::2], k)
    absent = rng.integers(0, 1 << (2 * k), n - n // 2, dtype=np.uint64)
    return np.concatenate([pick, absent]).astype(np.uint64)


def median_ms(fn, reps: int) -> float:
    fn()
    walls = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - start) * 1e3)
    return statistics.median(walls)


def replay(table, waves, n_threads: int) -> float:
    """Waves a second: ``waves`` dealt over ``n_threads`` threads
    started together (after one untimed wave each), each issuing its
    share in order."""
    barrier = threading.Barrier(n_threads + 1)

    def issue(t: int) -> None:
        table.lookup_directional(waves[t])  # untimed: the thread's first
        barrier.wait()
        for q in waves[t::n_threads]:
            table.lookup_directional(q)

    threads = [threading.Thread(target=issue, args=(t,))
               for t in range(n_threads)]
    for thread in threads:
        thread.start()
    barrier.wait()
    start = time.perf_counter()
    for thread in threads:
        thread.join()
    return len(waves) / (time.perf_counter() - start)


def time_table(np, table, keys, waves, label: str, card: str) -> dict:
    rng = np.random.default_rng(5)
    lengths = sorted(len(q) for q in waves)
    sizes = (lengths[len(lengths) // 2], lengths[-1], *SIZES)
    rec = {}
    for n in sizes:
        q = wave_of(np, rng, keys, table.k, n)
        ms = median_ms(lambda: table.lookup_directional(q),
                       200 if n <= 4096 else 20)
        rec[str(n)] = ms
        print(f"{label}: {n}-query wave numpy to numpy {ms:.4f} ms on "
              f"{card}", flush=True)
    for n_threads in (1, THREADS):
        rate = replay(table, waves, n_threads)
        rec[f"replay_{n_threads}_threads_waves_per_s"] = rate
        print(f"{label}: the run's {len(waves)} waves replayed from "
              f"{n_threads} thread(s): {rate:.0f} waves/s on {card}",
              flush=True)
    return rec


def main() -> int:
    sys.path.insert(0, os.getcwd())
    parser = argparse.ArgumentParser(prog="wave_phase")
    parser.add_argument("--fastq", required=True)
    parser.add_argument("--cli", action="store_true")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("wave_phase: torch sees no CUDA device")
    from sharkmer_tpu_torch.device import device_list
    from sharkmer_tpu_torch.ops.hashtable import KmerTable
    from sharkmer_tpu_torch.parallel.sharded_table import ShardedKmerTable

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fastq = os.path.abspath(args.fastq)
    os.environ["SHARKMER_TORCH_DEVICE"] = "cuda"
    walls = _Walls()
    logging.getLogger().addHandler(walls)
    cell = fasta(CELL)
    record = {}

    seen = {"waves": [], "table": None}
    original = KmerTable.lookup_directional

    def kept(self, queries):
        seen["waves"].append(np.array(queries, dtype=np.uint64).reshape(-1))
        seen["table"] = self
        return original(self, queries)

    KmerTable.lookup_directional = kept
    try:
        record["spcr_s_recorded"] = run_cli(
            walls, "hash_device", fastq, M, 19,
            ("--backend", "hash", "--mirror", "device"))
    finally:
        KmerTable.lookup_directional = original
    same_fasta("hash_device", cell)
    table, waves = seen["table"], [q for q in seen["waves"] if len(q)]
    seen.clear()
    keys, counts = table.to_sorted_arrays()
    print(f"the 1M --mirror device run: {len(waves)} waves, table of "
          f"{table.capacity} slots holding {len(keys)} keys", flush=True)
    record["one table"] = time_table(np, table, keys, waves, "one table",
                                     card)
    cap = table.capacity // 4
    del table
    for label, devices in (("4 shards", ["cuda"]),
                           ("4 groups", GROUPS.split(","))):
        sharded = ShardedKmerTable.create(19, 4, cap, device_list(devices))
        sharded.insert_kmers(keys, counts)
        record[label] = time_table(np, sharded, keys, waves, label, card)
        del sharded
        torch.cuda.empty_cache()

    if args.cli:
        device = ("--backend", "hash", "--mirror", "device")
        record["spcr_s"] = {"hash_device": run_cli(
            walls, "hash_device", fastq, M, 19, device)}
        same_fasta("hash_device", cell)
        record["spcr_s"]["shards_hash_device"] = run_cli(
            walls, "shards_hash_device", fastq, M, 19,
            ("--n-shards", "4", *device))
        same_fasta("shards_hash_device", cell)
        os.environ[DEVICES_ENV] = GROUPS
        try:
            record["spcr_s"]["groups_hash_device"] = run_cli(
                walls, "groups_hash_device", fastq, M, 19,
                ("--n-shards", "4", *device))
        finally:
            del os.environ[DEVICES_ENV]
        same_fasta("groups_hash_device", cell)
        record["spcr_s"]["k31_hash_8M"] = run_cli(
            walls, "k31_hash_8M", fastq, 8 * M, 31, ("--backend", "hash"))
        found = fasta(out_dir("k31_hash_8M"))
        if not found:
            raise SystemExit("wave_phase: the k=31 run wrote no FASTA")
        record["k31_hash_8M_fasta_sha256"] = digest(found)
    print("RESULT", os.getcwd(), card, json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
