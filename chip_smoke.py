#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sharkmer_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --closure-times`` runs only phase 3's and 13's
closure and probe calls, the kernels alone (no plain version, no
comparison), and ends with a line ``RESULT <JSON>`` of their median
times: run it from two trees in turns to compare their kernels in one
call.

Phases, each printed on its own lines; every check raises on failure:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   the 8M-read synthetic FASTQ of each panel of the offline grid
   (``benchmarks/benchmark_offline.yaml``: cnidaria, hydrozoa and
   metazoa, seeds 0, 1 and 2) starts generating in a child process of
   its own (``tools/synth.py``); cnidaria's is ready by phase 4, whose
   runs read its first N reads (``-m``: ``synth.py`` writes 250k-read
   slabs, so they are the reads of the JAX package's cells), the other
   two by phase 19;
2. build every CUDA source in ``sharkmer_tpu_torch/csrc`` (one nvcc
   each, all at once, sm_90a);
3. the card's dependent-load latency through L2 and from DRAM
   (``csrc/chase.cu``, a pointer chase), for the latency bounds; each
   kernel against its plain PyTorch version on the card, at the main
   path's shapes: ``run_ends``/``run_starts`` on 2^27 sorted int64 keys
   (the drain width), also held to ``torch.searchsorted`` and timed
   beside it, then on 2^27 equal keys, on 2^24 sorted keys (the 2^24
   cell's drain width) and at ragged lengths around their tile, one at
   a key pointer offset by one element; ``stitch_rows`` on [2048, 65536]
   rows (the 2^27 drain v2): exact equality, and median CUDA-event
   times; then
   ``reach_closure`` against the plain closure loop on a 2^26-row table
   that holds every 19-mer of a random genome plus filler keys, as one
   partition and cut into 21 key-range partitions (``closure_cases``): a
   narrow and a wide call from roots on the genome at depth 2048 and
   f_cap 256, the first retry's shape (f_cap 1024, f_narrow 64) from 24
   of the wide roots, the 48 wide roots at that shape (they overflow its
   narrow width: the overflowed state is held to plain's too), the 48
   at the third retry's shape (f_cap 16384, f_narrow 1024: the kernel's
   frontiers in global scratch), and a warm-started call whose ``pre``
   rows come from ``probe_rows`` (held to its plain version at the warm
   start's 4096 keys); then a table whose buckets hold 256 rows at the
   LUT's bits cap (``wide_bucket_table``): a closure from 2 roots, and
   ``probe_rows`` on 4096 of its keys (hits past a bucket's first 32
   rows among them): equal ``n_vis``, ``iters``, ``overflow``, ``done``,
   sorted log and boundary set, equal probe ids, and median ms per call;
   every table's LUTs, as the descriptors point to them, equal to its
   partitions' own;
4. the main path: the port's CLI (``sharkmer_tpu_torch.main.main``,
   which is what ``python -m sharkmer_tpu_torch`` runs) in this process
   on the first 1M reads, ``--mirror auto`` (the device reach closure;
   ``-vv``, so each closure call's roots, iters, n_vis, f_cap and wall
   are printed from ``_drive_closure``'s debug line),
   requiring the 7 FASTA files byte-identical and ``stats.yaml`` equal
   (but for ``command`` and ``peak_memory_bytes``) to the committed
   outputs of the JAX package in
   ``benchmarks/work/cnidaria/synthetic-seed0/1000000``;
5. the same run with ``SHARKMER_MAX_AGG=2^24``: many drains (drain v2),
   staged merges, partition routing, reach over several partitions;
6. the default run with ``--mirror full`` (sPCR on the host mirror),
   its sPCR wall beside phase 4's;
7. the 4M-read cell at the default budget against
   ``benchmarks/work/cnidaria/synthetic-seed0/4000000``: a ghosted
   first drain, then drain v2 at the full 2^27 width;
8. the hash backend's kernels against their plain versions on one real
   ingest batch (the port's canonical k-mers of the FASTQ's first 2^17
   reads), on the 16 B slot layout: ``hash_insert`` into a fresh
   2^27-slot table, again into the same table (all hits), the rehash of
   a 2^26-slot table into 2^27 slots, and the batch routed by owner into
   4 shards of 2^25 slots in one launch, each table's sorted rows (shard
   by shard) equal to the plain version's (the slot layouts may differ:
   claims race) and its claim counters equal to its occupied slots;
   ``hash_lookup`` on a 4096-query wave and on 2^20 queries, half of
   them random keys, on the one table and on the 4 shards, exact; the
   wave also timed as the kernel alone (a CUDA graph of back-to-back
   launches); byte bounds on the slot layout beside the two-array
   layout's on the same slots;
9. the 1M cell with ``--backend hash`` (``--mirror auto`` resolves to the
   host mirror: the hash table has no reach closure) and ``--save-table
   build/chip_smoke/hash_1M.npz``, held to the same oracle as phase 4;
10. the 1M cell with ``--backend hash --mirror device`` (directional
    lookups on ``hash_lookup``);
11. ``--load-table`` of phase 9's checkpoint with no FASTQ: into the
    sorted backend (which then runs sPCR on the reach closure) and into
    the hash backend, each held to the 1M oracle;
12. the 4M cell with ``--backend hash`` (the table grows to 2^28 slots);
13. phase 3's closure checks on the same table split by owner into 4
    shards of one power-of-two width (``shard_table``, the layout of
    ``ShardedSortedStore``): ``reach_closure`` and ``probe_rows`` route
    each candidate to its owner shard, held to their plain versions;
14. the 1M cell with ``--n-shards 4`` (``ShardedSortedStore``, its reach
    closure owner-routed);
15. the 1M cell with ``--n-shards 4 --backend hash`` (``ShardedKmerTable``),
    on the host mirror and with ``--mirror device`` (routed lookups);
16. ``--load-table`` of phase 9's checkpoint with ``--n-shards 4``: into a
    ``ShardedKmerTable``, as in the JAX package;
17. the chunked spectra: ``--chunks 10`` on the first 250k reads, sorted
    and hash, at 1 and 4 shards, against the JAX package's ``.histo``,
    ``.final.histo``, FASTA and ``stats.yaml`` in ``oracles/``.
    Phases 14-17 leave ``SHARKMER_TORCH_DEVICES`` unset: on one card the
    4 shards are one group, on several a group a card on the first
    ``min(4, cards)`` cards;
18. the shards placed on a device list, ``SHARKMER_TORCH_DEVICES=cuda:0,
    cuda:0,cuda:0,cuda:0``: four shard groups in separate allocations on
    the one card, the code path of four cards (``groups_phase``): phase
    8's batch as four windowed ``hash_insert`` launches, exact against
    the windowed plain version and the one-launch table, each timed; the
    pointer-table ``hash_lookup`` (a 4096-query wave and 2^20 queries);
    phase 13's closures over shards placed on the list (on several
    cards, the peer shards' LUTs copied to the launching card and held
    equal to their own); then the 1M cell
    with ``--n-shards 4`` on the sorted backend, on the hash backend with
    ``--mirror device``, and ``--load-table`` of phase 9's checkpoint.
    Where two or more cards are visible, the same again on distinct
    cards (``cuda:0,cuda:1,...``), after the dependent-load latency into
    a peer's DRAM; otherwise one line says that part did not run;
19. the offline grid: the 7 cells of ``benchmarks/work/`` that phases
    4-18 do not run (cnidaria at 8M reads; hydrozoa and metazoa at 1M,
    4M and 8M) on the default main path (``--backend sorted``,
    ``--mirror auto``, ``-vv``), then ``--backend hash`` on cnidaria 8M
    (the table past 2^28 slots) and on hydrozoa and metazoa 1M, each
    held to its committed cell; each run prints its closure calls (the
    attempts past the first are overflow retries) and its batched primer
    scans (``panel_scan`` calls past ``max_out`` 2^14 are retries);
20. the tools: ``python -m sharkmer_tpu_torch.tools.run_grid --panel
    metazoa --max-reads 1000000`` as a subprocess, its cell in
    ``build/grid/work/`` held to the committed one, with a result YAML
    and a markdown report new in ``build/grid/results/``; then ``python
    -m sharkmer_tpu_torch.tools.bench --quick``, whose JSON line must
    report every gene of the panel recovered.

Each run's output directory must hold exactly its oracle's files, each
byte-identical but ``stats.yaml`` (equal but for ``command`` and
``peak_memory_bytes``).

Each kernel's launch count is reset just before each main-path run and
read just after it: ``run_ends``, ``run_starts`` and ``probe_rows`` (the
warm starts) must launch in phases 4 and 5 (``run_starts`` also in 14
and in 17's sorted runs), ``stitch_rows`` in phases 5 and 7,
``run_ends`` in every sorted run of phase 19 (its ghosted first drain)
and ``run_starts`` and ``stitch_rows`` in its 4M and 8M sorted runs,
``reach_closure`` in phases 4, 5, 7, 11 (sorted), 14, 17 (sorted), 18
(sorted) and 19 (sorted) at least once per closure call (the run's
``closures`` sPCR phase), where ``probe_rows`` may launch no more often
than that, the
plain closure loop must never run and no sorted store's host mirror may be built
(sharded or not). ``hash_insert`` must launch in phases 9, 11 (hash),
12, 15, 16, 17 (hash) and 18 (hash), once per insert of a batch, merge
and grow of a hash table and device group (one routed launch for all
shards of a group; also in phase 19's hash runs), ``hash_lookup`` in
phases 10, 15 and 18 (``--mirror
device``), once per lookup wave, and none of the sorted store's kernels
in those hash runs;
``KmerTable.to_sorted_arrays`` (the host mirror) runs once in phases 9
(plus once for the checkpoint), 11 (hash), 12, 17 (hash, 1 shard) and
19 (hash),
never under ``--mirror device``, and ``ShardedKmerTable``'s once in
phases 15 (host mirror), 16, 17 (hash, 4 shards) and 18 (load). A
logged
``sPCR device-index build failed`` or ``reach warmup failed`` (the copied
``pcr/counts.py`` swallows those errors and falls back to the host
mirror) fails the run. The last two lines of standard output are the
kernels' JSON record and the result line ``{"ok": true, "device":
{...}}``. Without a CUDA device, or without the repository around it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
# the offline grid (benchmarks/benchmark_offline.yaml): each panel's seed
SEEDS = {"cnidaria": 0, "hydrozoa": 1, "metazoa": 2}
N_READS_MAX = 8_000_000  # the grid's deepest cell: one FASTQ a panel
M = 1_000_000
# phase 19: the committed cells that phases 4-18 do not run, sorted
# (the main path), then the hash backend's
GRID_SORTED = [("cnidaria", 8 * M), ("hydrozoa", M), ("hydrozoa", 4 * M),
               ("hydrozoa", 8 * M), ("metazoa", M), ("metazoa", 4 * M),
               ("metazoa", 8 * M)]
GRID_HASH = [("cnidaria", 8 * M), ("hydrozoa", M), ("metazoa", M)]
PANELS = {p: os.path.join(HERE, "sharkmer_tpu_torch", "panels", f"{p}.yaml")
          for p in SEEDS}
FASTQS = {p: os.path.join(HERE, "benchmarks", "work", "synth",
                          f"{p}_synthetic-seed{seed}_{N_READS_MAX}.fastq.gz")
          for p, seed in SEEDS.items()}
# phases 4-18: the cnidaria cells
PANEL, FASTQ = PANELS["cnidaria"], FASTQS["cnidaria"]
OUT_DIR = os.path.join(HERE, "build", "chip_smoke")
KERNEL_N = 1 << 27
PART_ROWS = 1 << 26
GENOME_BASES = 1 << 20
CLOSURE_PARTS = 21
CLOSURE_SHARDS = 4  # the owner-routed layout of phase 13
CLOSURE_MC = 2  # the closures' count floor
WIDE_BUCKET_BASES = 1 << 14  # the genome of the 256-row-bucket table
WIDE_BUCKET_DEPTH = 512
HBM_BYTES_PER_MS = 3.35e9  # the H100 SXM's 3.35 TB/s
STITCH_SHAPE = (2048, 1 << 16)
HASH_READS = 1 << 17  # one CLI ingest batch
HASH_CAP = 1 << 27  # the 1M cell's final hash table
HASH_SHARDS = 4  # the owner-routed insert and lookup of phase 8
LOOKUP_WAVE = 4096
LOOKUP_MANY = 1 << 20
CHECKPOINT = os.path.join(OUT_DIR, "hash_1M.npz")
N_SHARDS = "4"  # --n-shards of phases 14-18
DEVICES_ENV = "SHARKMER_TORCH_DEVICES"
# phase 18: four shard groups in separate allocations on the one card,
# the code path that four cards run
ONE_CARD_GROUPS = ["cuda:0"] * int(N_SHARDS)
# the chunked spectra's oracle: the JAX package's --chunks 10 outputs on
# the first CHUNK_READS reads (one synthesis slab of tools/synth.py, so
# the same reads in every file of that seed)
CHUNK_READS = 250_000
CHUNK_ORACLE = os.path.join(HERE, "oracles", "cnidaria", "synthetic-seed0",
                            f"chunks10_{CHUNK_READS}")
K = 19
INT64_MAX = (1 << 63) - 1
VARYING_STATS = ("command", "peak_memory_bytes")
PANEL_SCAN_OUT = 1 << 14  # SortedKmerStore.prefix_scan_many's max_out
FALLBACK_WARNINGS = ("sPCR device-index build failed", "reach warmup failed")

KERNELS = {
    # name: (source in the repo, the TPU kernel it replaces)
    "run_ends": ("sharkmer_tpu_torch/csrc/run_scan.cu",
                 "sharkmer_tpu/ops/pallas_kernels.py:264"),
    "run_starts": ("sharkmer_tpu_torch/csrc/run_scan.cu",
                   "sharkmer_tpu/ops/pallas_kernels.py:132"),
    "probe_rows": ("sharkmer_tpu_torch/csrc/probe_rows.cu",
                   "sharkmer_tpu/ops/pallas_kernels.py:395"),
    "stitch_rows": ("sharkmer_tpu_torch/csrc/stitch_rows.cu",
                    "sharkmer_tpu/ops/pallas_kernels.py:504"),
    # the JAX closure loop (ops/reach.py _closure_run) around probe_rows
    "reach_closure": ("sharkmer_tpu_torch/csrc/reach_closure.cu",
                      "sharkmer_tpu/ops/pallas_kernels.py:395"),
    # XLA programs, not Pallas kernels: torch has no op for either
    "hash_insert": ("sharkmer_tpu_torch/csrc/hash_table.cu",
                    "sharkmer_tpu/ops/hashtable.py:69"),
    "hash_lookup": ("sharkmer_tpu_torch/csrc/hash_table.cu",
                    "sharkmer_tpu/ops/hashtable.py:199"),
}


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(title: str) -> None:
    print(f"== {title}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    require(out, "nvidia-smi printed no card")
    return out[0]


def sorted_test_keys(np, n: int):
    """Sorted int64 keys from default_rng(0): about n/3 distinct, runs
    of 1-4 plus long runs of 3000 crossing tile boundaries, and a
    sentinel (INT64_MAX) tail of n/7."""
    rng = np.random.default_rng(0)
    tail = n // 7
    body = n - tail
    distinct = np.sort(rng.integers(0, 1 << 62, size=n // 3, dtype=np.int64))
    lengths = rng.integers(1, 5, size=distinct.size)
    lengths[rng.integers(0, distinct.size, size=2000)] = 3000
    keys = np.repeat(distinct, lengths)[:body]
    if keys.size < body:
        keys = np.concatenate(
            [keys, np.full(body - keys.size, keys[-1], np.int64)])
    return np.concatenate([keys, np.full(tail, INT64_MAX, np.int64)])


def median_ms(torch, fn, reps: int, reset=None) -> float:
    """Median CUDA-event ms of ``reps`` calls of ``fn``, each after an
    untimed ``reset`` where one is given."""
    times = []
    for _ in range(reps):
        if reset is not None:
            reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, name: str, kernel, plain, reps: int, card: str,
            what: str, library=None) -> dict:
    """Exact equality of kernel() with plain() and, where given, with
    library() (one PyTorch call that computes the same function), then
    median times in turns: plain, library, kernel, kernel, library,
    plain."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    require(got.dtype == want.dtype and got.shape == want.shape,
            f"{name}: {got.dtype} {tuple(got.shape)} vs plain "
            f"{want.dtype} {tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    require(err == 0 and torch.equal(got, want),
            f"{name}: kernel differs from plain on {what} "
            f"(max abs err {err})")
    if library is not None:
        require(torch.equal(got, library()),
                f"{name}: kernel differs from the library call on {what}")
    del got, want
    plain_ms = median_ms(torch, plain, reps)
    library_ms = None if library is None else median_ms(torch, library, reps)
    ms = (median_ms(torch, kernel, reps) + median_ms(torch, kernel, reps)) / 2
    if library is not None:
        library_ms = (library_ms + median_ms(torch, library, reps)) / 2
    plain_ms = (plain_ms + median_ms(torch, plain, reps)) / 2
    lib_text = "" if library is None else f", {library_ms:.4f} ms library"
    print(f"{name}: exact on {what}; median {ms:.4f} ms kernel vs "
          f"{plain_ms:.4f} ms plain{lib_text} on {card}", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms}


def byte_bound(n_bytes: int) -> dict:
    """The least time for ``n_bytes`` at the card's memory rate."""
    return {"bound_ms": n_bytes / HBM_BYTES_PER_MS, "bound_by": "bytes",
            "bytes": n_bytes}


def chase_lib():
    import ctypes

    from sharkmer_tpu_torch.kernels import build

    lib = build.load("chase")
    lib.shk_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p]
    lib.shk_chase.restype = ctypes.c_int
    return lib


def load_latency(torch) -> dict:
    """ns per dependent load (``csrc/chase.cu``) along a random ring of
    128 B lines: 2^15 lines (4 MB) walked once before the timed walks, so
    they hit L2; 2^23 lines (1 GB, the closure table's keys and counts),
    cold, so the loads go to DRAM. Median of three timed walks each."""
    lib = chase_lib()
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(5)
    steps = 1 << 16
    result = {}
    for where, n_lines in (("l2_ns", 1 << 15), ("dram_ns", 1 << 23)):
        ring = 32 * torch.randperm(n_lines, device="cuda", generator=gen)
        nxt = torch.zeros(32 * n_lines, dtype=torch.int32, device="cuda")
        nxt[ring] = torch.roll(ring, -1).to(torch.int32)
        start = int(ring[0])
        del ring

        def walk(n):
            rc = lib.shk_chase(nxt.data_ptr(), start, n, out.data_ptr(),
                               stream)
            require(rc == 0, f"chase: CUDA launch failed (cudaError {rc})")

        if where == "l2_ns":
            walk(n_lines)  # load the ring into L2
        times = []
        for _ in range(3):
            times.append(median_ms(torch, lambda: walk(steps), 1))
            if where == "dram_ns":  # a fresh stretch of the ring each time
                start = int(out[0])
        result[where] = statistics.median(times) * 1e6 / steps
        del nxt
    torch.cuda.empty_cache()
    return result


def chain_ms(latency: dict, levels: int) -> float:
    """The least time of ``levels`` dependent probe levels: a level's
    candidates come from the hits of the one before, and each probe is
    a LUT load (at best an L2 hit), then its bucket rows (from DRAM: the
    table is far past L2), then the claim of its row (an L2 atomic). The
    frontier itself could stay on chip."""
    return levels * (2 * latency["l2_ns"] + latency["dram_ns"]) / 1e6


def bucket_bytes(torch, side, cand) -> int:
    """Bytes of one partition's LUT entries and bucket rows (8 B key and
    8 B count) that probing ``cand`` reads, each read once."""
    cand = cand[cand != INT64_MAX].to(side.lut.device)
    if not cand.numel():
        return 0
    b = torch.unique(torch.clamp(cand >> side.shift, max=side.lut.shape[0] - 2))
    n_lut = torch.unique(torch.cat([b, b + 1])).numel()
    rows = int((side.lut[b + 1] - side.lut[b]).to(torch.int64).sum())
    return 4 * n_lut + 16 * rows


def routed_bytes(torch, table, cand) -> int:
    """``bucket_bytes`` of each candidate in the partition the table
    routes it to (its key range, or its owner shard)."""
    part = table.route(cand)
    return sum(bucket_bytes(torch, side, cand[part == i])
               for i, side in enumerate(table.sidecars))


def closure_table(np, torch, n_rows: int, k: int):
    """A table of ``n_rows`` rows from default_rng(4): every k-mer of a
    random genome of GENOME_BASES bases plus random filler keys, 3/4 of
    the rows in all, canonical, sorted, sentinel tail. Counts in [1, 40),
    the genome's at or above CLOSURE_MC but for one in 10^4 (a break in
    the walk). Returns (keys, counts, n_real, the genome's k-mers)."""
    from sharkmer_tpu_torch.ops.histogram import revcomp

    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, size=GENOME_BASES)
    n_k = GENOME_BASES - k + 1
    fwd = np.zeros(n_k, np.int64)
    for j in range(k):
        fwd = (fwd << 2) | genome[j : j + n_k]
    filler = rng.integers(0, 1 << (2 * k), size=n_rows * 3 // 4 - n_k)
    raw = torch.from_numpy(np.concatenate([fwd, filler])).cuda()
    uniq = torch.unique(torch.minimum(raw, revcomp(raw, k)))
    n_real = uniq.shape[0]
    counts = torch.zeros(n_rows, dtype=torch.int64, device="cuda")
    counts[:n_real] = torch.from_numpy(rng.integers(1, 40, size=n_real)).cuda()
    on_genome = torch.from_numpy(fwd).cuda()
    on_genome = torch.searchsorted(
        uniq, torch.minimum(on_genome, revcomp(on_genome, k)))
    g_counts = rng.integers(CLOSURE_MC, 40, size=n_k)
    g_counts[rng.random(n_k) < 1e-4] = 1
    counts[on_genome] = torch.from_numpy(g_counts).cuda()
    keys = torch.full((n_rows,), INT64_MAX, dtype=torch.int64, device="cuda")
    keys[:n_real] = uniq
    return keys, counts, n_real, fwd


def wide_bucket_table(np, torch, k: int):
    """A table whose buckets at the LUT's bits cap hold 256 rows (about
    64 in each of 4 owner shards): each canonical k-mer of a random
    genome of WIDE_BUCKET_BASES bases (default_rng(8)) with the 255 keys
    that share all but its low 8 bits,
    sorted, sentinel tail to a power of two. The genome's keys count
    [CLOSURE_MC, 40), the others 1 (below the floor). Returns (keys,
    counts, n_real, the genome's k-mers)."""
    from sharkmer_tpu_torch.ops.histogram import revcomp

    rng = np.random.default_rng(8)
    genome = rng.integers(0, 4, size=WIDE_BUCKET_BASES)
    n_k = WIDE_BUCKET_BASES - k + 1
    fwd = np.zeros(n_k, np.int64)
    for j in range(k):
        fwd = (fwd << 2) | genome[j : j + n_k]
    g = torch.from_numpy(fwd).cuda()
    g = torch.unique(torch.minimum(g, revcomp(g, k)))
    block = torch.arange(256, dtype=torch.int64, device="cuda")
    uniq = torch.unique(((g >> 8) << 8)[:, None] | block[None, :])
    n_real = uniq.shape[0]
    n_rows = 1 << n_real.bit_length()
    keys = torch.full((n_rows,), INT64_MAX, dtype=torch.int64, device="cuda")
    keys[:n_real] = uniq
    counts = torch.zeros(n_rows, dtype=torch.int64, device="cuda")
    counts[:n_real] = 1
    counts[torch.searchsorted(uniq, g)] = torch.from_numpy(
        rng.integers(CLOSURE_MC, 40, size=g.shape[0])).cuda()
    return keys, counts, n_real, fwd


def cut_table(torch, keys, counts, n_real: int, n_parts: int, k: int):
    """The table cut into ``n_parts`` key-range partitions of equal real
    rows, each padded with sentinels to a power-of-two width as the
    store's partitions are."""
    from sharkmer_tpu_torch.kernels import probe
    from sharkmer_tpu_torch.ops import reach

    sidecars, bases, off = [], [], 0
    for i in range(n_parts):
        a, b = n_real * i // n_parts, n_real * (i + 1) // n_parts
        width = 1 << (b - a).bit_length()
        pk = torch.full((width,), INT64_MAX, dtype=torch.int64, device="cuda")
        pc = torch.zeros(width, dtype=torch.int64, device="cuda")
        pk[: b - a], pc[: b - a] = keys[a:b], counts[a:b]
        first = 0 if i == 0 else int(keys[a])
        sidecars.append(reach.build_sidecar(pk, pc, k, first))
        bases.append(off)
        off += width
    return probe.PartTable(sidecars, bases)


def shard_table(torch, keys, counts, n_real: int, n_shards: int, k: int,
                devices=None):
    """The table's real rows split by owner (``kernels/hash.owner``) into
    ``n_shards`` sorted shards of one power-of-two width, sentinel tails,
    global row id ``shard * width + row``: the layout of
    ``ShardedSortedStore`` and its owner-routed ``PartTable``. With
    ``devices``, shard ``s`` lives on ``devices[s * D // S]`` and the
    table launches on ``devices[0]``, as the store places them."""
    from sharkmer_tpu_torch.kernels import probe
    from sharkmer_tpu_torch.kernels.hash import owner
    from sharkmer_tpu_torch.ops import reach

    own = owner(keys[:n_real], n_shards)
    sizes = torch.bincount(own, minlength=n_shards).tolist()
    width = 1 << (max(sizes) - 1).bit_length()
    sidecars = []
    for s, size in enumerate(sizes):
        home = "cuda" if devices is None else devices[
            s * len(devices) // n_shards]
        pk = torch.full((width,), INT64_MAX, dtype=torch.int64, device=home)
        pc = torch.zeros(width, dtype=torch.int64, device=home)
        mine = own == s
        pk[:size] = keys[:n_real][mine].to(home)
        pc[:size] = counts[:n_real][mine].to(home)
        sidecars.append(reach.build_sidecar(pk, pc, k))
    return probe.PartTable(sidecars, [s * width for s in range(n_shards)],
                           by_owner=True,
                           device=None if devices is None else devices[0])


def closure_bytes(torch, table, c0, pre_ids, log_sorted, state, boundary,
                  k: int) -> int:
    """The least bytes of one closure call: c0 and pre_ids read once; the
    LUT entries and bucket rows of every candidate it probed read once
    (the roots and the 8 neighbours of every visited key but the
    boundary's, which were never expanded); the log, boundary and state
    written once."""
    from sharkmer_tpu_torch.ops import reach
    from sharkmer_tpu_torch.ops.histogram import revcomp

    n_vis, _it, _overflow, done = state
    keys, _ = reach._gather_rows(table, log_sorted[:n_vis])
    if not done:
        keys = keys[~torch.isin(keys, boundary)]
    kmask, top = (1 << (2 * k)) - 1, 2 * (k - 1)
    base = torch.arange(4, dtype=torch.int64, device=keys.device)[None, :]
    f, r = keys[:, None], revcomp(keys, k)[:, None]
    cand = torch.cat([((f << 2) | base) & kmask, (base << top) | (f >> 2)], 1)
    cand_rc = torch.cat([((3 - base) << top) | (r >> 2),
                         ((r << 2) | (3 - base)) & kmask], 1)
    roots = c0[c0 != INT64_MAX]
    probed = torch.cat([torch.minimum(cand, cand_rc).reshape(-1),
                        torch.minimum(roots, revcomp(roots, k))])
    n_pre = 0 if pre_ids is None else pre_ids.numel()
    return (8 * c0.numel() + 4 * n_pre + 48 * len(table.sidecars)
            + routed_bytes(torch, table, probed) + 4 * log_sorted.numel()
            + 8 * boundary.numel() + 32)


def key_range_layouts(torch):
    """Phase 3's layouts of the closure table: one partition, and
    CLOSURE_PARTS key-range partitions."""
    from sharkmer_tpu_torch.kernels import probe
    from sharkmer_tpu_torch.ops import reach

    return {"1 partition": lambda keys, counts, n_real: probe.PartTable(
                [reach.build_sidecar(keys, counts, K)], [0]),
            f"{CLOSURE_PARTS} partitions": lambda keys, counts, n_real:
                cut_table(torch, keys, counts, n_real, CLOSURE_PARTS, K)}


def owner_layouts(torch):
    """Phase 13's layout of the closure table: CLOSURE_SHARDS owner
    shards."""
    return {f"{CLOSURE_SHARDS} shards": lambda keys, counts, n_real:
            shard_table(torch, keys, counts, n_real, CLOSURE_SHARDS, K)}


def closure_cases(np, fwd) -> dict:
    """The closure calls of phases 3, 13 and 18 on ``closure_table``'s
    genome k-mers ``fwd``: name -> (roots, (depth, f_cap, f_narrow)).
    Attempt shapes as ``_drive_closure`` runs them (both widths grow by
    F_GROW a retry): 2 roots (narrow) and 48 roots (wide) at the first
    attempt's; 24 of the wide roots at the first retry's (f_cap 1024,
    f_narrow 64: frontiers in shared memory); the 48 roots at that shape,
    which overflow its narrow width; and the 48 roots at the third
    retry's (f_cap 16384, past the kernel's shared frontiers: global
    scratch)."""
    from sharkmer_tpu_torch.ops import reach

    depth, f_cap, f_narrow = reach.DEPTH, reach.F_CAP, reach.F_NARROW
    n_k = fwd.shape[0]
    wide = fwd[np.linspace(1000, n_k - 1000, 48).astype(int)]

    def attempt(j):
        grow = reach.F_GROW ** j
        return depth, f_cap * grow, f_narrow * grow

    return {"narrow": (fwd[[n_k // 4, 3 * n_k // 4]], attempt(0)),
            "wide": (wide, attempt(0)),
            "retry": (wide[::2], attempt(1)),
            "overflow": (wide, attempt(1)),
            "retry global": (wide, attempt(3))}


def check_luts(torch, name: str, table) -> None:
    """Each partition's LUT as the descriptors point to it: on the
    launching card, equal to the partition's own (a copy of it where the
    partition lies on another card)."""
    for i, (sc, lut) in enumerate(zip(table.sidecars, table.luts)):
        require(lut.device == table.desc.device
                and torch.equal(lut, sc.lut.to(table.desc.device))
                and int(table.desc[i, 2]) == lut.data_ptr(),
                f"{name}: partition {i}'s LUT on {lut.device} is not its "
                f"own LUT on the launching card")


def closure_phase(torch, np, card: str, latency: dict, layouts,
                  plain: bool = True) -> dict:
    """``reach_closure`` against ``closure_plain`` on a 2^26-row table in
    each of ``layouts`` (name: build(keys, counts, n_real) -> PartTable),
    on ``closure_cases`` and a warm start; ``probe_rows`` against
    ``probe_rows_plain`` at the warm start's PRE_W keys; then both on
    ``wide_bucket_table``. Each with its byte bound and its latency bound
    (``chain_ms``). ``plain=False`` runs and times the kernels alone
    (``--closure-times``): no plain run, no comparison, no LUT check (so
    that it also runs on trees older than ``PartTable.luts``)."""
    from sharkmer_tpu_torch.kernels import closure, probe
    from sharkmer_tpu_torch.ops import reach
    from sharkmer_tpu_torch.ops.keys import keys_to_device, keys_to_numpy

    start = time.monotonic()
    keys, counts, n_real, fwd = closure_table(np, torch, PART_ROWS, K)
    tables = {name: build(keys, counts, n_real)
              for name, build in layouts.items()}
    torch.cuda.synchronize()
    print(f"closure table: {PART_ROWS} rows, {n_real} keys, "
          f"{GENOME_BASES}-base genome; built in "
          f"{time.monotonic() - start:.3f} s", flush=True)
    for name, table in tables.items():
        if not plain:
            continue
        check_luts(torch, name, table)
        if table.lut_copy_bytes:  # peer shards' LUTs on the launching card
            print(f"{name}: LUT copies on {table.device}, each equal to its "
                  f"shard's own: {table.lut_copy_bytes} bytes", flush=True)
    depth, f_cap, f_narrow = reach.DEPTH, reach.F_CAP, reach.F_NARROW

    def c0_of(roots):
        c0 = np.full(8 * f_cap, reach.EMPTY, np.uint64)
        roots = np.unique(np.asarray(roots, np.uint64))
        c0[: len(roots)] = roots
        return keys_to_device(c0, "cuda")

    def run(table, c0, pre_ids, fn, shape):
        return fn(table, c0, pre_ids, CLOSURE_MC, K, *shape)

    def event_ms(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out

    def check(label, table, c0, pre_ids, shape, plain_twice=False,
              overflow=False):
        """Kernel against plain on one call at ``shape`` (depth, f_cap,
        f_narrow), then CUDA-event times: the plain run that checked, 10
        kernel runs, and a second plain run when ``plain_twice`` (plain,
        kernel x 10, plain). ``overflow``: the call must overflow (else it
        must walk past half its depth)."""
        if plain:
            plain_ms, want = event_ms(lambda: run(
                table, c0, pre_ids, closure.closure_plain, shape))
        got = run(table, c0, pre_ids, closure.reach_closure, shape)
        gs = closure.unpack_state(got[2])
        require(gs[2] if overflow else not gs[2] and gs[1] > shape[0] // 2,
                f"reach_closure {label}: overflow {gs[2]} (wanted "
                f"{int(overflow)}) or a short walk {gs}")
        g_log = torch.sort(got[0]).values
        g_b = torch.unique(got[1][got[1] != INT64_MAX])
        err = None
        if plain:
            ws = closure.unpack_state(want[2])
            require(gs == ws, f"reach_closure {label}: [n_vis, iters, "
                    f"overflow, done] {gs} vs plain {ws}")
            w_log = torch.sort(want[0]).values
            err = int((g_log.to(torch.int64)
                       - w_log.to(torch.int64)).abs().max())
            require(err == 0 and torch.equal(g_log, w_log),
                    f"reach_closure {label}: sorted logs differ")
            w_b = torch.unique(want[1][want[1] != INT64_MAX])
            require(torch.equal(g_b, w_b),
                    f"reach_closure {label}: boundary sets differ")
        ms = statistics.median(
            event_ms(lambda: run(table, c0, pre_ids, closure.reach_closure,
                                 shape))[0]
            for _ in range(10))
        if plain and plain_twice:
            plain_ms = (plain_ms + event_ms(lambda: run(
                table, c0, pre_ids, closure.closure_plain, shape))[0]) / 2
        # levels that probed: up to 3 narrow levels after `done` ran on
        # an empty frontier
        levels = gs[1] - 3 * gs[3]
        result = {"max_abs_err": err, "ms": ms,
                  "plain_ms": plain_ms if plain else None,
                  "n_vis": gs[0], "iters": gs[1], "done": gs[3],
                  "boundary": int(g_b.numel()),
                  "library_ms": None,  # no torch op runs a BFS closure
                  **byte_bound(closure_bytes(torch, table, c0, pre_ids, g_log,
                                             gs, got[1], K)),
                  "latency_bound_ms": chain_ms(latency, levels),
                  "latency_levels": levels}
        what = "exact" if plain else "ran"
        versus = f" vs {plain_ms:.4f} ms plain" if plain else ""
        print(f"reach_closure: {what} on {label}: {result}; median "
              f"{ms:.4f} ms a call{versus} on {card}", flush=True)
        return result, got

    def check_probe(label, table, cand):
        """``probe_rows`` against ``probe_rows_plain`` on ``cand``, timed
        (kernel ids alone with ``plain=False``)."""
        args = (table, cand, CLOSURE_MC)
        if not plain:
            ids = probe.probe_rows(*args)
            return {"ms": median_ms(torch, lambda: probe.probe_rows(*args),
                                    20)}, ids
        result = compare(torch, "probe_rows", lambda: probe.probe_rows(*args),
                         lambda: probe.probe_rows_plain(*args), 20, card,
                         label)
        result.update(byte_bound(12 * cand.numel() + 48 * len(table.sidecars)
                                 + routed_bytes(torch, table, cand)))
        # one level of probes, all in parallel: the key, the LUT, the
        # bucket rows
        result["latency_bound_ms"] = chain_ms(latency, 1)
        return result, probe.probe_rows(*args)

    cases = closure_cases(np, fwd)
    record = {}
    for name, table in tables.items():
        got = {}
        for call, (roots, shape) in cases.items():
            record[f"{call}, {name}"], got[call] = check(
                f"{name}, {call}: {len(roots)} roots at (depth, f_cap, "
                f"f_narrow) {shape}", table, c0_of(roots), None, shape,
                plain_twice=call == "narrow" and name == "1 partition",
                overflow=call == "overflow")
        # a re-prefetch from the narrow call's boundary, warm-started with
        # its interior, as pcr/prefetch.py does
        narrow = got["narrow"]
        log_sorted = torch.sort(narrow[0]).values
        visited, _ = reach._gather_rows(
            table, log_sorted[: record[f"narrow, {name}"]["n_vis"]])
        bound = keys_to_numpy(narrow[1])
        bound = bound[bound != reach.EMPTY]
        pre = np.setdiff1d(keys_to_numpy(visited), bound)
        pre_t = keys_to_device(reach._pad_pre(pre, roots=bound), "cuda")
        record[f"probe_rows, {name}"], pre_ids = check_probe(
            f"{pre_t.numel()} warm-start keys, {name}", table, pre_t)
        # every warm-start key was visited, so each one hits
        n_pre = int((pre_t != INT64_MAX).sum())
        require(int((pre_ids != probe.INF32).sum()) == n_pre > 0,
                f"probe_rows: not every one of {n_pre} warm-start keys hit")
        record[f"pre, {name}"] = check(f"{name}, warm start", table,
                                       c0_of(bound), pre_ids,
                                       (depth, f_cap, f_narrow))[0]
    del tables, keys, counts
    torch.cuda.empty_cache()
    # buckets past 32 rows at the LUT's bits cap: the probe's rows past
    # the first 32 of a bucket, in the closure and in probe_rows
    keys, counts, n_real, fwd = wide_bucket_table(np, torch, K)
    n_k, shape = fwd.shape[0], (WIDE_BUCKET_DEPTH, f_cap, f_narrow)
    roots = c0_of(fwd[[n_k // 4, 3 * n_k // 4]])
    # PRE_W of the table's keys: genome k-mers (counts >= the floor, so
    # hits) and the keys beside them in their 256-key blocks (misses)
    pick = torch.from_numpy(np.sort(np.random.default_rng(9).choice(
        n_real, reach.PRE_W, replace=False))).cuda()
    cand, hits = keys[pick], int((counts[pick] >= CLOSURE_MC).sum())
    for name, build in layouts.items():
        table = build(keys, counts, n_real)
        if plain:
            check_luts(torch, f"wide buckets, {name}", table)
        widest = max(int((sc.lut[1:] - sc.lut[:-1]).max())
                     for sc in table.sidecars)
        require(widest > 32 and all(
            sc.bits == reach._lut_bits_cap(K) for sc in table.sidecars),
            f"wide buckets, {name}: the widest bucket holds {widest} rows")
        record[f"wide bucket, {name}"] = check(
            f"{name}, buckets of up to {widest} rows at the bits cap, 2 roots",
            table, roots, None, shape)[0]
        res, ids = check_probe(
            f"{reach.PRE_W} keys in buckets of up to {widest} rows, {name}",
            table, cand)
        past = rows_past(torch, table, cand, ids, 32)
        require(int((ids != probe.INF32).sum()) == hits > 0 and past > 0,
                f"probe_rows, wide buckets, {name}: {hits} genome keys, "
                f"{int((ids != probe.INF32).sum())} hits, {past} of them "
                f"past a bucket's first 32 rows")
        print(f"probe_rows, wide buckets, {name}: {hits} hits, {past} past "
              f"a bucket's first 32 rows", flush=True)
        record[f"probe_rows wide bucket, {name}"] = res
    del table, keys, counts
    torch.cuda.empty_cache()
    return record


def rows_past(torch, table, cand, ids, n: int) -> int:
    """How many of the hits ``ids`` (global row ids of ``cand``, INF32
    for a miss) lie past the first ``n`` rows of their bucket."""
    from sharkmer_tpu_torch.kernels import probe

    hit = ids != probe.INF32
    bases = torch.tensor(table.bases, dtype=torch.int64, device=ids.device)
    part = torch.searchsorted(bases, ids[hit].to(torch.int64), right=True) - 1
    past = 0
    for i, sc in enumerate(table.sidecars):
        mine = part == i
        row = ids[hit][mine].to(torch.int64) - table.bases[i]
        lut = sc.lut.to(ids.device).to(torch.int64)
        b = torch.clamp(cand[hit][mine] >> sc.shift, max=lut.shape[0] - 2)
        past += int((row - lut[b] >= n).sum())
    return past


class _RunLog(logging.Handler):
    """Keeps the CLI's stage-wall and sPCR-phase lines of each run, every
    fallback warning of the sPCR index and, in a run with ``-vv``, the
    debug line of each closure call."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines: list[str] = []
        self.fallbacks: list[str] = []
        self.closures: list[str] = []  # _drive_closure's lines (-vv)

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("reach: "):
            self.closures.append(msg)
        if "stage walls:" in msg or "sPCR phases:" in msg:
            self.lines.append(msg.strip())
        if any(w in msg for w in FALLBACK_WARNINGS):
            self.fallbacks.append(msg.strip())


def spcr_wall(line: str) -> float:
    return float(line.split("sPCR ")[1].split(" s")[0])


def closure_calls(lines) -> int:
    """The closure calls of a run, from its ``closures <wall>s/<calls>``
    sPCR phase (none under --mirror full)."""
    for line in lines:
        if "sPCR phases:" in line and " closures " in line:
            return int(line.split(" closures ")[1].split("/")[1].split(",")[0])
    return 0


def instrument(torch, kernels):
    """The context of ``drive_main_path``: a handler that keeps the CLI's
    stage-wall and sPCR-phase lines, and wrappers that count the host
    mirror builds, the closures that ran the torch loop, the hash
    tables' inserts, merges, grows and lookup waves."""
    from sharkmer_tpu_torch.kernels import closure
    from sharkmer_tpu_torch.ops.hashtable import KmerTable
    from sharkmer_tpu_torch.ops.sorted_store import SortedKmerStore
    from sharkmer_tpu_torch.parallel.sharded_table import ShardedKmerTable
    from sharkmer_tpu_torch.parallel.sorted_sharded import ShardedSortedStore

    from sharkmer_tpu_torch.ops import sorted_store

    run_log = _RunLog()
    logging.getLogger().addHandler(run_log)
    ctx = types.SimpleNamespace(
        torch=torch, kernels=kernels, run_log=run_log, mirror_builds=[],
        plain_closures=[], hash_exports=[], shard_exports=[],
        hash_grows=[], lookup_waves=[], table_calls=[], panel_scans=[])

    def counted(cls, name, event):
        """Wrap ``cls.name`` to append ``event(args)`` per call."""
        original = getattr(cls, name)

        def wrapper(*args, **kwargs):
            out = original(*args, **kwargs)
            event(args)
            return out

        setattr(cls, name, wrapper)

    counted(SortedKmerStore, "to_sorted_arrays",
            lambda a: ctx.mirror_builds.append(1))
    counted(ShardedSortedStore, "to_sorted_arrays",
            lambda a: ctx.mirror_builds.append(1))
    counted(KmerTable, "to_sorted_arrays",
            lambda a: ctx.hash_exports.append(1))
    counted(ShardedKmerTable, "to_sorted_arrays",
            lambda a: ctx.shard_exports.append(1))

    def batch_insert(args):
        if len(args[1]):  # an empty batch launches nothing
            ctx.table_calls.append("insert")

    # each of these launches hash_insert once a device group (an insert
    # of a non-empty batch, a merge, a grow: the sharded ones routed)
    for cls in (KmerTable, ShardedKmerTable):
        counted(cls, "insert_kmers", batch_insert)
        counted(cls, "merge_from",
                lambda a: ctx.table_calls.append("merge"))
        counted(cls, "_grow", lambda a: (
            ctx.table_calls.append("grow"),
            ctx.hash_grows.append(getattr(a[0], "capacity", None) or
                                  a[0].n_shards * a[0].local_capacity)))
    counted(KmerTable, "lookup_directional",
            lambda a: ctx.lookup_waves.append(len(a[1])))
    counted(ShardedKmerTable, "lookup_directional",
            lambda a: ctx.lookup_waves.append(len(a[1])))
    # on the card the closure must never fall back to its torch loop
    counted(closure, "closure_plain",
            lambda a: ctx.plain_closures.append(1))
    # the batched primer scan of a partition: its last argument is the
    # call's max_out, past PANEL_SCAN_OUT on a retry
    counted(sorted_store, "panel_scan",
            lambda a: ctx.panel_scans.append(a[-1]))
    return ctx


def oracle_of(panel: str, n_reads: int) -> str:
    """The JAX package's committed cell of ``panel`` at ``n_reads``."""
    return os.path.join(HERE, "benchmarks", "work", panel,
                        f"synthetic-seed{SEEDS[panel]}", str(n_reads))


def check_outputs(label: str, out: str, oracle: str, sample: str) -> None:
    """``out`` holds exactly the files of ``oracle``, one ``stats.yaml``
    and at least one FASTA among them, each byte-identical but
    ``stats.yaml``, equal but for VARYING_STATS."""
    import yaml

    stats_name = f"{sample}.stats.yaml"
    want, got = sorted(os.listdir(oracle)), sorted(os.listdir(out))
    fasta = [f for f in want if f.endswith(".fasta")]
    require(got == want and fasta and stats_name in want,
            f"{label}: output files {got} != {want}")
    for name in want:
        if name == stats_name:
            continue
        with open(os.path.join(oracle, name), "rb") as a, \
                open(os.path.join(out, name), "rb") as b:
            require(a.read() == b.read(), f"{label}: {name} differs")
    with open(os.path.join(oracle, stats_name)) as a, \
            open(os.path.join(out, stats_name)) as b:
        sa, sb = yaml.safe_load(a), yaml.safe_load(b)
    for key in VARYING_STATS:
        sa.pop(key), sb.pop(key)
    require(sa == sb, f"{label}: stats.yaml differs: {sb} != {sa}")
    others = [f for f in want if f != stats_name and f not in fasta]
    print(f"{label}: {len(fasta)}/{len(fasta)} FASTA"
          f"{''.join(', ' + f for f in others)} byte-identical to "
          f"{os.path.relpath(oracle, HERE)}, stats.yaml equal (but for "
          f"{', '.join(VARYING_STATS)})", flush=True)


def closure_retries(closure_lines) -> list[tuple[int, int]]:
    """(f_cap, overflow retries) of each closure call, from the debug
    lines of ``_drive_closure`` (the kept attempt's f_cap): a call
    starts at F_CAP, grown by F_GROW until it holds min(roots, 4096)
    roots, and each overflow grows it by F_GROW again."""
    from sharkmer_tpu_torch.ops.reach import F_CAP, F_GROW

    calls = []
    for line in closure_lines:
        roots = int(line.split("reach: ")[1].split(" roots")[0])
        f_cap = int(line.split("f_cap ")[1].split(",")[0])
        start = F_CAP
        while start < min(roots, 4096):
            start *= F_GROW
        retries = 0
        while start * F_GROW ** retries < f_cap:
            retries += 1
        calls.append((f_cap, retries))
    return calls


def drive_main_path(ctx, label: str, n_reads: int, extra=(),
                    fastq: bool = True, oracle: str | None = None,
                    panel: str = "cnidaria"):
    """One CLI run of ``panel``'s cell at ``n_reads`` (from the panel's
    FASTQ, or, with ``fastq=False``, from the checkpoint that ``extra``
    names), held to the JAX package's outputs in ``oracle`` (by default
    the committed cell of ``panel`` at ``n_reads``) by ``check_outputs``.
    Returns (the kernels' launch counts and the run's table counters, its
    stage-walls line)."""
    from sharkmer_tpu_torch.main import main

    torch, kernels, run_log = ctx.torch, ctx.kernels, ctx.run_log
    sample = f"synthetic-seed{SEEDS[panel]}_{n_reads}"
    oracle = oracle or oracle_of(panel, n_reads)
    out = os.path.join(OUT_DIR, label)
    shutil.rmtree(out, ignore_errors=True)
    argv = ["-s", sample, "-k", str(K), "-t", "8", "-o", out,
            "--pcr-panel-file", PANELS[panel], *extra]
    if fastq:
        argv += ["-m", str(n_reads), FASTQS[panel]]
    for index in range(torch.cuda.device_count()):  # each card's own peak
        torch.cuda.reset_peak_memory_stats(index)
    n_lines = len(run_log.lines)
    run_log.closures.clear()
    for events in (ctx.mirror_builds, ctx.plain_closures, ctx.hash_exports,
                   ctx.shard_exports, ctx.hash_grows, ctx.lookup_waves,
                   ctx.table_calls, ctx.panel_scans):
        events.clear()
    for fn in kernels.values():
        fn.launches = 0
    start = time.monotonic()
    rc = main(argv)
    wall = time.monotonic() - start
    counts = {name: fn.launches for name, fn in kernels.items()}
    require(rc == 0, f"{label}: the CLI exited {rc}")
    require(not run_log.fallbacks,
            f"{label}: the sPCR index fell back: {run_log.fallbacks}")
    require(not ctx.plain_closures,
            f"{label}: {len(ctx.plain_closures)} closures ran the torch loop")
    require("--mirror" in extra or not ctx.mirror_builds,
            f"{label}: the host mirror was built under --mirror auto")
    lines = run_log.lines[n_lines:]
    counts["closure_calls"] = closure_calls(lines)
    counts["hash_exports"] = len(ctx.hash_exports)
    counts["shard_exports"] = len(ctx.shard_exports)
    # the hash tables' calls that each launch hash_insert once, and the
    # lookup waves that each launch hash_lookup once
    counts["table_calls"] = len(ctx.table_calls)
    counts["lookup_waves"] = sum(1 for n in ctx.lookup_waves if n)
    walls = next(line for line in lines if "stage walls:" in line)
    print(f"{label}: CLI wall {wall:.3f} s; {walls}")
    for line in lines:
        if "sPCR phases:" in line:
            print(f"{label}: {line}")
    print(f"{label}: torch.cuda.max_memory_allocated() "
          f"{torch.cuda.max_memory_allocated()} bytes")
    print(f"{label}: host-mirror builds (to_sorted_arrays calls) "
          f"{len(ctx.mirror_builds)} sorted store, "
          f"{len(ctx.hash_exports)} hash table, "
          f"{len(ctx.shard_exports)} sharded hash table")
    if ctx.hash_grows:
        print(f"{label}: hash table grows to {ctx.hash_grows} slots")
    if ctx.table_calls:
        calls = {c: ctx.table_calls.count(c) for c in ("insert", "merge",
                                                      "grow")}
        print(f"{label}: hash table calls {calls}")
    if ctx.lookup_waves:
        waves = sorted(ctx.lookup_waves)
        print(f"{label}: {len(waves)} directional lookup waves of "
              f"{waves[0]}-{waves[-1]} queries (median "
              f"{waves[len(waves) // 2]})")
    print(f"{label}: kernel launches {counts}", flush=True)
    for line in run_log.closures:
        # the kept attempt of each call: roots, iters, n_vis, f_cap, wall
        print(f"{label}: closure call: {line[len('reach: '):]}")
    if run_log.closures:
        calls = closure_retries(run_log.closures)
        print(f"{label}: closure calls (f_cap, overflow retries): {calls}; "
              f"{sum(r for _, r in calls)} retries in all")
    if ctx.panel_scans:
        retried = [mo for mo in ctx.panel_scans if mo > PANEL_SCAN_OUT]
        print(f"{label}: batched primer scans: {len(ctx.panel_scans)} "
              f"panel_scan calls, {len(retried)} past max_out "
              f"{PANEL_SCAN_OUT} (retries at {retried})")
    check_outputs(label, out, oracle, sample)
    return counts, walls


def run_scan_phase(torch, np, card: str, kernels) -> dict:
    """``run_ends`` and ``run_starts`` against their plain versions and
    ``torch.searchsorted`` (exact), with median times: at 2^27 on
    ``sorted_test_keys`` (the drain width; the record's main row) and on
    all-equal keys, at 2^24 (the 2^24 cell's drain width), and at ragged
    lengths around the kernels' tile, once at a key pointer offset by one
    element. A ragged input is a slice across the start of the 2^24
    keys' sentinel tail."""
    from sharkmer_tpu_torch.kernels import run_scan

    library = {
        "run_starts": lambda keys: torch.searchsorted(keys, keys,
                                                      out_int32=True),
        "run_ends": lambda keys: torch.searchsorted(
            keys, keys, right=True, out_int32=True) - 1,
    }
    inputs = {name: {} for name in library}

    def check(what, keys, reps):
        for name, lib_call in library.items():
            kernel, plain = kernels[name], getattr(run_scan, f"{name}_plain")
            result = compare(torch, name, lambda: kernel(keys),
                             lambda: plain(keys), reps, card, what,
                             lambda: lib_call(keys))
            # read each 8 B key, write each 4 B position
            inputs[name][what] = {**result, **byte_bound(12 * keys.numel())}

    main_what = f"{KERNEL_N} sorted keys"
    keys = torch.from_numpy(sorted_test_keys(np, KERNEL_N)).cuda()
    check(main_what, keys, 5)
    keys.zero_()
    check(f"{KERNEL_N} equal keys", keys, 5)
    del keys
    torch.cuda.empty_cache()
    n = 1 << 24
    keys = torch.from_numpy(sorted_test_keys(np, n)).cuda()
    check(f"{n} sorted keys", keys, 10)
    tile = run_scan.tile()
    tail = n - n // 7
    for length in (1, tile - 1, tile, tile + 1, 3 * tile + 5):
        lo = tail - length // 2
        check(f"{length} keys (ragged, tile {tile})",
              keys[lo:lo + length].clone(), 10)
    buf = keys[lo:lo + length + 1].clone()
    require(buf[1:].data_ptr() % 16 == 8, "the offset keys are 16-B aligned")
    check(f"{length} keys at a pointer offset by 8 B", buf[1:], 10)
    del keys, buf
    torch.cuda.empty_cache()
    return {name: {**runs.pop(main_what), "inputs": runs}
            for name, runs in inputs.items()}


def kernel_phase(torch, np, card: str, kernels) -> dict:
    from sharkmer_tpu_torch.kernels import stitch

    record = run_scan_phase(torch, np, card, kernels)
    n_rows, width = STITCH_SHAPE
    rng = np.random.default_rng(2)
    lens = rng.integers(0, width + 1, size=n_rows)
    lens = np.minimum((lens + 1023) // 1024 * 1024, width)
    offs = torch.from_numpy(
        (np.cumsum(lens) - lens).astype(np.int32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = torch.randint(0, 1 << 62, STITCH_SHAPE, dtype=torch.int64,
                         device="cuda", generator=gen)
    record["stitch_rows"] = compare(
        torch, "stitch_rows", lambda: stitch.stitch_rows(rows, offs, INT64_MAX),
        lambda: stitch.stitch_rows_plain(rows, offs, INT64_MAX), 10, card,
        f"[{n_rows}, {width}] rows, {int(lens.sum())} kept")
    # read each kept element and the offsets, write the whole output
    record["stitch_rows"].update(byte_bound(
        8 * int(lens.sum()) + 4 * n_rows + 8 * n_rows * width))
    del rows, offs
    torch.cuda.empty_cache()
    return record


def first_batch_kmers(torch, np):
    """The port's canonical k-mers of the FASTQ's first HASH_READS reads,
    as one ingest batch of the CLI hands them to the table (flat, with
    the sentinels of invalid windows), and the count of valid ones."""
    from sharkmer_tpu_torch.io import native
    from sharkmer_tpu_torch.ops.encoding import canonical_kmers

    require(native.available(), "the native FASTQ reader did not build")
    with native.NativeFastqReader(FASTQ) as reader:
        codes, _ = reader.read_batch(HASH_READS)
    require(codes.shape[0] == HASH_READS,
            f"read {codes.shape[0]} of {HASH_READS} reads in one batch")
    kmers, valid = canonical_kmers(
        torch.from_numpy(np.ascontiguousarray(codes)).cuda(), K)
    return kmers.reshape(-1).contiguous(), int(valid.sum())


def table_rows(torch, slots):
    """A table's occupied (key, u32 count) rows in key order: what the
    mirror and the checkpoint read, whatever the slot layout."""
    from sharkmer_tpu_torch.kernels.hash import as_u32, slot_counts, slot_keys

    keys = slot_keys(slots).reshape(-1)
    occupied = keys != INT64_MAX
    sorted_keys, order = torch.sort(keys[occupied])
    return sorted_keys, as_u32(slot_counts(slots).reshape(-1)[occupied][order])


def same_rows(torch, name: str, got, want, what: str) -> tuple[int, int]:
    """Exact equality of two tables' rows, shard by shard, and of their
    claim counters with each other and with the occupied slots; (max
    abs count error, rows)."""
    (g_slots, g_claims), (w_slots, w_claims) = got, want
    n_shards = g_claims.numel()
    err, rows = 0, 0
    for shard, (g, w) in enumerate(zip(g_slots.view(n_shards, -1, 2),
                                       w_slots.view(n_shards, -1, 2))):
        gk, gc = table_rows(torch, g)
        wk, wc = table_rows(torch, w)
        require(torch.equal(gk, wk),
                f"{name}: shard {shard}'s keys differ from plain on {what}")
        err = max(err, int((gc - wc).abs().max()) if gc.numel() else 0)
        rows += gk.numel()
        require(int(g_claims[shard]) == int(w_claims[shard]) == gk.numel(),
                f"{name}: shard {shard} claimed {int(g_claims[shard])} slots "
                f"(plain {int(w_claims[shard])}) for {gk.numel()} keys on "
                f"{what}")
    require(err == 0, f"{name}: counts differ from plain on {what} "
            f"(max abs err {err})")
    return err, rows


def touched_sectors(torch, slots) -> dict:
    """The 32 B sectors that hold at least one key, which an insert
    reads and writes: of the 16 B slots (2 a sector); and, on the same
    occupied slots, of the two-array layout before it (int64 keys, 4 a
    sector; u32 counts, 8 a sector)."""
    from sharkmer_tpu_torch.kernels.hash import slot_keys

    slots_idx = torch.nonzero(slot_keys(slots).reshape(-1) != INT64_MAX)
    slots_idx = slots_idx.reshape(-1)
    return {"slot_sectors": torch.unique_consecutive(slots_idx >> 1).numel(),
            "key_sectors": torch.unique_consecutive(slots_idx >> 2).numel(),
            "count_sectors": torch.unique_consecutive(slots_idx >> 3).numel()}


def graph_ms(torch, launch, reps: int = 200) -> float:
    """ms of one kernel alone: ``reps`` back-to-back launches captured in
    one CUDA graph (no host work between them), the median of 5 replays
    over ``reps``. ``launch(stream)`` launches once on the stream."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(reps):
            launch(stream)
    graph.replay()
    torch.cuda.synchronize()
    times = [median_ms(torch, graph.replay, 1) / reps for _ in range(5)]
    del graph
    return statistics.median(times)


def hash_phase(torch, np, card: str, latency: dict) -> dict:
    """``hash_insert`` and ``hash_lookup`` against ``insert_plain`` and
    ``lookup_plain`` on the card, on one real ingest batch and the 16 B
    slot layout: the batch into a fresh 2^27-slot table, the batch again
    (all hits), the rehash of a 2^26-slot table holding it into 2^27
    slots, and the batch routed by owner into HASH_SHARDS shards of
    2^27 / HASH_SHARDS slots in one launch; directional lookups on the
    one table and on the shards, a LOOKUP_WAVE wave and LOOKUP_MANY
    queries, half of them random keys. The tables must hold equal rows
    shard by shard (the slot layouts may differ: the kernel's claims
    race) and claim counters equal to their occupied slots; lookups must
    be equal. Median CUDA-event ms, kernel timed between two plain runs;
    each insert on a fresh table reset outside the timed span. An
    insert's time includes the wait for its overflow flag (a few us).
    The wave is also timed as the kernel alone (``graph_ms``)."""
    from sharkmer_tpu_torch.kernels import hash as hk
    from sharkmer_tpu_torch.ops.histogram import revcomp

    kmers, n_valid = first_batch_kmers(torch, np)
    n = kmers.numel()

    def fresh(shape):
        n_counters = shape[0] if len(shape) == 2 else 1
        return (hk.new_slots(shape, "cuda"),
                torch.zeros(n_counters, dtype=torch.int64, device="cuda"))

    def reset(table):
        table[0][..., 0].fill_(INT64_MAX)
        table[0][..., 1].zero_()
        table[1].zero_()

    def timed(kernel, plain, reset_kernel=None, reset_plain=None, reps=10):
        plain_ms = median_ms(torch, plain, 1, reset_plain)
        ms = median_ms(torch, kernel, reps, reset_kernel)
        plain_ms = (plain_ms + median_ms(torch, plain, 1, reset_plain)) / 2
        return ms, plain_ms

    def insert_bytes(slots, n_entries, entry_bytes=8):
        """Each entry read once, each slot sector that holds a key read
        and written once; and the two-array layout's key and count
        sectors on the same slots."""
        sec = touched_sectors(torch, slots)
        return (entry_bytes * n_entries + 64 * sec["slot_sectors"],
                entry_bytes * n_entries
                + 64 * (sec["key_sectors"] + sec["count_sectors"]), sec)

    record = {}
    tables = {}
    for label, shape in (("1 table", (HASH_CAP,)),
                         (f"{HASH_SHARDS} shards",
                          (HASH_SHARDS, HASH_CAP // HASH_SHARDS))):
        kern, plain = fresh(shape), fresh(shape)
        what = (f"{HASH_READS} reads' {n} k-mers ({n_valid} valid) into "
                f"{label} of {HASH_CAP} slots")
        for rnd in ("fresh", "hits"):
            hk.hash_insert(*kern, kmers)
            hk.insert_plain(*plain, kmers)
            torch.cuda.synchronize()
            err, distinct = same_rows(torch, "hash_insert", kern, plain,
                                      f"{what}, {rnd}")
            total = int(hk.as_u32(hk.slot_counts(kern[0])).sum())
            rounds = 1 if rnd == "fresh" else 2
            require(total == rounds * n_valid,
                    f"hash_insert: n_total {total} != {rounds} x {n_valid}")
        new_bytes, old_bytes, sec = insert_bytes(kern[0], n)
        if label == "1 table":
            hits_ms, hits_plain_ms = timed(
                lambda: hk.hash_insert(*kern, kmers),
                lambda: hk.insert_plain(*plain, kmers))
        ms, plain_ms = timed(lambda: hk.hash_insert(*kern, kmers),
                             lambda: hk.insert_plain(*plain, kmers),
                             lambda: reset(kern), lambda: reset(plain))
        print(f"hash_insert: exact on {what}: {distinct} keys, claim "
              f"counters {kern[1].tolist()}, n_total {n_valid}; median "
              f"{ms:.4f} ms kernel vs {plain_ms:.4f} ms plain on {card}",
              flush=True)
        record[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": new_bytes / HBM_BYTES_PER_MS,
                         "two_array_bound_ms": old_bytes / HBM_BYTES_PER_MS,
                         "distinct": distinct, **sec}
        tables[label] = kern
        del plain
        torch.cuda.empty_cache()
    one = record["1 table"]
    # all hits: each slot sector that holds a key read and written once
    print(f"hash_insert: all hits {hits_ms:.4f} ms vs {hits_plain_ms:.4f} ms "
          f"plain on {card}", flush=True)
    insert = {**one, "library_ms": None,  # no torch op inserts into a table
              "bound_by": "bytes", "entries": n,
              "hits_ms": hits_ms, "hits_plain_ms": hits_plain_ms,
              "hits_bound_ms": one["bound_ms"],
              **{f"shards_{key}": value for key, value in
                 record[f"{HASH_SHARDS} shards"].items()}}

    # the rehash of a grow: a 2^26-slot table holding the batch into 2^27
    src = fresh((HASH_CAP // 2,))
    hk.hash_insert(*src, kmers)
    new_k, new_p = fresh((HASH_CAP,)), fresh((HASH_CAP,))
    hk.hash_insert(*new_k, src[0])
    hk.insert_plain(*new_p, src[0])
    torch.cuda.synchronize()
    same_rows(torch, "hash_insert", new_k, new_p, "the rehash")
    same_rows(torch, "hash_insert", new_k, src, "the rehash (source rows)")
    rehash_ms, rehash_plain_ms = timed(
        lambda: hk.hash_insert(*new_k, src[0]),
        lambda: hk.insert_plain(*new_p, src[0]),
        lambda: reset(new_k), lambda: reset(new_p), reps=5)
    # the source's 16 B slots read once; the new table's sectors as above
    rehash_bytes, rehash_old, _ = insert_bytes(new_k[0], src[0].shape[0], 16)
    print(f"hash_insert: exact on the rehash of {src[0].shape[0]} slots into "
          f"{HASH_CAP}; median {rehash_ms:.4f} ms kernel vs "
          f"{rehash_plain_ms:.4f} ms plain on {card}", flush=True)
    insert.update(rehash_ms=rehash_ms, rehash_plain_ms=rehash_plain_ms,
                  rehash_bound_ms=rehash_bytes / HBM_BYTES_PER_MS,
                  rehash_two_array_bound_ms=(
                      rehash_old - 4 * src[0].shape[0]) / HBM_BYTES_PER_MS)
    del src, new_k, new_p
    torch.cuda.empty_cache()

    # directional queries: half the batch's k-mers (half of those in
    # reverse-complement form), half random keys
    gen = torch.Generator(device="cuda").manual_seed(6)
    valid = kmers[kmers != INT64_MAX]
    lib = hk._lib()
    lookup = {}
    for label, (slots, _claims) in tables.items():
        prefix = "" if label == "1 table" else "shards_"
        for n_q in (LOOKUP_WAVE, LOOKUP_MANY):
            pick = valid[torch.randint(0, valid.numel(), (n_q // 2,),
                                       device="cuda", generator=gen)]
            pick[::2] = revcomp(pick[::2], K)
            absent = torch.randint(0, 1 << (2 * K), (n_q - n_q // 2,),
                                   device="cuda", generator=gen)
            q = torch.cat([pick, absent])
            result = compare(torch, "hash_lookup",
                             lambda: hk.hash_lookup(slots, q, K),
                             lambda: hk.lookup_plain(slots, q, K), 20, card,
                             f"{n_q} directional queries, half random, "
                             f"{label}")
            found = int((hk.hash_lookup(slots, q, K) != 0).sum())
            require(found >= n_q // 2,
                    f"hash_lookup: {found} of {n_q} found ({label})")
            require(torch.equal(hk.hash_lookup(slots, pick),
                                hk.lookup_plain(slots, pick)),
                    f"hash_lookup: canonical lookups differ ({label})")
            # query in, count out, a slot sector per query; the two-array
            # layout read a key sector per query and a count sector per hit
            size = "" if n_q == LOOKUP_WAVE else "many_"
            lookup[f"{prefix}{size}ms"] = result["ms"]
            lookup[f"{prefix}{size}plain_ms"] = result["plain_ms"]
            lookup[f"{prefix}{size}max_abs_err"] = result["max_abs_err"]
            lookup[f"{prefix}{size}bound_ms"] = (
                (12 * n_q + 32 * n_q) / HBM_BYTES_PER_MS)
            lookup[f"{prefix}{size}two_array_bound_ms"] = (
                (12 * n_q + 32 * n_q + 32 * found) / HBM_BYTES_PER_MS)
            lookup[f"{prefix}{size}found"] = found
            if n_q != LOOKUP_WAVE:
                continue
            out = torch.empty(n_q, dtype=torch.int32, device="cuda")
            n_shards, cap = hk._geometry(slots)

            def launch(stream):
                rc = lib.shk_hash_lookup(slots.data_ptr(), None, cap,
                                         n_shards, q.data_ptr(), n_q, K,
                                         out.data_ptr(), stream)
                require(rc == 0, f"hash_lookup: launch failed ({rc})")

            alone = graph_ms(torch, launch)
            require(torch.equal(out, hk.hash_lookup(slots, q, K)),
                    "hash_lookup: the graph's launches differ")
            lookup[f"{prefix}kernel_ms"] = alone
            print(f"hash_lookup: {n_q}-query wave, {label}: kernel alone "
                  f"{alone:.5f} ms (a CUDA graph of back-to-back launches) "
                  f"vs {result['ms']:.5f} ms through the wrapper on {card}",
                  flush=True)
    lookup.update(library_ms=None,  # no torch op probes a hash table
                  bound_by="bytes", queries=LOOKUP_WAVE,
                  # one dependent chain: the query (L2), its slot (DRAM);
                  # the two-array layout then loaded the count (DRAM)
                  latency_bound_ms=(latency["l2_ns"]
                                    + latency["dram_ns"]) / 1e6,
                  two_array_latency_bound_ms=(latency["l2_ns"]
                                              + 2 * latency["dram_ns"]) / 1e6)
    lookup["max_abs_err"] = max(v for key, v in lookup.items()
                                if key.endswith("max_abs_err"))
    del tables, kmers, valid
    torch.cuda.empty_cache()
    return {"hash_insert": insert, "hash_lookup": lookup}


def peer_latency(torch, launch, other) -> float:
    """ns per dependent load of a kernel on ``launch`` along a cold ring
    of 2^23 128 B lines (1 GB) on the card ``other``: each load crosses
    to the peer's DRAM (over NVLink on an H100 host). Median of three
    timed walks, as ``load_latency``'s DRAM walk."""
    from sharkmer_tpu_torch.kernels import peer

    peer.check_readable(launch, other)
    lib = chase_lib()
    n_lines, steps = 1 << 23, 1 << 16
    gen = torch.Generator(device=other).manual_seed(5)
    ring = 32 * torch.randperm(n_lines, device=other, generator=gen)
    nxt = torch.zeros(32 * n_lines, dtype=torch.int32, device=other)
    nxt[ring] = torch.roll(ring, -1).to(torch.int32)
    start = int(ring[0])
    del ring
    torch.cuda.synchronize(other)
    out = torch.empty(1, dtype=torch.int32, device=launch)
    times = []
    with torch.cuda.device(launch):
        stream = torch.cuda.current_stream().cuda_stream

        def walk():
            rc = lib.shk_chase(nxt.data_ptr(), start, steps, out.data_ptr(),
                               stream)
            require(rc == 0, f"chase: CUDA launch failed (cudaError {rc})")

        for _ in range(3):
            times.append(median_ms(torch, walk, 1))
            start = int(out[0])  # a fresh stretch of the ring each time
    del nxt
    torch.cuda.empty_cache()
    return statistics.median(times) * 1e6 / steps


def groups_phase(torch, np, card: str, latency: dict, devices,
                 tag: str) -> dict:
    """Phase 18's kernels on HASH_SHARDS owner shards placed on
    ``devices`` (``SHARKMER_TORCH_DEVICES``: shard ``s`` on ``devices[s *
    D // S]``, one group of contiguous shards a device, each group in its
    own allocation):

    * phase 8's batch into the groups as one windowed ``hash_insert`` a
      group (the batch copied to every group's device first, as
      ``ShardedKmerTable`` does), held shard by shard to the windowed
      ``insert_plain`` and to the one-launch routed insert into one
      ``[S, cap, 2]`` table on ``devices[0]``; the D launches timed
      together and one by one, beside the one launch;
    * ``hash_lookup`` through the groups' pointer table (one launch on
      ``devices[0]``) on a LOOKUP_WAVE wave and LOOKUP_MANY queries,
      against ``lookup_plain`` over the groups and the one-launch table;
      the wave also as the kernel alone (``graph_ms``);
    * phase 13's closures and warm-start probe over the closure table's
      owner shards on ``devices``, launched on ``devices[0]``.

    Times are CUDA events on ``devices[0]`` where every group is there,
    else the host clock around work that ends in a synchronize of every
    device. Returns the records, keyed by ``tag``."""
    from sharkmer_tpu_torch.device import shard_groups, synchronize
    from sharkmer_tpu_torch.kernels import hash as hk
    from sharkmer_tpu_torch.ops.histogram import revcomp

    launch = devices[0]
    one_card = len(set(devices)) == 1

    def timed_ms(fn, reps, reset=None):
        if one_card:
            with torch.cuda.device(launch):
                return median_ms(torch, fn, reps, reset)
        times = []
        for _ in range(reps):
            if reset is not None:
                reset()
            synchronize(*devices)
            start = time.perf_counter()
            fn()
            synchronize(*devices)
            times.append((time.perf_counter() - start) * 1e3)
        return statistics.median(times)

    kmers, n_valid = first_batch_kmers(torch, np)
    kmers = kmers.to(launch)
    n, S, cap = kmers.numel(), HASH_SHARDS, HASH_CAP // HASH_SHARDS
    groups = shard_groups(S, len(devices))
    batches = [kmers.to(dev) for dev in devices]

    def fresh():
        return ([hk.new_slots((hi - lo, cap), dev)
                 for (lo, hi), dev in zip(groups, devices)],
                [torch.zeros(hi - lo, dtype=torch.int64, device=dev)
                 for (lo, hi), dev in zip(groups, devices)])

    def reset(table):
        for slots, claims in zip(*table):
            slots[..., 0].fill_(INT64_MAX)
            slots[..., 1].zero_()
            claims.zero_()

    def insert(table, fn, only=None):
        for d, ((lo, _), slots, claims, batch) in enumerate(
                zip(groups, *table, batches)):
            if only is None or d == only:
                fn(slots, claims, batch, shard_lo=lo, n_shards=S)

    kern, plain = fresh(), fresh()
    one = ([hk.new_slots((S, cap), launch)],
           [torch.zeros(S, dtype=torch.int64, device=launch)])
    insert(kern, hk.hash_insert)
    insert(plain, hk.insert_plain)
    hk.hash_insert(one[0][0], one[1][0], kmers)
    synchronize(*devices)
    what = (f"{HASH_READS} reads' {n} k-mers ({n_valid} valid) into {S} "
            f"shards of {cap} slots in {len(groups)} groups on "
            f"{','.join(map(str, devices))}")
    err, distinct = 0, 0
    # the bytes each card must move: the input batch read once where it
    # lies, and each slot sector that holds a key read and written once
    card_bytes = {launch: 8 * n}
    for d, ((lo, hi), dev) in enumerate(zip(groups, devices)):
        got = (kern[0][d], kern[1][d])
        e, rows = same_rows(torch, "hash_insert", got,
                            (plain[0][d], plain[1][d]), f"{what}, group {d}")
        same_rows(torch, "hash_insert", got,
                  (one[0][0][lo:hi].to(dev), one[1][0][lo:hi].to(dev)),
                  f"{what}, group {d} against the one-launch table")
        err, distinct = max(err, e), distinct + rows
        card_bytes[dev] = card_bytes.get(dev, 0) + 64 * touched_sectors(
            torch, kern[0][d])["slot_sectors"]
    total = sum(int(hk.as_u32(hk.slot_counts(g)).sum()) for g in kern[0])
    require(total == n_valid, f"hash_insert: n_total {total} != {n_valid}")
    one_sectors = touched_sectors(torch, one[0][0])["slot_sectors"]
    plain_ms = timed_ms(lambda: insert(plain, hk.insert_plain), 1,
                        lambda: reset(plain))
    one_ms = timed_ms(lambda: hk.hash_insert(one[0][0], one[1][0], kmers),
                      10, lambda: reset(one))
    ms = timed_ms(lambda: insert(kern, hk.hash_insert), 10,
                  lambda: reset(kern))
    each = [timed_ms(lambda d=d: insert(kern, hk.hash_insert, d), 10,
                     lambda: reset(kern)) for d in range(len(groups))]
    ms = (ms + timed_ms(lambda: insert(kern, hk.hash_insert), 10,
                        lambda: reset(kern))) / 2
    one_ms = (one_ms + timed_ms(
        lambda: hk.hash_insert(one[0][0], one[1][0], kmers), 10,
        lambda: reset(one))) / 2
    plain_ms = (plain_ms + timed_ms(lambda: insert(plain, hk.insert_plain), 1,
                                    lambda: reset(plain))) / 2
    print(f"hash_insert: exact on {what}: {distinct} keys, claim counters "
          f"{[c.tolist() for c in kern[1]]}; median {ms:.4f} ms for "
          f"{len(groups)} windowed launches "
          f"({', '.join(f'{t:.4f}' for t in each)} ms each) vs "
          f"{one_ms:.4f} ms one routed launch vs {plain_ms:.4f} ms plain "
          f"on {card}", flush=True)
    # the bound: the busiest card's bytes (the cards' memories work in
    # parallel). Each windowed launch reads the whole batch: the D - 1
    # reads past the first are the design's overhead, kept apart as
    # window_reads_ms (their bytes at the memory rate)
    insert_rec = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                  "bound_ms": max(card_bytes.values()) / HBM_BYTES_PER_MS,
                  "window_reads_ms": 8 * n * (len(groups) - 1)
                  / HBM_BYTES_PER_MS,
                  "launch_ms": each, "one_launch_ms": one_ms,
                  "one_launch_bound_ms": (8 * n + 64 * one_sectors)
                  / HBM_BYTES_PER_MS, "launches_a_batch": len(groups)}
    del plain
    torch.cuda.empty_cache()

    gen = torch.Generator(device=launch).manual_seed(6)
    valid = kmers[kmers != INT64_MAX]
    pointers = hk.slot_pointers(kern[0], launch)
    lib = hk._lib()
    lookup_rec = {}
    for n_q in (LOOKUP_WAVE, LOOKUP_MANY):
        pick = valid[torch.randint(0, valid.numel(), (n_q // 2,),
                                   device=launch, generator=gen)]
        pick[::2] = revcomp(pick[::2], K)
        absent = torch.randint(0, 1 << (2 * K), (n_q - n_q // 2,),
                               device=launch, generator=gen)
        q = torch.cat([pick, absent])
        with torch.cuda.device(launch):
            result = compare(
                torch, "hash_lookup",
                lambda: hk.hash_lookup(kern[0], q, K, pointers),
                lambda: hk.lookup_plain(kern[0], q, K), 20, card,
                f"{n_q} directional queries, half random, through the "
                f"pointer table of {S} shards on "
                f"{','.join(map(str, devices))}")
        got = hk.hash_lookup(kern[0], q, K, pointers)
        require(torch.equal(got, hk.hash_lookup(one[0][0], q, K)),
                "hash_lookup: the pointer table differs from the one-launch "
                "table")
        found = int((got != 0).sum())
        require(found >= n_q // 2, f"hash_lookup: {found} of {n_q} found")
        size = "" if n_q == LOOKUP_WAVE else "many_"
        lookup_rec.update({
            f"{size}ms": result["ms"], f"{size}plain_ms": result["plain_ms"],
            f"{size}max_abs_err": result["max_abs_err"],
            # query in, count out, a slot sector a query, the pointer table
            f"{size}bound_ms": (12 * n_q + 32 * n_q + 8 * S)
            / HBM_BYTES_PER_MS})
        if n_q != LOOKUP_WAVE:
            continue
        out = torch.empty(n_q, dtype=torch.int32, device=launch)

        def launch_wave(stream):
            rc = lib.shk_hash_lookup(None, pointers.data_ptr(), cap, S,
                                     q.data_ptr(), n_q, K, out.data_ptr(),
                                     stream)
            require(rc == 0, f"hash_lookup: launch failed ({rc})")

        with torch.cuda.device(launch):
            alone = graph_ms(torch, launch_wave)
        require(torch.equal(out, got), "hash_lookup: the graph's launches "
                "differ")
        lookup_rec["kernel_ms"] = alone
        print(f"hash_lookup: {n_q}-query wave through the pointer table: "
              f"kernel alone {alone:.5f} ms (a CUDA graph of back-to-back "
              f"launches) on {card}", flush=True)
    lookup_rec["max_abs_err"] = max(lookup_rec["max_abs_err"],
                                    lookup_rec["many_max_abs_err"])
    del kern, one, batches, kmers, valid, pointers
    torch.cuda.empty_cache()

    closures = closure_phase(torch, np, card, latency, {
        tag: lambda keys, counts, n_real: shard_table(
            torch, keys, counts, n_real, CLOSURE_SHARDS, K, devices)})
    return {f"hash_insert, {tag}": insert_rec,
            f"hash_lookup, {tag}": lookup_rec, **closures}


def check_hash_run(runs, label: str, n_groups: int) -> None:
    """A hash run touches none of the sorted store's kernels, and
    launches hash_insert once per insert, merge and grow of a hash table
    and device group (one routed launch on the shards of a group, not one
    a shard) and hash_lookup once per lookup wave (one launch, through
    the groups' pointer table where there are groups)."""
    counts = runs[label][0]
    for name in ("run_ends", "run_starts", "probe_rows", "stitch_rows",
                 "reach_closure"):
        require(counts[name] == 0, f"{name} was launched in the {label} run")
    require(counts["hash_insert"] == n_groups * counts["table_calls"] >= 1,
            f"{label}: {counts['hash_insert']} hash_insert launches for "
            f"{counts['table_calls']} inserts, merges and grows of "
            f"{n_groups} group(s)")
    require(counts["hash_lookup"] == counts["lookup_waves"],
            f"{label}: {counts['hash_lookup']} hash_lookup launches for "
            f"{counts['lookup_waves']} lookup waves")


def check_closure_run(runs, label: str) -> None:
    """A reach run launches reach_closure at least once a closure call,
    and probe_rows (the warm starts) no more often than that."""
    counts = runs[label][0]
    calls = counts["closure_calls"]
    require(counts["probe_rows"] <= calls <= counts["reach_closure"]
            and counts["reach_closure"] >= 1,
            f"{label}: {counts['probe_rows']} probe_rows and "
            f"{counts['reach_closure']} reach_closure launches for {calls} "
            f"closure calls")


def check_group_runs(runs, tag: str, n_groups: int) -> None:
    """Phase 18's runs of one placement (``placement_phase``): the sorted
    run launches run_starts and the closures; the hash runs as
    ``check_hash_run`` with ``n_groups`` launches an insert, a lookup a
    wave (``--mirror device``: no host mirror), the load into a sharded
    hash table exported once for its host mirror."""
    sorted_run = runs[f"{tag}_sorted"][0]
    require(sorted_run["run_starts"] >= 1 and not sorted_run["hash_insert"],
            f"{tag}_sorted: run_starts {sorted_run['run_starts']}, "
            f"hash_insert {sorted_run['hash_insert']}")
    check_closure_run(runs, f"{tag}_sorted")
    device_run = runs[f"{tag}_hash_device"][0]
    require(device_run["hash_lookup"] >= 1 and not (
        device_run["hash_exports"] or device_run["shard_exports"]),
        f"{tag}_hash_device: {device_run['hash_lookup']} lookups, host "
        f"mirror exports {device_run['shard_exports']}")
    check_hash_run(runs, f"{tag}_hash_device", n_groups)
    if f"{tag}_load" in runs:
        check_hash_run(runs, f"{tag}_load", n_groups)
        load = runs[f"{tag}_load"][0]
        require((load["hash_exports"], load["shard_exports"]) == (0, 1),
                f"{tag}_load: exports {load['hash_exports']} / "
                f"{load['shard_exports']}, not 0 / 1")


def peer_latencies(torch, cards, card: str, latency: dict) -> dict:
    """``peer_latency`` from ``cards[0]`` into each other card, printed
    beside the card's own DRAM latency."""
    peer_ns = {other: peer_latency(torch, cards[0], other)
               for other in cards[1:]}
    print(f"dependent-load latency from {cards[0]} into a peer's DRAM: "
          f"{peer_ns} ns, against {latency['dram_ns']:.1f} ns from its own "
          f"DRAM on {card}", flush=True)
    return peer_ns


def placement_phase(ctx, np, card: str, latency: dict, tag: str, devices,
                    record: dict, runs: dict, load: bool = True) -> str:
    """Phase 18 on one placement, ``devices`` (names, one a shard group):
    ``groups_phase``, then the 1M cell with ``--n-shards`` N_SHARDS under
    ``SHARKMER_TORCH_DEVICES``: sorted, hash ``--mirror device`` and,
    with ``load``, ``--load-table`` of phase 9's checkpoint (runs
    ``<tag>_sorted``, ``<tag>_hash_device``, ``<tag>_load``). Returns the
    records' label."""
    torch = ctx.torch
    label = f"{len(devices)} groups on {len(set(devices))} card(s)"
    record.update(groups_phase(torch, np, card, latency,
                               [torch.device(d) for d in devices], label))
    os.environ[DEVICES_ENV] = ",".join(devices)
    try:
        runs[f"{tag}_sorted"] = drive_main_path(
            ctx, f"{tag}_sorted", 1_000_000, ("--n-shards", N_SHARDS))
        runs[f"{tag}_hash_device"] = drive_main_path(
            ctx, f"{tag}_hash_device", 1_000_000,
            ("--n-shards", N_SHARDS, "--backend", "hash", "--mirror",
             "device"))
        if load:
            runs[f"{tag}_load"] = drive_main_path(
                ctx, f"{tag}_load", 1_000_000,
                ("--load-table", CHECKPOINT, "--n-shards", N_SHARDS),
                fastq=False)
    finally:
        del os.environ[DEVICES_ENV]
    return label


def closure_times(torch, np, card: str) -> int:
    """``--closure-times``: phase 3's and 13's closure and probe calls,
    the kernels alone, ending in ``RESULT <JSON>``."""
    from sharkmer_tpu_torch.kernels import build

    build.build_all(["reach_closure", "probe_rows", "chase"])
    latency = load_latency(torch)
    record = closure_phase(torch, np, card, latency,
                           {**key_range_layouts(torch),
                            **owner_layouts(torch)}, plain=False)
    print(f"card: {card}")
    print("RESULT " + json.dumps(record), flush=True)
    return 0


def tools_phase() -> None:
    """Phase 20: ``tools/run_grid.py`` on the metazoa 1M cell (its cell
    held to the committed one; a new result YAML and report), then
    ``tools/bench.py --quick`` (every gene of its panel recovered); each
    a subprocess on the card."""
    results = os.path.join(HERE, "build", "grid", "results")
    before = set(os.listdir(results)) if os.path.isdir(results) else set()
    start = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "sharkmer_tpu_torch.tools.run_grid",
         "--panel", "metazoa", "--max-reads", str(M)],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    print(proc.stdout, end="")
    require(proc.returncode == 0,
            f"run_grid exited {proc.returncode}: {proc.stderr[-3000:]}")
    print(f"run_grid: {time.monotonic() - start:.1f} s", flush=True)
    check_outputs("run_grid metazoa 1M",
                  os.path.join(HERE, "build", "grid", "work", "metazoa",
                               "synthetic-seed2", str(M)),
                  oracle_of("metazoa", M), f"synthetic-seed2_{M}")
    new = sorted(set(os.listdir(results)) - before)
    require(any(n.startswith("metazoa_") and n.endswith(".yaml") for n in new)
            and any(n.startswith("metazoa_") and n.endswith(".md")
                    for n in new),
            f"run_grid wrote no result YAML and report: {new}")
    print(f"run_grid: new in build/grid/results: {new}")

    start = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "sharkmer_tpu_torch.tools.bench", "--quick"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0,
            f"bench exited {proc.returncode}: {proc.stderr[-3000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    bench = json.loads(line)
    ok, n_genes = bench["spcr_genes_ok"].split("/")
    require(ok == n_genes and int(n_genes) > 0,
            f"bench --quick recovered {bench['spcr_genes_ok']} genes")
    print(f"bench --quick ({time.monotonic() - start:.1f} s): {line}",
          flush=True)


def main() -> int:
    require(os.path.isdir(os.path.join(HERE, "sharkmer_tpu_torch")),
            f"no sharkmer_tpu_torch package beside {__file__}")
    import torch

    require(torch.cuda.is_available(), "torch sees no CUDA device")
    args = sys.argv[1:]
    require(args in ([], ["--closure-times"]),
            f"unknown arguments {args}: none, or --closure-times")
    sys.path.insert(0, HERE)
    import numpy as np

    from sharkmer_tpu_torch.device import shard_devices
    from sharkmer_tpu_torch.io import native
    from sharkmer_tpu_torch.kernels import build, closure, probe, run_scan, stitch
    from sharkmer_tpu_torch.kernels import hash as hash_kernels

    t_start = time.monotonic()
    phase("1. card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s); using {kind}", flush=True)
    # one child process a missing FASTQ, all at once
    synth = {} if args else {
        panel: subprocess.Popen([
            sys.executable, "-c",
            "import sys; from sharkmer_tpu_torch.tools.synth import "
            "synthesize_panel_fastq as s; s(sys.argv[1], sys.argv[2], "
            "n_reads=int(sys.argv[3]), seed=int(sys.argv[4]))",
            PANELS[panel], FASTQS[panel], str(N_READS_MAX), str(seed),
        ], cwd=HERE)
        for panel, seed in SEEDS.items() if not os.path.exists(FASTQS[panel])}

    def wait_fastq(panel: str) -> None:
        start = time.monotonic()
        child = synth.pop(panel, None)
        require(child is None or child.wait() == 0,
                f"the {panel} FASTQ synthesis failed")
        print(f"FASTQ {os.path.relpath(FASTQS[panel], HERE)} ready "
              f"({time.monotonic() - start:.2f} s waited)", flush=True)

    try:
        if args:
            return closure_times(torch, np, card)
        phase("2. build")
        start = time.monotonic()
        sources = sorted({os.path.basename(src)[:-3]
                          for src, _ in KERNELS.values()} | {"chase", "peer"})
        build.build_all(sources)
        print(f"nvcc build and load of {', '.join(sources)}: "
              f"{time.monotonic() - start:.2f} s")
        start = time.monotonic()
        reader = "native C++" if native.available() else "pure Python"
        print(f"FASTQ reader: {reader} ({time.monotonic() - start:.2f} s)",
              flush=True)
        kernels = {"run_ends": run_scan.run_ends,
                   "run_starts": run_scan.run_starts,
                   "probe_rows": probe.probe_rows,
                   "stitch_rows": stitch.stitch_rows,
                   "reach_closure": closure.reach_closure,
                   "hash_insert": hash_kernels.hash_insert,
                   "hash_lookup": hash_kernels.hash_lookup}

        phase("3. kernels vs plain PyTorch at the main path's shapes")
        latency = load_latency(torch)
        print(f"dependent-load latency: {latency['l2_ns']:.1f} ns through "
              f"L2, {latency['dram_ns']:.1f} ns from DRAM on {card}",
              flush=True)
        record = kernel_phase(torch, np, card, kernels)
        record.update(closure_phase(torch, np, card, latency,
                                    key_range_layouts(torch)))

        phase("4. main path: 1M reads, cnidaria panel, default drain budget")
        wait_fastq("cnidaria")
        os.makedirs(OUT_DIR, exist_ok=True)
        ctx = instrument(torch, kernels)
        os.environ.pop("SHARKMER_MAX_AGG", None)
        os.environ["SHARKMER_TORCH_DEVICE"] = "cuda"
        # -vv: _drive_closure's debug line of each closure call
        runs = {"default": drive_main_path(ctx, "default", 1_000_000,
                                           ("-vv",))}
        group_labels = {}  # phase 18's placements: tag -> record label

        phase("5. main path again with SHARKMER_MAX_AGG=2^24")
        os.environ["SHARKMER_MAX_AGG"] = str(1 << 24)
        try:
            runs["max_agg_2^24"] = drive_main_path(ctx, "max_agg_2^24",
                                                   1_000_000)
        finally:
            del os.environ["SHARKMER_MAX_AGG"]

        phase("6. default cell with --mirror full (sPCR on the host mirror)")
        runs["mirror_full"] = drive_main_path(
            ctx, "mirror_full", 1_000_000, ("--mirror", "full"))
        print(f"sPCR wall: {spcr_wall(runs['default'][1]):.3f} s with the "
              f"device reach closure (phase 4) vs "
              f"{spcr_wall(runs['mirror_full'][1]):.3f} s on the host "
              f"mirror (phase 6)", flush=True)

        phase("7. main path: 4M reads, default drain budget")
        runs["4M"] = drive_main_path(ctx, "4M", 4_000_000)

        phase("8. hash kernels vs plain PyTorch on one ingest batch")
        record.update(hash_phase(torch, np, card, latency))

        phase("9. main path: 1M reads, --backend hash (host mirror), "
              "--save-table")
        if os.path.exists(CHECKPOINT):
            os.remove(CHECKPOINT)
        runs["hash"] = drive_main_path(
            ctx, "hash", 1_000_000,
            ("--backend", "hash", "--save-table", CHECKPOINT))
        require(os.path.exists(CHECKPOINT), f"no checkpoint at {CHECKPOINT}")
        print(f"checkpoint {os.path.relpath(CHECKPOINT, HERE)}: "
              f"{os.path.getsize(CHECKPOINT)} bytes")
        print(f"sPCR wall: {spcr_wall(runs['hash'][1]):.3f} s on the hash "
              f"table's host mirror (phase 9) vs "
              f"{spcr_wall(runs['default'][1]):.3f} s on the sorted store's "
              f"reach closure (phase 4)", flush=True)

        phase("10. main path: 1M reads, --backend hash --mirror device")
        runs["hash_device"] = drive_main_path(
            ctx, "hash_device", 1_000_000,
            ("--backend", "hash", "--mirror", "device"))

        phase("11. --load-table of phase 9's checkpoint, no FASTQ: "
              "sorted backend (reach), then hash backend")
        runs["load_sorted"] = drive_main_path(
            ctx, "load_sorted", 1_000_000, ("--load-table", CHECKPOINT),
            fastq=False)
        runs["load_hash"] = drive_main_path(
            ctx, "load_hash", 1_000_000,
            ("--load-table", CHECKPOINT, "--backend", "hash"), fastq=False)

        phase("12. main path: 4M reads, --backend hash")
        runs["hash_4M"] = drive_main_path(ctx, "hash_4M", 4_000_000,
                                          ("--backend", "hash"))

        phase(f"13. owner-routed reach_closure and probe_rows vs plain "
              f"PyTorch on {CLOSURE_SHARDS} shards")
        record.update(closure_phase(torch, np, card, latency,
                                    owner_layouts(torch)))

        phase(f"14. main path: 1M reads, --n-shards {N_SHARDS} (sorted, "
              f"reach closure)")
        runs["shards"] = drive_main_path(ctx, "shards", 1_000_000,
                                         ("--n-shards", N_SHARDS))
        print(f"sPCR wall: {spcr_wall(runs['shards'][1]):.3f} s on "
              f"{N_SHARDS} shards (phase 14) vs "
              f"{spcr_wall(runs['default'][1]):.3f} s on the single store "
              f"(phase 4)", flush=True)

        phase(f"15. main path: 1M reads, --n-shards {N_SHARDS} --backend hash "
              f"(host mirror, then --mirror device)")
        runs["shards_hash"] = drive_main_path(
            ctx, "shards_hash", 1_000_000,
            ("--n-shards", N_SHARDS, "--backend", "hash"))
        runs["shards_hash_device"] = drive_main_path(
            ctx, "shards_hash_device", 1_000_000,
            ("--n-shards", N_SHARDS, "--backend", "hash", "--mirror",
             "device"))

        phase(f"16. --load-table of phase 9's checkpoint with --n-shards "
              f"{N_SHARDS} (a ShardedKmerTable)")
        runs["shards_load"] = drive_main_path(
            ctx, "shards_load", 1_000_000,
            ("--load-table", CHECKPOINT, "--n-shards", N_SHARDS), fastq=False)

        phase(f"17. chunked spectra: {CHUNK_READS} reads, --chunks 10, both "
              f"backends at --n-shards 1 and {N_SHARDS}")
        for backend in ("sorted", "hash"):
            for shards in ("1", N_SHARDS):
                label = f"chunks_{backend}_{shards}"
                runs[label] = drive_main_path(
                    ctx, label, CHUNK_READS,
                    ("--chunks", "10", "--backend", backend,
                     "--n-shards", shards),
                    oracle=CHUNK_ORACLE)

        phase(f"18. shard groups: {DEVICES_ENV}={','.join(ONE_CARD_GROUPS)}")
        n_cards = torch.cuda.device_count()
        cards = [f"cuda:{i}" for i in range(min(int(N_SHARDS), n_cards))]
        placements = {"groups": ONE_CARD_GROUPS}
        if n_cards >= 2:
            placements["cards"] = cards
        for tag, devices in placements.items():
            if tag == "cards":
                phase(f"18b. shard groups on {len(cards)} cards: "
                      f"{DEVICES_ENV}={','.join(cards)}")
                record["peer_dram_ns"] = peer_latencies(torch, cards, card,
                                                        latency)
            group_labels[tag] = (placement_phase(ctx, np, card, latency, tag,
                                                 devices, record, runs),
                                 len(devices))
        if "cards" not in placements:
            print("phase 18: the cross-card part did not run: only one card "
                  "is visible", flush=True)

        phase("19. the offline grid: the 7 committed cells not run above "
              "(sorted, --mirror auto), then --backend hash")
        for panel in SEEDS:
            wait_fastq(panel)
        for panel, n_reads in GRID_SORTED:
            torch.cuda.empty_cache()  # the last run's cached blocks
            label = f"grid_{panel}_{n_reads // M}M"
            runs[label] = drive_main_path(ctx, label, n_reads, ("-vv",),
                                          panel=panel)
        for panel, n_reads in GRID_HASH:
            torch.cuda.empty_cache()
            label = f"grid_hash_{panel}_{n_reads // M}M"
            runs[label] = drive_main_path(ctx, label, n_reads,
                                          ("--backend", "hash"), panel=panel)

        phase("20. the tools: run_grid on the metazoa 1M cell, bench --quick")
        tools_phase()
    finally:
        for child in synth.values():
            child.kill()
            child.wait()

    chunked_sorted = ("chunks_sorted_1", f"chunks_sorted_{N_SHARDS}")
    chunked_hash = ("chunks_hash_1", f"chunks_hash_{N_SHARDS}")
    required = {"run_ends": ("default", "max_agg_2^24"),
                "run_starts": ("default", "max_agg_2^24", "shards",
                               *chunked_sorted),
                "probe_rows": ("default", "max_agg_2^24"),
                "stitch_rows": ("max_agg_2^24", "4M"),
                "reach_closure": ("default", "max_agg_2^24", "4M",
                                  "load_sorted", "shards", *chunked_sorted),
                "hash_insert": ("hash", "load_hash", "hash_4M",
                                "shards_hash", "shards_hash_device",
                                "shards_load", *chunked_hash),
                "hash_lookup": ("hash_device", "shards_hash_device")}
    for name, labels in required.items():
        for label in labels:
            require(runs[label][0][name] >= 1,
                    f"{name} was not launched in the {label} run")
    # phases 14-17 place their N_SHARDS shards by default: one group on
    # one card, a group a card on the first min(N_SHARDS, cards) cards
    default_groups = len(shard_devices(int(N_SHARDS), "cuda"))
    for label in ("hash", "hash_device", "load_hash", "hash_4M",
                  "chunks_hash_1"):
        check_hash_run(runs, label, 1)
    for label in ("shards_hash", "shards_hash_device", "shards_load",
                  f"chunks_hash_{N_SHARDS}"):
        check_hash_run(runs, label, default_groups)
    # KmerTable.to_sorted_arrays (ShardedKmerTable's with --n-shards): the
    # host mirror once under --mirror auto (phase 9 also exports the
    # checkpoint), never under device; --load-table with --n-shards loads
    # into a ShardedKmerTable, whatever --backend says
    for label, exports, shard_exports in (
            ("hash", 2, 0), ("hash_device", 0, 0), ("load_hash", 1, 0),
            ("hash_4M", 1, 0), ("shards_hash", 0, 1),
            ("shards_hash_device", 0, 0), ("shards_load", 0, 1),
            ("chunks_hash_1", 1, 0), (f"chunks_hash_{N_SHARDS}", 0, 1)):
        got = (runs[label][0]["hash_exports"],
               runs[label][0]["shard_exports"])
        require(got == (exports, shard_exports),
                f"{label}: KmerTable and ShardedKmerTable.to_sorted_arrays "
                f"ran {got} times, not {(exports, shard_exports)}")
    for label in required["reach_closure"]:
        check_closure_run(runs, label)
    # phase 19: a ghosted first drain in every sorted run, drain v2 past
    # 1M reads, the reach closure in each; the hash runs as phase 12
    for panel, n_reads in GRID_SORTED:
        label = f"grid_{panel}_{n_reads // M}M"
        counts = runs[label][0]
        need = ("run_ends",) + (("run_starts", "stitch_rows")
                                if n_reads > M else ())
        for name in need:
            require(counts[name] >= 1,
                    f"{name} was not launched in the {label} run")
        require(not counts["hash_insert"],
                f"hash_insert was launched in the {label} run")
        check_closure_run(runs, label)
    for panel, n_reads in GRID_HASH:
        label = f"grid_hash_{panel}_{n_reads // M}M"
        check_hash_run(runs, label, 1)
        got = (runs[label][0]["hash_exports"], runs[label][0]["shard_exports"])
        require(got == (1, 0), f"{label}: KmerTable and ShardedKmerTable."
                f"to_sorted_arrays ran {got} times, not (1, 0)")
    for tag, (_, n_groups) in group_labels.items():
        check_group_runs(runs, tag, n_groups)

    parts = f"{CLOSURE_PARTS} partitions"
    shards = f"{CLOSURE_SHARDS} shards"
    records = []
    for name, (source, replaces) in KERNELS.items():
        if name == "probe_rows":
            # a warm start's keys over CLOSURE_PARTS; on one partition and
            # owner-routed over CLOSURE_SHARDS beside it
            one = record["probe_rows, 1 partition"]
            owned = record[f"probe_rows, {shards}"]
            rec = dict(record[f"probe_rows, {parts}"], **latency,
                       one_part_ms=one["ms"], one_part_plain_ms=one["plain_ms"],
                       shards_ms=owned["ms"], shards_plain_ms=owned["plain_ms"],
                       shards_bound_ms=owned["bound_ms"],
                       shards_max_abs_err=owned["max_abs_err"])
            # 4096 keys of the 256-row-bucket table, on each layout
            for layout in ("1 partition", parts, shards):
                wide = record[f"probe_rows wide bucket, {layout}"]
                rec.update({f"wide_bucket_{layout.split()[0]}_{key}":
                            wide[key] for key in ("ms", "plain_ms", "bound_ms",
                                                  "max_abs_err")})
            rec["max_abs_err"] = max(
                value["max_abs_err"] for label, value in record.items()
                if label.startswith("probe_rows"))
        elif name == "reach_closure":
            # a narrow call on one partition; on CLOSURE_PARTS, a wide
            # call, and owner-routed calls over CLOSURE_SHARDS beside it
            narrow = record[f"narrow, {parts}"]
            rec = dict(record["narrow, 1 partition"], **latency,
                       parts_ms=narrow["ms"], parts_plain_ms=narrow["plain_ms"],
                       parts_bound_ms=narrow["bound_ms"],
                       parts_latency_bound_ms=narrow["latency_bound_ms"])
            # the wide, retry-shape (frontiers in shared memory; in global
            # scratch at the third retry's) and 256-row-bucket calls on
            # one partition
            for call in ("wide", "retry", "retry global", "wide bucket"):
                one = record[f"{call}, 1 partition"]
                rec.update({f"{call.replace(' ', '_')}_{key}": one[key]
                            for key in ("ms", "plain_ms", "bound_ms",
                                        "latency_bound_ms", "max_abs_err")})
            for call in ("narrow", "wide", "pre", "retry", "retry global",
                         "wide bucket"):
                owned = record[f"{call}, {shards}"]
                rec.update({f"shards_{call.replace(' ', '_')}_{key}":
                            owned[key] for key in (
                                "ms", "plain_ms", "bound_ms",
                                "latency_bound_ms", "max_abs_err", "n_vis",
                                "iters")})
            rec["max_abs_err"] = max(
                value["max_abs_err"] for label, value in record.items()
                if label.split(",")[0] in ("narrow", "wide", "pre", "retry",
                                           "retry global", "overflow",
                                           "wide bucket"))
        else:
            rec = record[name]
        # phase 18: the same kernel on the shards of each placement
        for tag, (label, _) in group_labels.items():
            if name in ("hash_insert", "hash_lookup"):
                rec.update({f"{tag}_{key}": value for key, value in
                            record[f"{name}, {label}"].items()})
            elif name == "probe_rows":
                rec.update({f"{tag}_{key}": record[f"probe_rows, {label}"][key]
                            for key in ("ms", "plain_ms", "bound_ms",
                                        "max_abs_err")})
            elif name == "reach_closure":
                for call in ("narrow", "wide", "pre", "retry",
                             "retry global"):
                    owned = record[f"{call}, {label}"]
                    call = call.replace(" ", "_")
                    rec.update({f"{tag}_{call}_{key}": owned[key] for key in (
                        "ms", "plain_ms", "bound_ms", "latency_bound_ms",
                        "max_abs_err", "n_vis", "iters")})
                    if tag == "cards":
                        # every level's probe chain ending in a peer's DRAM
                        peer_ns = max(record["peer_dram_ns"].values())
                        rec[f"cards_{call}_remote_latency_bound_ms"] = (
                            owned["latency_levels"]
                            * (2 * latency["l2_ns"] + peer_ns) / 1e6)
                if tag == "cards":
                    rec["peer_dram_ns"] = record["peer_dram_ns"]
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(counts[name] for counts, _ in runs.values()),
            **rec,
        })
    print(f"chip_smoke wall: {time.monotonic() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
