#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sharkmer_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --closure-times`` runs only phase 3's and 13's
closure and probe calls, the kernels alone (no plain version, no
comparison; ``probe_rows`` also its device time alone), and ends with a
line ``RESULT <JSON>`` of their median times: run it from two trees in
turns to compare their kernels in one call. ``python3 chip_smoke.py
--chunked`` runs phases 1, 2 and 22 alone (the cnidaria FASTQ, the
build, the chunked spectra at depth); ``--chunked-cards`` runs only
phase 22's four-card run and its reference, on four cards or on the
shard groups that ``SHARKMER_TORCH_DEVICES`` lists (the code path of
four cards on one: ``cuda:0,cuda:0,cuda:0,cuda:0``). ``--long-k`` runs
phases 1, 2 and 23 alone (k=31); ``--entries`` phases 1, 2, phase 4's
run and phase 24 (the record-stream entries); ``--panels`` phases 1, 2
and 25 (the built-in panels); ``--options`` phases 1, 2 and 26 (the
options no other phase runs); ``--profiles`` phases 1, 2 and 21 (the
profilers, which the whole script no longer runs); ``--ingest`` phases
1, 2 and 27 (the fused sharded ingest steps; the way to run phase 27's
four-card placement, on four cards); ``--waves`` phases 1,
2 and the lookup wave path's checks (``wave_checks``, ``late_wave``) on
tables of random keys, with the wave's times at 4^0 to 4^10 queries
(``wave_times``).

Phases, each printed on its own lines; every check raises on failure:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   the 8M-read synthetic FASTQ of each panel of the offline grid
   (``benchmarks/benchmark_offline.yaml``: cnidaria, hydrozoa and
   metazoa, seeds 0, 1 and 2) starts generating in a child process of
   its own (``tools/synth.py``); cnidaria's is ready by phase 4, whose
   runs read its first N reads (``-m``: ``synth.py`` writes 250k-read
   slabs, so they are the reads of the JAX package's cells), the other
   two by phase 19; phase 25's start at phase 4 (insecta's 8M reads,
   seed 7; 1M reads of angiospermae, bacteria, c_elegans, human and
   teleostei, seeds 3, 4, 5, 6 and 8);
2. build every CUDA source in ``sharkmer_tpu_torch/csrc`` (one nvcc
   each, all at once, sm_90a);
3. the card's dependent-load latency through L2 and from DRAM
   (``csrc/chase.cu``, a pointer chase), for the latency bounds; each
   kernel against its plain PyTorch version on the card, at the main
   path's shapes: ``encode`` on the loader's [131072, 160] batch at k=19
   (reads with N runs and ragged pad tails: keys and both totals exact,
   timed beside its byte bound), then at k 1, 17, 19, 21, 25, 27 and 31
   on widths 32, 33, 160 and 4096, narrower than k, long reads in tiles,
   rows off the 16 B alignment, and batches and keys with no mapped byte
   past either end, so that a stray read or write faults
   (``encode_phase``);
   ``run_ends``/``run_starts`` on 2^27 sorted int64 keys
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
   start's 4096 keys, also on the table cut into 257 partitions, past
   the descriptors the kernel copies to shared memory); then a table whose buckets hold 256 rows at the
   LUT's bits cap (``wide_bucket_table``): a closure from 2 roots, and
   ``probe_rows`` on 4096 of its keys (hits past a bucket's first 32
   rows among them): equal ``n_vis``, ``iters``, ``overflow``, ``done``,
   sorted log and boundary set, equal probe ids, and median ms per call
   (``probe_rows`` also its device time alone, from ``torch.profiler``,
   beside an empty kernel's on the same grid);
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
   a 2^26-slot table into 2^27 slots, the batch routed by owner into 4
   shards of 2^25 slots in one launch, the largest merge of phase 22's 8M
   hash run at its shapes (MERGE_SHAPE), and the batch into 4 shard
   groups on the card in separate allocations (one windowed launch a
   group, phase 18's placement), each table's sorted rows (shard by
   shard) equal to the plain version's (the slot layouts may differ:
   claims race) and its claim counters equal to its occupied slots;
   ``hash_lookup`` on a 4096-query wave and on 2^20 queries, half of
   them random keys, on the one table and on the 4 shards, exact; the
   wave also timed as the kernel alone (a CUDA graph of back-to-back
   launches); byte bounds on the slot layout beside the two-array
   layout's on the same slots; then the lookup wave path the tables'
   ``lookup_directional`` takes (numpy in, numpy out, one
   ``shk_hash_lookup_wave`` call on the thread's own stream), on both
   tables: waves of 0, 1, 5, 64, 4097, 4096 and 2^20 queries, both
   sentinels among them, each exact against ``lookup_plain`` and one
   ``hash_lookup`` launch; 7 threads issuing 64 waves each at once,
   every answer exact; and the one table's slots copied into a new
   table behind ``torch.cuda._sleep`` on the current stream and looked
   up at once through the wave path, exact (the table's ``WriteFence``
   orders the wave's stream after the copy); last the freeze band
   (``band_phase``): keys at SAT_THRESHOLD - 2, - 1, + 0 and + 5 and the
   batch with 5 entries of each, and a merge whose source counts lie
   near the threshold into a master that holds the same keys near it,
   each 20 launches from one start on one table, 4 shards and 4 groups
   (a windowed launch a group), every launch equal to
   ``insert_plain`` and the band keys to the JAX values in BAND and
   MERGE_BAND;
9. the 1M cell with ``--backend hash`` (``--mirror auto`` resolves to the
   host mirror: the hash table has no reach closure) and ``--save-table
   build/chip_smoke/hash_1M.npz``, held to the same oracle as phase 4;
10. the 1M cell with ``--backend hash --mirror device`` (directional
    lookups on ``hash_lookup``, a wave each); then its table's waves
    timed numpy to numpy (``cli_wave_times``: the run's median and
    largest wave, 4096 and 2^20 queries, and the foreign call alone;
    waves a second from one thread and from 7);
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
    on the host mirror and with ``--mirror device`` (routed lookups; its
    table's waves timed as in phase 10);
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
    pointer-table ``hash_lookup`` (a 4096-query wave and 2^20 queries),
    and the wave path through it (phase 8's wave checks);
    phase 13's closures over shards placed on the list (on several
    cards, the peer shards' LUTs copied to the launching card and held
    equal to their own); then the 1M cell
    with ``--n-shards 4`` on the sorted backend, on the hash backend with
    ``--mirror device`` (its table's waves timed as in phase 10), and
    ``--load-table`` of phase 9's checkpoint.
    Where two or more cards are visible, the same again on distinct
    cards (``cuda:0,cuda:1,...``), after the dependent-load latency into
    a peer's DRAM, with a check of the cross-card stream ordering: the
    peer cards' shards cleared, then written back behind a
    ``torch.cuda._sleep`` on their own streams, while ``hash_lookup``
    (the tensor wrapper, and a wave of a table made on the late slots)
    and ``reach_closure`` launch on the first card, which must stay
    exact against their plain versions; otherwise one line says that
    part did not run;
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
    report every gene of the panel recovered;
21. (only with ``--profiles``: they time tools that
    ``tests/test_torch_profile_tools.py`` holds on the CPU and drive no
    path that phases 4 and 19 do not) the profilers, each a subprocess:
    ``tools/ingest_phase.py`` at the cell's k, at 2^27 keys (the drain
    path's stages, each drain launching its kernels) and with ``--fastq`` on the 8M cnidaria FASTQ
    (the host stages of the CLI's ingest, its reads, bases and k-mers
    those of the committed 8M cell), in one process;
    ``tools/cold_start.py`` bare (a fresh process's stages),
    then ``--cli`` on the 1M cnidaria cell: its outputs held to the
    committed cell, and its split of the child's wall (before, inside
    and after ``main()``) summing to that wall within 0.5 s;
22. the chunked spectra at depth, each run held to
    ``chunk_spectra_reference`` (the port's loader and plain encoding, then
    ``torch.sort`` and ``torch.unique_consecutive`` folding the chunks
    in order, no count store): first the reference itself on the first
    250k reads with 10 chunks, written through the port's writers,
    byte-identical to the JAX package's ``.histo`` and ``.final.histo``
    in ``oracles/``; then ``--chunks 10`` on the 8M cnidaria cell,
    sorted (``--mirror auto``) and ``--backend hash``, and ``--chunks 20
    --n-shards 4`` on the 1M cell, sorted; where four cards are visible,
    ``--chunks 10 --n-shards 4`` at 8M with a shard a card. Each run's
    ``.histo`` and ``.final.histo`` byte-identical to the reference's,
    its FASTA to the committed cell's, and its ``stats.yaml`` equal to
    the cell's but for ``command``, ``peak_memory_bytes`` and
    ``chunks``, with ``n_singleton_kmers`` the reference's final
    singletons and ``n_multi_kmers`` the k-mers less those; each run
    prints its stage walls, kernel launches and every card's peak, and,
    when its outputs differ, the chunks whose spectrum differs;
23. k=31, past the packed count field (the key/count compaction, no
    drain v2): ``reach_closure`` (narrow and wide roots, each also warm
    started), ``probe_rows``, ``hash_insert`` and the directional
    ``hash_lookup`` against their plain versions on k=31 data (the
    lookup also through the wave path, as in phase 8); then
    ``-k 31 --chunks 10`` on the first 250k reads, sorted and hash,
    byte-identical to the JAX package's k=31 oracle in ``oracles/``;
    then at 8M reads sorted and hash ``--chunks 1``, and sorted and
    hash ``--chunks 10``: every ``.histo`` and ``.final.histo``
    byte-identical to ``chunk_spectra_reference``'s at k=31, the FASTA
    byte-identical across the four (past ``pcr/counts.py``'s
    MIRROR_MAX_UNIQUE keys the hash table looks up each extension wave on
    the card instead of building the host mirror), ``stats.yaml`` equal
    across them but for ``command``, ``peak_memory_bytes`` and
    ``chunks``, with the reference's k-mer counts; then at 1M reads
    ``--chunks 1``, with ``--mirror full`` (the host mirror) and with
    ``--n-shards 4``, held the same way;
24. the 1M cnidaria cell through the record-stream entries, each
    byte-identical to the committed cell: stdin (``sys.stdin`` holding
    the gzip stream of the 8M FASTQ, ``-m 1000000``), ``--paired R1
    R2`` (R1 the first 1M reads at even positions, R2 those at odd ones,
    written into ``build/chip_smoke/``), two gzip files of 500k reads
    through the native loader, and the FASTQ with ``--validate-every
    1000``; each launches phase 4's kernels and prints its ingest wall
    beside phase 4's;
25. the six built-in panels the grid does not run (angiospermae,
    bacteria, c_elegans, human, insecta, teleostei) by name,
    ``--pcr-panel NAME``, each on its own synthetic FASTQ: the first
    250k reads sorted (``--mirror auto``) and ``--backend hash``, each
    byte-identical to the panel's JAX oracle in ``oracles/<panel>/``;
    1M reads sorted (insecta also 8M: its batched primer scan 2^20
    wide), held to the amplicons ``tools/synth.py`` embedded: every
    gene the oracle amplified amplified, with a product inside an
    embedded amplicon (up to 1% substitutions); insecta's 1M run again
    with ``--mirror full`` and ``--backend hash``, byte-identical to its
    sorted run. Each run prints its ``panel_scan`` widths and retries,
    closure calls and retries, and genes amplified;
26. the options no other phase runs: first phase 23's kernel checks
    (``reach_closure``, ``probe_rows``, ``hash_insert``, ``hash_lookup``
    and its wave path against their plain versions) at k=25 and k=27;
    then, each on the first 250k cnidaria reads and byte-identical
    (``.dot`` files too) to its JAX oracle in
    ``oracles/cnidaria/synthetic-seed0/<name>_250000/``: ``-k 25`` sorted
    at the CLI's default ``-t`` (one thread) and ``--backend hash``,
    ``-k 27`` sorted and hash (the JAX reach's packed and unpacked
    probes on either side of k=25), ``--read-threading`` with cnidaria's
    18S pair inline (its Pass 2 and threading log counts those of the
    JAX CLI), ``--min-kmer-count 4 --dump-graph`` sorted and ``--backend
    hash --mirror device``, ``--backend hash --table-capacity 131072``,
    and the graph-walk limits (``--node-budget-global``,
    ``--max-dfs-states``, ``--max-node-visits``,
    ``--max-paths-per-pair``), which must stop genes the unlimited run
    amplifies; the default ``-t`` run must run every gene on the calling
    thread, and ``--table-capacity`` must grow the table more often than
    the default capacity does. Last, on the knob fixture
    ``oracles/knobs/knobs.fastq`` (no gene of the cnidaria reads has a
    cycle or a second path), the run without limits, with
    ``--max-node-visits 1`` and with ``--max-paths-per-pair 1``, each
    byte-identical to its oracle in ``oracles/knobs/``; each limit must
    find fewer paths and keep fewer products than the run without;
27. the fused sharded ingest steps (``parallel/sharded_table.py``
    ``make_ingest_step``, ``parallel/sorted_sharded.py``
    ``make_sorted_ingest_step``, the JAX package's multi-chip training
    step) on the first 2^20 cnidaria reads, 4 steps of [4, 2^16, 150]
    codes into 4 shards of 2^25 slots (the sorted step's cap), on
    ``[cuda:0]``, on 4 groups of the one card and, with four cards, a
    group a card: the last step's histogram and the table (every
    shard's rows) equal to ``chunk_spectra_reference``'s on the same
    reads, no shard past 0.7 of its slots or at its cap, ``hash_insert``
    launched once a group a step and ``run_starts`` once a shard a step;
    each step's wall and each card's peak printed.

Each run's output directory must hold exactly its oracle's files, each
byte-identical but ``stats.yaml`` (equal but for ``command`` and
``peak_memory_bytes``).

Each kernel's launch count is reset just before each main-path run and
read just after it: ``run_ends``, ``run_starts`` and ``probe_rows`` (the
warm starts) must launch in phases 4 and 5 (``run_starts`` also in 14
and in 17's sorted runs), ``stitch_rows`` in phases 5 and 7,
``stitch_rows`` in no run of phase 23 (``run_ends``, ``run_starts``
there as ``check_long_k_runs`` says), phase 4's kernels in each run of
phase 24, ``run_ends`` in every sorted run of phase 19 (its ghosted
first drain)
and ``run_starts`` and ``stitch_rows`` in its 4M and 8M sorted runs
(all three in phase 22's 8M sorted run, ``run_starts`` in its sharded
runs),
``reach_closure`` in phases 4, 5, 7, 11 (sorted), 14, 17 (sorted), 18
(sorted), 19 (sorted), 22 (sorted), 23 (sorted, but ``--mirror full``),
24, 25 (sorted; with ``run_ends`` and ``probe_rows``, and past 250k
reads ``run_starts`` and ``stitch_rows``) and 26 (sorted, with
``run_ends``) at least once per closure call
(the run's
``closures`` sPCR phase), where ``probe_rows`` may launch no more often
than that, the
plain closure loop must never run and no sorted store's host mirror may be built
(sharded or not). ``hash_insert`` must launch in phases 9, 11 (hash),
12, 15, 16, 17 (hash), 18 (hash), 22 (hash), 23 (hash) and 26 (hash),
once per
insert of a
batch, merge
and grow of a hash table and device group (one routed launch for all
shards of a group; also in phase 19's and 25's hash runs), ``hash_lookup`` in
phases 10, 15, 18 and 26 (``--mirror
device``), once per lookup wave, and none of the sorted store's kernels
in those hash runs;
``KmerTable.to_sorted_arrays`` (the host mirror) runs once in phases 9
(plus once for the checkpoint), 11 (hash), 12, 17 (hash, 1 shard), 19
(hash) and 22 (hash),
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
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types

T_START = time.monotonic()
HERE = os.path.dirname(os.path.abspath(__file__))
# the offline grid (benchmarks/benchmark_offline.yaml): each panel's seed
GRID_SEEDS = {"cnidaria": 0, "hydrozoa": 1, "metazoa": 2}
N_READS_MAX = 8_000_000  # the grid's deepest cell: one FASTQ a panel
M = 1_000_000
# phase 25: the six other built-in panels, run by name (--pcr-panel), each
# from a synthetic FASTQ of its own (seeds after the grid's): insecta's up
# to the grid's depth, the others' to 1M reads
BUILTIN_SEEDS = {"angiospermae": 3, "bacteria": 4, "c_elegans": 5,
                 "human": 6, "insecta": 7, "teleostei": 8}
SEEDS = {**GRID_SEEDS, **BUILTIN_SEEDS}
FASTQ_READS = {p: N_READS_MAX if p in GRID_SEEDS or p == "insecta" else M
               for p in SEEDS}
# phase 19: the committed cells that phases 4-18 do not run, sorted
# (the main path), then the hash backend's
GRID_SORTED = [("cnidaria", 8 * M), ("hydrozoa", M), ("hydrozoa", 4 * M),
               ("hydrozoa", 8 * M), ("metazoa", M), ("metazoa", 4 * M),
               ("metazoa", 8 * M)]
GRID_HASH = [("cnidaria", 8 * M), ("hydrozoa", M), ("metazoa", M)]
PANELS = {p: os.path.join(HERE, "sharkmer_tpu_torch", "panels", f"{p}.yaml")
          for p in SEEDS}
FASTQS = {p: os.path.join(HERE, "benchmarks", "work", "synth",
                          f"{p}_synthetic-seed{seed}_{FASTQ_READS[p]}.fastq.gz")
          for p, seed in SEEDS.items()}
# phases 4-18: the cnidaria cells
PANEL, FASTQ = PANELS["cnidaria"], FASTQS["cnidaria"]
OUT_DIR = os.path.join(HERE, "build", "chip_smoke")
KERNEL_N = 1 << 27
PART_ROWS = 1 << 26
GENOME_BASES = 1 << 20
CLOSURE_PARTS = 21
# past csrc/probe_rows.cu's kSmemParts descriptors: probe_rows routes from
# global memory
PAST_CAP_PARTS = 257
CLOSURE_SHARDS = 4  # the owner-routed layout of phase 13
CLOSURE_MC = 2  # the closures' count floor
WIDE_BUCKET_BASES = 1 << 14  # the genome of the 256-row-bucket table
WIDE_BUCKET_DEPTH = 512
HBM_BYTES_PER_MS = 3.35e9  # the H100 SXM's 3.35 TB/s
STITCH_SHAPE = (2048, 1 << 16)
HASH_READS = 1 << 17  # one CLI ingest batch
HASH_CAP = 1 << 27  # the 1M cell's final hash table
HASH_SHARDS = 4  # the owner-routed insert and lookup of phase 8
# phase 8's merge: the largest of phase 22's 8M --chunks 10 hash run, as
# that run prints it (source slots, source keys, master slots, master keys
# before, keys in both)
MERGE_SHAPE = (1 << 26, 37_939_713, 1 << 28, 91_359_173, 20_669_603)
# phase 8's band: keys near the freeze (SAT_THRESHOLD), each with the
# count it starts at and the JAX table's count after a batch that holds
# BAND_ENTRIES entries of it (sharkmer_tpu/ops/hashtable.py reads the
# freeze once a round: new = old + (old < T ? the batch's sum : 0), mod
# 2^32); BAND_REPS launches from the same start, a layout
SAT = 0xE000_0000
BAND_ENTRIES = 5
BAND = ((SAT - 2, SAT + 3), (SAT - 1, SAT + 4), (SAT, SAT),
        (SAT + 5, SAT + 5))
# the merge's: the master's count, the source's, the JAX master's after
MERGE_BAND = ((SAT - 2, 3, SAT + 1), (SAT - 1, 1, SAT), (SAT, 7, SAT),
              (SAT + 5, SAT - 1, SAT + 5),
              (SAT - 1, 0x3000_0000, (SAT - 1 + 0x3000_0000) % (1 << 32)))
BAND_REPS = 20
LOOKUP_WAVE = 4096
SLEEP_CYCLES = 100_000_000  # torch.cuda._sleep: ~50 ms at the H100's clock
LOOKUP_MANY = 1 << 20
# the lookup waves (kernels.hash.LookupWaves, numpy to numpy): the sizes
# held to lookup_plain (both sentinels in each of 2 queries or more), the
# gene threads that issue waves at once (-t 8), and the waves each thread
# replays
WAVE_SIZES = (0, 1, 5, 64, 4097, LOOKUP_WAVE, LOOKUP_MANY)
WAVE_THREADS = 7
THREAD_WAVES = 64
KMER_SENTINEL = (1 << 64) - 1
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
# phase 3's encode: the loader's batch (2^17 reads of 160 codes) at K, then
# exactness at each k of ENCODE_KS on each width of ENCODE_WIDTHS
ENCODE_SHAPE = (HASH_READS, 160)
ENCODE_KS = (1, 17, 21, 25, 27, 31)
ENCODE_WIDTHS = (32, 33, 4096)
# phase 22: the chunked runs at depth, each held to chunk_spectra_reference
# (label, reads, --chunks, further CLI arguments); the four-card run only
# where four cards are visible (one shard a card)
CHUNKED_RUNS = [("chunked_sorted_8M", 8 * M, 10, ()),
                ("chunked_hash_8M", 8 * M, 10, ("--backend", "hash")),
                ("chunked_shards_1M", M, 20, ("--n-shards", N_SHARDS))]
CHUNKED_CARDS = ("chunked_cards_8M", 8 * M, 10, ("--n-shards", N_SHARDS))
# phase 23: k past the packed count field (k >= 23: the key/count
# compaction, no drain v2) at k = 31, the upstream 18S test's k
LONG_K = 31
LONG_K_ORACLE = os.path.join(HERE, "oracles", "cnidaria", "synthetic-seed0",
                             "k31_chunks10_250000")
LONG_K_ROWS = 1 << 21  # the k=31 closure table (3/4 of it keys)
LONG_K_PARTS = 4  # its key-range partitions
# the runs of (b) at 8M reads and (c) at 1M (label, --chunks, further CLI
# arguments), held to the reference's spectra; the first run of each
# depth gives the rest their FASTA and stats.yaml. --mirror full runs at
# 1M: at 8M it took 36.4 s of the script's 900 s
LONG_K_RUNS = {8 * M: [("k31_sorted_8M", 1, ()),
                       ("k31_hash_8M", 1, ("--backend", "hash")),
                       ("k31_chunked_sorted_8M", 10, ()),
                       ("k31_chunked_hash_8M", 10, ("--backend", "hash"))],
               M: [("k31_1M", 1, ()),
                   ("k31_mirror_full_1M", 1, ("--mirror", "full")),
                   ("k31_shards_1M", 1, ("--n-shards", N_SHARDS))]}
# phase 24: the record-stream entries on the 1M cell; inputs in OUT_DIR
ENTRY_FILES = ("R1", "R2", "part1", "part2")
VALIDATE_EVERY = "1000"  # phase 24's --validate-every run: a record in 1000
# phase 25: each panel's JAX oracle (on the CPU) at PANEL_ORACLE_READS, the
# depths held to the embedded amplicons, and insecta's runs at 1M held to
# its sorted run (label suffix, further CLI arguments)
PANEL_ORACLE_READS = 250_000
PANEL_DEPTHS = {p: (M, 8 * M) if p == "insecta" else (M,)
                for p in BUILTIN_SEEDS}
INSECTA_1M = (("full", ("--mirror", "full")), ("hash", ("--backend", "hash")))
# phase 26: the options no other phase runs, each on the first
# OPTIONS_READS reads against its own JAX oracle (made on the CPU with the
# same flags: oracles/README.md); the k-mer kernels also at OPTION_KS
OPTIONS_READS = 250_000
OPTION_KS = (25, 27)
# cnidaria's 18S pair as one inline spec (cli.parse_pcr_primers_string)
SPEC_18S = ("name=18S,forward=AACCTGGTTGATCCTGCCAGT,"
            "reverse=TGATCCTTCTGCAGGTTCACCTAC,min-length=1600,"
            "max-length=2000")
# the graph-walk limits, each binding on this input where it can
# (oracles/README.md): 28S_1's graph passes the node budget, 18S's
# walk the DFS states
WALK_LIMITS = ("--node-budget-global", "2500", "--max-dfs-states", "1000",
               "--max-node-visits", "1", "--max-paths-per-pair", "1")
# --max-node-visits and --max-paths-per-pair find one path a gene and no
# cycle on those reads, so neither can bind there: each also runs on the
# knob fixture of tests/test_torch_cli_knobs.py (its 18S reads with a
# cycle and bubbles, committed as knobs.fastq in KNOB_DIR), against its own
# JAX oracle in KNOB_DIR/<name>/, and must find fewer paths and keep fewer
# products than the unlimited run there; (label, oracle, CLI arguments)
KNOB_DIR = os.path.join(HERE, "oracles", "knobs")
KNOB_SPEC = ("forward=AACCTGGTTGATCCTGCCAGT,reverse=TGATCCTTCTGCAGGTTCACCTAC,"
             "name=18s,max-length=2500,min-count=2")
KNOB_RUNS = (
    ("knobs_free", "free", ()),
    ("knobs_max_node_visits", "max_node_visits", ("--max-node-visits", "1")),
    ("knobs_max_paths_per_pair", "max_paths_per_pair",
     ("--max-paths-per-pair", "1")),
)
# (label, oracle directory, CLI arguments, k, -t: None for the CLI's
# default of one thread); every run but the inline pair's names the
# cnidaria panel file
OPTION_RUNS = (
    ("options_k25_sorted", "k25", (), 25, None),
    ("options_k25_hash", "k25", ("--backend", "hash"), 25, "8"),
    ("options_k27_sorted", "k27", (), 27, "8"),
    ("options_k27_hash", "k27", ("--backend", "hash"), 27, "8"),
    ("options_read_threading", "read_threading",
     ("-v", "--read-threading"), K, "8"),
    ("options_min_count4_sorted", "min_count4_dump",
     ("--min-kmer-count", "4", "--dump-graph"), K, "8"),
    ("options_min_count4_device", "min_count4_dump",
     ("--min-kmer-count", "4", "--dump-graph", "--backend", "hash",
      "--mirror", "device"), K, "8"),
    ("options_table_capacity", "table_capacity",
     ("--backend", "hash", "--table-capacity", str(1 << 17)), K, "8"),
    ("options_walk_limits", "walk_limits", ("-v", *WALK_LIMITS), K, "8"),
)
# phase 27: the fused sharded ingest steps (parallel/sharded_table.py
# make_ingest_step, parallel/sorted_sharded.py make_sorted_ingest_step) on
# the first INGEST_READS cnidaria reads, INGEST_STEP_READS a shard a step
# over INGEST_SHARDS shards of INGEST_CAP slots (the sorted step's cap);
# no shard may pass INGEST_LOAD of its slots
INGEST_READS = 1 << 20
INGEST_SHARDS = 4
INGEST_STEP_READS = 1 << 16
INGEST_CAP = 1 << 25
INGEST_LOAD = 0.7
READ_LEN = 150  # tools/synth.py's reads
# the log lines of --read-threading whose counts must be the JAX CLI's
THREADING_LINES = ("Pass 2: collected", "Read threading:", "Threading:")
AMPLICON_SUBST = 0.01  # tools/synth.py's substitution rate a read base
READS_PER_TURN = 1000  # the reads a chunk takes in turn (io.rs:355-361)
HISTO_MAX = 10000  # the CLI's --histo-max default
INT64_MAX = (1 << 63) - 1
VARYING_STATS = ("command", "peak_memory_bytes")
PANEL_SCAN_OUT = 1 << 14  # SortedKmerStore.prefix_scan_many's max_out
SPLIT_SLACK_S = 0.5  # cold_start --cli: its parts against the child's wall
FALLBACK_WARNINGS = ("sPCR device-index build failed", "reach warmup failed")
PROFILER_ATTEMPTS = 3  # profiled_ms: sessions before an empty trace fails

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
    # no Pallas kernel: the JAX package's encode is one jitted XLA function
    "encode": ("sharkmer_tpu_torch/csrc/encode.cu",
               "sharkmer_tpu/ops/encoding.py:88"),
}


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(title: str) -> None:
    """A phase's heading, with the seconds since the script started."""
    print(f"== {title} [{time.monotonic() - T_START:.1f} s]", flush=True)


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
            what: str, library=None, plain_reps: int | None = None) -> dict:
    """Exact equality of kernel() with plain() and, where given, with
    library() (one PyTorch call that computes the same function), then
    median times in turns: plain, library, kernel, kernel, library,
    plain, each of ``reps`` calls (the plain ones of ``plain_reps``
    where given)."""
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
    plain_reps = reps if plain_reps is None else plain_reps
    plain_ms = median_ms(torch, plain, plain_reps)
    library_ms = None if library is None else median_ms(torch, library, reps)
    ms = (median_ms(torch, kernel, reps) + median_ms(torch, kernel, reps)) / 2
    if library is not None:
        library_ms = (library_ms + median_ms(torch, library, reps)) / 2
    plain_ms = (plain_ms + median_ms(torch, plain, plain_reps)) / 2
    lib_text = "" if library is None else f", {library_ms:.4f} ms library"
    print(f"{name}: exact on {what}; median {ms:.4f} ms kernel vs "
          f"{plain_ms:.4f} ms plain{lib_text} on {card}", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms}


def profiled_ms(torch, fn, kernel: str, reps: int) -> float:
    """The device time of one launch of the CUDA kernel ``kernel`` alone:
    ``reps`` calls of ``fn`` (after one untraced call) under
    ``torch.profiler``, the kernel's summed device time over the launches
    the trace holds (at most ``reps``: a trace can drop one)."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(events):
        return sum(getattr(a, "self_device_time_total",
                           getattr(a, "self_cuda_time_total", 0.0))
                   for a in events)

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        hits = [a for a in events if kernel in a.key]
        count = sum(a.count for a in hits)
        us = device_us(hits)
        if count or device_us(events) > 0:
            break
        # a session now and then records no device activity at all on
        # the H100 machine (as torch.profiler's CUPTI tracing runs there):
        # trace again; a session that traced other work but not this
        # kernel fails below at once
        print(f"torch.profiler recorded no device activity in {reps} calls "
              f"of {kernel} (attempt {attempt + 1} of {PROFILER_ATTEMPTS})",
              flush=True)
    require(0 < count <= reps and us > 0,
            f"torch.profiler saw {count} launches of {kernel} ({us} us of "
            f"device time) in {reps} calls")
    return us / count / 1e3


def probe_floor_ms(torch, n_cand: int, reps: int):
    """``profiled_ms`` of ``csrc/probe_rows.cu``'s empty kernel on the
    grid of a ``probe_rows`` launch for ``n_cand`` candidates: the floor
    of a one-level launch. None where the library has no empty kernel (a
    tree older than it, run by ``--closure-times``)."""
    import ctypes

    from sharkmer_tpu_torch.kernels import build

    lib = build.load("probe_rows")
    if not hasattr(lib, "shk_probe_rows_empty"):
        return None
    lib.shk_probe_rows_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.shk_probe_rows_empty.restype = ctypes.c_int

    def launch():
        rc = lib.shk_probe_rows_empty(
            n_cand, torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f"probe_rows_empty: CUDA launch failed "
                f"(cudaError {rc})")

    return profiled_ms(torch, launch, "probe_rows_empty_kernel", reps)


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


def closure_table(np, torch, n_rows: int, k: int, device="cuda"):
    """A table of ``n_rows`` rows on ``device`` from default_rng(4): every
    k-mer of a random genome of GENOME_BASES bases plus random filler
    keys, 3/4 of the rows in all, canonical, sorted, sentinel tail.
    Counts in [1, 40), the genome's at or above CLOSURE_MC but for one in
    10^4 (a break in the walk); a k-mer the genome holds more than once
    takes its first occurrence's count (``genome_counts``), so every
    build is the same table. Returns (keys, counts, n_real, the genome's
    k-mers)."""
    from sharkmer_tpu_torch.ops.histogram import revcomp

    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, size=GENOME_BASES)
    n_k = GENOME_BASES - k + 1
    fwd = np.zeros(n_k, np.int64)
    for j in range(k):
        fwd = (fwd << 2) | genome[j : j + n_k]
    filler = rng.integers(0, 1 << (2 * k), size=n_rows * 3 // 4 - n_k)
    raw = torch.from_numpy(np.concatenate([fwd, filler])).to(device)
    uniq = torch.unique(torch.minimum(raw, revcomp(raw, k)))
    n_real = uniq.shape[0]
    counts = torch.zeros(n_rows, dtype=torch.int64, device=device)
    counts[:n_real] = torch.from_numpy(
        rng.integers(1, 40, size=n_real)).to(device)
    g_counts = rng.integers(CLOSURE_MC, 40, size=n_k)
    g_counts[rng.random(n_k) < 1e-4] = 1
    rows, g_counts = genome_counts(np, torch, uniq, fwd, g_counts, k)
    counts[rows] = torch.from_numpy(g_counts).to(device)
    keys = torch.full((n_rows,), INT64_MAX, dtype=torch.int64, device=device)
    keys[:n_real] = uniq
    return keys, counts, n_real, fwd


def genome_counts(np, torch, uniq, fwd, g_counts, k: int):
    """The rows of the sorted canonical keys ``uniq`` that the genome's
    k-mers ``fwd`` fall on, each once, and the count each takes: that of
    the k-mer's first occurrence in ``fwd``. Resolved on the host, since
    an ``index_put_`` with repeated rows leaves undefined on CUDA which
    of their values lands."""
    from sharkmer_tpu_torch.ops.histogram import revcomp

    g = torch.from_numpy(fwd)
    canonical = torch.minimum(g, revcomp(g, k)).numpy()
    once, first = np.unique(canonical, return_index=True)
    rows = torch.searchsorted(uniq, torch.from_numpy(once).to(uniq.device))
    return rows, g_counts[first]


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


def closure_roots(np, roots):
    """A closure call's ``c0`` on the current card: the distinct
    ``roots``, padded with EMPTY to ``8 * F_CAP`` keys."""
    from sharkmer_tpu_torch.ops import reach
    from sharkmer_tpu_torch.ops.keys import keys_to_device

    c0 = np.full(8 * reach.F_CAP, reach.EMPTY, np.uint64)
    roots = np.unique(np.asarray(roots, np.uint64))
    c0[: len(roots)] = roots
    return keys_to_device(c0, "cuda")


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


def reused_table(torch, np, reuse: dict, name: str, keys, counts,
                 fwd=None) -> None:
    """The guard of ``closure_phase``'s ``reuse``: its first call keeps the
    table's rows (a host copy) under ``name``; a later call's table must
    equal them row for row. On a difference it prints the rows that
    differ, and, given the genome's k-mers ``fwd``, which of them hold a
    k-mer the genome repeats, then fails."""
    from sharkmer_tpu_torch.ops.histogram import revcomp

    rows = (keys.cpu(), counts.cpu())
    kept = reuse.get(name)
    if kept is None:
        reuse[name] = rows
        return
    differ = torch.nonzero((rows[0] != kept[0])
                           | (rows[1] != kept[1])).reshape(-1)
    if differ.numel() and fwd is not None:
        g = torch.from_numpy(fwd)
        canonical = torch.minimum(g, revcomp(g, K)).numpy()
        once, seen = np.unique(canonical, return_counts=True)
        repeated = torch.searchsorted(rows[0], torch.from_numpy(
            once[seen > 1]))
        print(f"{name}: rows {differ[:20].tolist()} differ (counts "
              f"{rows[1][differ[:20]].tolist()} vs "
              f"{kept[1][differ[:20]].tolist()}); the genome's repeated "
              f"k-mers on rows {repeated.tolist()}", flush=True)
    require(not differ.numel(), f"{name}: {differ.numel()} rows differ "
            f"from the table whose plain results are reused")
    print(f"{name}: equal row for row to the table whose plain closure "
          f"results are reused", flush=True)


def closure_phase(torch, np, card: str, latency: dict, layouts,
                  plain: bool = True, device_times: bool = False,
                  reuse: dict | None = None) -> dict:
    """``reach_closure`` against ``closure_plain`` on a 2^26-row table in
    each of ``layouts`` (name: build(keys, counts, n_real) -> PartTable),
    on ``closure_cases`` and a warm start; ``probe_rows`` against
    ``probe_rows_plain`` at the warm start's PRE_W keys (with a key-range
    layout, also on the table cut into PAST_CAP_PARTS partitions: the
    kernel's global route); then both on ``wide_bucket_table``. Each with
    its byte bound and its latency bound (``chain_ms``). ``plain=False``
    runs and times the kernels alone (``--closure-times``): no plain run,
    no comparison, no LUT check (so that it also runs on trees older than
    ``PartTable.luts``). ``device_times`` (phase 3, ``--closure-times``)
    adds ``probe_rows``' device time alone and that of an empty kernel on
    its grid (``profiled_ms``, ``probe_floor_ms``): a profiler session
    later in the script, after the CLI runs, has traced no kernel of the
    port. ``reuse`` (one layout: phases 13 and 18, whose owner shards give
    the same row ids) keeps the plain closures' results of its first call
    and gives them to a later one, on a table that ``reused_table`` finds
    equal to the first's."""
    from sharkmer_tpu_torch.kernels import closure, probe
    from sharkmer_tpu_torch.ops import reach
    from sharkmer_tpu_torch.ops.keys import keys_to_device, keys_to_numpy

    start = time.monotonic()
    keys, counts, n_real, fwd = closure_table(np, torch, PART_ROWS, K)
    if reuse is not None:
        require(len(layouts) == 1, "closure_phase: reuse takes one layout")
        reused_table(torch, np, reuse, "closure table", keys, counts, fwd)
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
              overflow=False, key=None):
        """Kernel against plain on one call at ``shape`` (depth, f_cap,
        f_narrow), then CUDA-event times: the plain run that checked, 10
        kernel runs, and a second plain run when ``plain_twice`` (plain,
        kernel x 10, plain). ``overflow``: the call must overflow (else it
        must walk past half its depth). With ``reuse``, the plain result
        is kept (or taken) under ``key``; a taken one has no plain time
        (``plain_ms`` None, ``plain_from`` says whose result it was)."""
        plain_ms = plain_from = None
        if plain:
            kept = None if reuse is None else reuse.get(("plain", key))
            if kept is None:
                plain_ms, want = event_ms(lambda: run(
                    table, c0, pre_ids, closure.closure_plain, shape))
                if reuse is not None:
                    reuse["plain", key] = [t.cpu() for t in want]
            else:
                want = [t.cuda() for t in kept]
                plain_from = "phase 13"
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
        if plain_ms is not None and plain_twice:
            plain_ms = (plain_ms + event_ms(lambda: run(
                table, c0, pre_ids, closure.closure_plain, shape))[0]) / 2
        # levels that probed: up to 3 narrow levels after `done` ran on
        # an empty frontier
        levels = gs[1] - 3 * gs[3]
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "plain_from": plain_from,
                  "n_vis": gs[0], "iters": gs[1], "done": gs[3],
                  "boundary": int(g_b.numel()),
                  "library_ms": None,  # no torch op runs a BFS closure
                  **byte_bound(closure_bytes(torch, table, c0, pre_ids, g_log,
                                             gs, got[1], K)),
                  "latency_bound_ms": chain_ms(latency, levels),
                  "latency_levels": levels}
        what = "exact" if plain else "ran"
        versus = ("" if not plain else f" vs {plain_ms:.4f} ms plain"
                  if plain_from is None else
                  f", plain result reused from {plain_from}")
        print(f"reach_closure: {what} on {label}: {result}; median "
              f"{ms:.4f} ms a call{versus} on {card}", flush=True)
        return result, got

    def check_probe(label, table, cand):
        """``probe_rows`` against ``probe_rows_plain`` on ``cand``, timed
        (kernel ids alone with ``plain=False``)."""
        args = (table, cand, CLOSURE_MC)
        if plain:
            result = compare(torch, "probe_rows",
                             lambda: probe.probe_rows(*args),
                             lambda: probe.probe_rows_plain(*args), 20, card,
                             label)
        else:
            result = {"ms": median_ms(
                torch, lambda: probe.probe_rows(*args), 20)}
        result.update(byte_bound(12 * cand.numel() + 48 * len(table.sidecars)
                                 + routed_bytes(torch, table, cand)))
        # one level of probes, all in parallel: the key, the LUT, the
        # bucket rows
        result["latency_bound_ms"] = chain_ms(latency, 1)
        if not device_times:
            return result, probe.probe_rows(*args)
        # the kernel's own device time, without the wrapper's host work,
        # and an empty kernel's on its grid
        result["device_ms"] = profiled_ms(
            torch, lambda: probe.probe_rows(*args), "probe_rows_kernel", 20)
        result["floor_ms"] = probe_floor_ms(torch, cand.numel(), 20)
        floor = ("" if result["floor_ms"] is None else
                 f"; an empty kernel on its grid {result['floor_ms']:.5f} ms")
        print(f"probe_rows: {label}: device time alone "
              f"{result['device_ms']:.5f} ms a launch (torch.profiler) vs "
              f"{result['ms']:.4f} ms timed around the wrapper; chain bound "
              f"{result['latency_bound_ms']:.5f} ms "
              f"({result['latency_bound_ms'] / result['device_ms']:.0%} of "
              f"the device time), byte bound {result['bound_ms']:.5f} ms"
              f"{floor} on {card}", flush=True)
        return result, probe.probe_rows(*args)

    cases = closure_cases(np, fwd)
    record = {}
    warm_keys = {}
    for name, table in tables.items():
        got = {}
        for call, (roots, shape) in cases.items():
            record[f"{call}, {name}"], got[call] = check(
                f"{name}, {call}: {len(roots)} roots at (depth, f_cap, "
                f"f_narrow) {shape}", table, closure_roots(np, roots), None,
                shape, plain_twice=call == "narrow" and name == "1 partition",
                overflow=call == "overflow", key=call)
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
        warm_keys[name] = pre_t
        # every warm-start key was visited, so each one hits
        n_pre = int((pre_t != INT64_MAX).sum())
        require(int((pre_ids != probe.INF32).sum()) == n_pre > 0,
                f"probe_rows: not every one of {n_pre} warm-start keys hit")
        record[f"pre, {name}"] = check(f"{name}, warm start", table,
                                       closure_roots(np, bound), pre_ids,
                                       (depth, f_cap, f_narrow),
                                       key="warm start")[0]
    del tables
    parts = f"{CLOSURE_PARTS} partitions"
    if parts in layouts:
        # more partitions than the kernel copies to shared memory: the
        # route from global memory, on the same warm-start keys
        table = cut_table(torch, keys, counts, n_real, PAST_CAP_PARTS, K)
        past = f"{PAST_CAP_PARTS} partitions"
        record[f"probe_rows, {past}"], ids = check_probe(
            f"{warm_keys[parts].numel()} warm-start keys, {past}", table,
            warm_keys[parts])
        n_pre = int((warm_keys[parts] != INT64_MAX).sum())
        require(int((ids != probe.INF32).sum()) == n_pre,
                f"probe_rows, {past}: not every one of {n_pre} warm-start "
                f"keys hit")
        del table
    del keys, counts, warm_keys
    torch.cuda.empty_cache()
    # buckets past 32 rows at the LUT's bits cap: the probe's rows past
    # the first 32 of a bucket, in the closure and in probe_rows
    keys, counts, n_real, fwd = wide_bucket_table(np, torch, K)
    if reuse is not None:
        reused_table(torch, np, reuse, "wide bucket table", keys, counts)
    n_k, shape = fwd.shape[0], (WIDE_BUCKET_DEPTH, f_cap, f_narrow)
    roots = closure_roots(np, fwd[[n_k // 4, 3 * n_k // 4]])
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
            table, roots, None, shape, key="wide bucket")[0]
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
        self.messages: list[str] = []  # every message of the last run

    def emit(self, record):
        msg = record.getMessage()
        self.messages.append(msg)
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

    from sharkmer_tpu_torch import stats
    from sharkmer_tpu_torch.ops import sorted_store

    run_log = _RunLog()
    logging.getLogger().addHandler(run_log)
    ctx = types.SimpleNamespace(
        torch=torch, kernels=kernels, run_log=run_log, mirror_builds=[],
        plain_closures=[], hash_exports=[], shard_exports=[],
        hash_grows=[], lookup_waves=[], table_calls=[], panel_scans=[],
        merges=[], gene_threads=[], lookup_table=None)

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
    # each merge's shapes: the source's slots and keys, the master's
    # slots (grown for the merge) and its keys before and after it
    merge_from = KmerTable.merge_from

    def merge_shapes(self, other):
        before = self.n_unique()
        merge_from(self, other)
        ctx.merges.append((other.capacity, other.n_unique(), self.capacity,
                           before, self.n_unique()))
        return self

    KmerTable.merge_from = merge_shapes

    def wave(args):
        """A lookup wave's size; its table kept for ``cli_wave_times``."""
        ctx.lookup_waves.append(len(args[1]))
        ctx.lookup_table = args[0]

    counted(KmerTable, "lookup_directional", wave)
    counted(ShardedKmerTable, "lookup_directional", wave)
    # the thread of each gene's sPCR: the caller's in run_pcr's
    # sequential branch (-t 1), a pool's under -t N
    counted(stats, "do_pcr",
            lambda a: ctx.gene_threads.append(threading.get_ident()))
    # on the card the closure must never fall back to its torch loop
    counted(closure, "closure_plain",
            lambda a: ctx.plain_closures.append(1))
    # the batched primer scan of a partition: (its width, the padded
    # oligos' count; its max_out, the last argument, past PANEL_SCAN_OUT
    # on a retry)
    counted(sorted_store, "panel_scan",
            lambda a: ctx.panel_scans.append((a[5].shape[0], a[-1])))
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
                    panel: str = "cnidaria", k: int = K, before_check=None,
                    threads: str | None = "8", primers=None,
                    sample: str | None = None):
    """One CLI run of ``panel``'s cell at ``n_reads`` and ``-k k`` (from the
    panel's FASTQ, or, with ``fastq=False``, from the checkpoint, files or
    stdin that ``extra`` names; a built-in panel of BUILTIN_SEEDS by
    name, the grid's from its file, or the CLI arguments ``primers``
    instead), at ``-t threads`` (None: the CLI's default), as ``sample``
    (by default the cell's name), held to the
    outputs in ``oracle`` (by default the JAX package's committed cell of
    ``panel`` at ``n_reads``) by ``check_outputs``; ``before_check(out,
    sample)``, where given, runs first (it may write ``oracle``). Prints
    every card's peak. Returns (the kernels' launch counts and the run's
    table counters, its stage-walls line); the run's log messages stay in
    ``ctx.run_log.messages`` until the next run."""
    from sharkmer_tpu_torch.main import main

    torch, kernels, run_log = ctx.torch, ctx.kernels, ctx.run_log
    sample = sample or f"synthetic-seed{SEEDS[panel]}_{n_reads}"
    oracle = oracle or oracle_of(panel, n_reads)
    out = os.path.join(OUT_DIR, label)
    shutil.rmtree(out, ignore_errors=True)
    # the built-in panels of phase 25 by name, as their users name them;
    # the grid's through the panel file, as its committed cells were made
    by = primers or (("--pcr-panel", panel) if panel in BUILTIN_SEEDS
                     else ("--pcr-panel-file", PANELS[panel]))
    argv = ["-s", sample, "-k", str(k),
            *(("-t", threads) if threads else ()), "-o", out, *by, *extra]
    if fastq:
        argv += ["-m", str(n_reads), FASTQS[panel]]
    ctx.lookup_table = None  # the last run's, if cli_wave_times kept it
    for index in range(torch.cuda.device_count()):  # each card's own peak
        torch.cuda.reset_peak_memory_stats(index)
    n_lines = len(run_log.lines)
    run_log.closures.clear()
    run_log.messages.clear()
    for events in (ctx.mirror_builds, ctx.plain_closures, ctx.hash_exports,
                   ctx.shard_exports, ctx.hash_grows, ctx.lookup_waves,
                   ctx.table_calls, ctx.panel_scans, ctx.merges,
                   ctx.gene_threads):
        events.clear()
    for fn in kernels.values():
        fn.launches = 0
    start = time.monotonic()
    rc = main(argv)
    wall = time.monotonic() - start
    counts = {name: fn.launches for name, fn in kernels.items()}
    require(rc == 0, f"{label}: the CLI exited {rc}")
    # the encode kernel once a batch or flush: the count trace's counter
    trace = next((m for m in run_log.messages if "count trace:" in m), "")
    encodes = re.search(r"\bencode\.kernel (\d+)", trace)
    counts["encode_calls"] = int(encodes.group(1)) if encodes else 0
    require(counts["encode"] == counts["encode_calls"],
            f"{label}: {counts['encode']} encode launches for "
            f"{counts['encode_calls']} encode.kernel calls on its count "
            f"trace")
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
    counts["mirror_builds"] = len(ctx.mirror_builds)
    # the hash tables' calls that each launch hash_insert once, and the
    # lookup waves that each launch hash_lookup once
    counts["table_calls"] = len(ctx.table_calls)
    counts["lookup_waves"] = sum(1 for n in ctx.lookup_waves if n)
    counts["hash_grows"] = len(ctx.hash_grows)
    # the gene threads, and whether every gene ran on the calling thread
    counts["gene_threads"] = len(set(ctx.gene_threads))
    counts["genes_on_caller"] = set(ctx.gene_threads) == {
        threading.get_ident()}
    walls = next(line for line in lines if "stage walls:" in line)
    print(f"{label}: CLI wall {wall:.3f} s; {walls}")
    for line in lines:
        if "sPCR phases:" in line:
            print(f"{label}: {line}")
    peaks = [torch.cuda.max_memory_allocated(i)
             for i in range(torch.cuda.device_count())]
    print(f"{label}: every card's torch.cuda.max_memory_allocated(): "
          f"{peaks} bytes")
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
    if ctx.merges:
        src, src_keys, dst, dst_keys, after = max(ctx.merges,
                                                  key=lambda m: m[1])
        print(f"{label}: the largest of {len(ctx.merges)} hash merges: "
              f"{src_keys} keys of a {src}-slot table into a {dst}-slot "
              f"table holding {dst_keys} keys before it, "
              f"{src_keys + dst_keys - after} of them in both")
    if ctx.lookup_waves:
        waves = sorted(ctx.lookup_waves)
        print(f"{label}: {len(waves)} directional lookup waves of "
              f"{waves[0]}-{waves[-1]} queries (median "
              f"{waves[len(waves) // 2]})")
    print(f"{label}: kernel launches {counts}", flush=True)
    if trace:
        print(f"{label}: {trace.strip()}", flush=True)
    for line in run_log.closures:
        # the kept attempt of each call: roots, iters, n_vis, f_cap, wall
        print(f"{label}: closure call: {line[len('reach: '):]}")
    if run_log.closures:
        calls = closure_retries(run_log.closures)
        print(f"{label}: closure calls (f_cap, overflow retries): {calls}; "
              f"{sum(r for _, r in calls)} retries in all")
    counts["scan_width"] = max((w for w, _ in ctx.panel_scans), default=0)
    if ctx.panel_scans:
        widths = sorted({w for w, _ in ctx.panel_scans})
        retried = [mo for _, mo in ctx.panel_scans if mo > PANEL_SCAN_OUT]
        print(f"{label}: batched primer scans: {len(ctx.panel_scans)} "
              f"panel_scan calls of width {widths}, {len(retried)} past "
              f"max_out {PANEL_SCAN_OUT} (retries at {retried})")
    if before_check is not None:
        before_check(out, sample)
    check_outputs(label, out, oracle, sample)
    return counts, walls


def chunk_spectra_reference(fastq: str, n_reads: int, n_chunks: int, k: int,
                            histo_max: int, device, with_rows: bool = False):
    """The ``n_chunks`` cumulative spectra of ``--chunks n_chunks`` on the
    first ``n_reads`` reads of ``fastq`` (0: all of them), computed
    without the code under test: the port's FASTQ loader
    (``io/native.py``) and plain encoding
    (``ops/encoding.canonical_kmers_plain``, not the encode kernel),
    read ``i`` in chunk ``(i // READS_PER_TURN) % n_chunks``, and the
    chunks folded in order into the prefix's sorted (key, count) arrays
    on ``device`` by ``torch.sort``, ``torch.unique_consecutive`` and a
    segment sum. No count store, drain, merge or hash kernel runs.
    Returns (one numpy uint64 histogram a chunk, ``histo_max + 2`` long:
    bin ``i`` the keys counted ``i`` times, bin ``histo_max + 1`` those
    counted more often, bin 0 zero; the valid k-mers of all reads); with
    ``with_rows``, also the last prefix's (sorted distinct keys, their counts)
    as int64 tensors on ``device``."""
    import numpy as np
    import torch

    from sharkmer_tpu_torch.io import native
    from sharkmer_tpu_torch.ops.encoding import canonical_kmers_plain

    device = torch.device(device)
    require(native.available(), "the native FASTQ loader did not build")
    raw = [[] for _ in range(n_chunks)]  # each chunk's valid k-mers
    seen = n_kmers = 0
    with native.NativeFastqReader(fastq) as reader, \
            native.PrefetchingBatches(reader, batch_reads=1 << 17,
                                      depth=3) as batches:
        for codes, _lens in batches:
            if n_reads:
                codes = codes[: n_reads - seen]
            turn = np.arange(seen, seen + codes.shape[0]) // READS_PER_TURN
            seen += codes.shape[0]
            kmers, valid = canonical_kmers_plain(
                torch.from_numpy(np.ascontiguousarray(codes)).to(device), k)
            chunk = torch.from_numpy(turn % n_chunks).to(device)
            n_kmers += int(valid.sum())
            for c in range(n_chunks):
                rows = chunk == c
                raw[c].append(kmers[rows][valid[rows]])
            if n_reads and seen >= n_reads:
                break
    require(not n_reads or seen == n_reads,
            f"{fastq} holds {seen} reads, not {n_reads}")
    keys = torch.empty(0, dtype=torch.int64, device=device)
    counts = torch.empty(0, dtype=torch.int64, device=device)
    spectra = []
    for c in range(n_chunks):
        new = torch.cat([keys, *raw[c]])
        raw[c] = None
        ones = torch.ones(new.shape[0] - keys.shape[0], dtype=torch.int64,
                          device=device)
        keys, order = torch.sort(new)
        del new
        counts = torch.cat([counts, ones])[order]
        del order, ones
        keys, run = torch.unique_consecutive(keys, return_counts=True)
        # each key's total: the count prefix sum at its run's last row,
        # less the one at the run before
        ends = torch.cumsum(run, 0) - 1
        counts = torch.diff(torch.cumsum(counts, 0)[ends],
                            prepend=counts.new_zeros(1))
        # every count is at least 1: bin 0 stays empty
        histo = torch.bincount(torch.clamp(counts, max=histo_max + 1),
                               minlength=histo_max + 2)
        spectra.append(histo.cpu().numpy().astype(np.uint64))
    if with_rows:
        return spectra, n_kmers, (keys, counts)
    return spectra, n_kmers


def write_spectra(out: str, sample: str, spectra, k: int,
                  n_chunks: int) -> None:
    """``{sample}.histo`` and ``{sample}.final.histo`` of ``spectra`` (of
    ``--histo-max`` their length less 2) in ``out``, through the port's
    writers (``io/writers.py``)."""
    from sharkmer_tpu_torch.io.writers import (write_final_histo,
                                               write_incremental_histo)

    os.makedirs(out, exist_ok=True)
    base = os.path.join(out, sample)
    histo_max = len(spectra[-1]) - 2
    write_incremental_histo(f"{base}.histo", spectra, histo_max, k, n_chunks)
    write_final_histo(f"{base}.final.histo", spectra[-1], histo_max, k,
                      n_chunks)


def chunked_oracle(n_reads: int, n_chunks: int, spectra) -> str:
    """The outputs a ``--chunks n_chunks`` run of the cnidaria cell at
    ``n_reads`` must write, in a directory of their own: the committed
    cell's FASTA (the final counts do not depend on the chunks), the
    reference's ``.histo`` and ``.final.histo``, and the cell's
    ``stats.yaml`` with ``chunks`` set and the singleton and multi counts
    of the reference's final spectrum."""
    import yaml

    sample = f"synthetic-seed0_{n_reads}"
    cell = oracle_of("cnidaria", n_reads)
    out = os.path.join(OUT_DIR, f"expected_{n_reads}_chunks{n_chunks}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    for name in os.listdir(cell):
        if name.endswith(".fasta"):
            shutil.copy(os.path.join(cell, name), out)
    write_spectra(out, sample, spectra, K, n_chunks)
    with open(os.path.join(cell, f"{sample}.stats.yaml")) as f:
        stats = yaml.safe_load(f)
    singletons = int(spectra[-1][1])
    stats.update(chunks=n_chunks, n_singleton_kmers=singletons,
                 n_multi_kmers=stats["n_kmers"] - singletons)
    with open(os.path.join(out, f"{sample}.stats.yaml"), "w") as f:
        yaml.safe_dump(stats, f, sort_keys=False)
    return out


def spectra_diff(out: str, sample: str, spectra) -> list[int]:
    """The chunks (1-based) whose column of ``out``'s ``.histo`` differs
    from the reference's spectrum; every chunk where the file is
    missing or has another shape."""
    path = os.path.join(out, f"{sample}.histo")
    everything = list(range(1, len(spectra) + 1))
    if not os.path.exists(path):
        return everything
    with open(path) as f:
        rows = [line.split("\t") for line in f.read().splitlines()[2:]]
    if len(rows) != HISTO_MAX + 1 or any(len(r) != len(spectra) + 1
                                         for r in rows):
        return everything
    return [c + 1 for c, want in enumerate(spectra)
            if [int(r[c + 1]) for r in rows] != want[1:].tolist()]


def chunked_reference_check(torch) -> None:
    """Phase 22 (a): the reference on the first CHUNK_READS reads with 10
    chunks, written through the port's writers, byte-identical to the
    JAX package's ``.histo`` and ``.final.histo`` in CHUNK_ORACLE."""
    sample = f"synthetic-seed0_{CHUNK_READS}"
    start = time.monotonic()
    spectra, _ = chunk_spectra_reference(FASTQ, CHUNK_READS, 10, K,
                                         HISTO_MAX, "cuda")
    out = os.path.join(OUT_DIR, "reference_250k")
    shutil.rmtree(out, ignore_errors=True)
    write_spectra(out, sample, spectra, K, 10)
    for suffix in (".histo", ".final.histo"):
        with open(os.path.join(CHUNK_ORACLE, sample + suffix), "rb") as a, \
                open(os.path.join(out, sample + suffix), "rb") as b:
            require(a.read() == b.read(), f"the reference's {suffix} differs "
                    f"from {os.path.relpath(CHUNK_ORACLE, HERE)}'s")
    print(f"reference, {CHUNK_READS} reads, 10 chunks: .histo and "
          f".final.histo byte-identical to "
          f"{os.path.relpath(CHUNK_ORACLE, HERE)} "
          f"({time.monotonic() - start:.3f} s)", flush=True)


def chunked_phase(ctx, runs: dict, n_cards: int,
                  cards_only: bool = False) -> None:
    """Phase 22: the chunked spectra at depth. (a)
    ``chunked_reference_check``. (b, c) Each run of CHUNKED_RUNS (and, on
    four cards or more, CHUNKED_CARDS: one shard a card) through
    ``drive_main_path``, held to ``chunked_oracle``; when its outputs
    differ, the chunks whose spectrum differs are printed first. Each
    reference's wall and each run's every card's peak are printed. With
    ``cards_only``, CHUNKED_CARDS alone: on four cards, or on the shard
    groups that SHARKMER_TORCH_DEVICES lists."""
    torch = ctx.torch
    if cards_only:
        require(n_cards >= 4 or os.environ.get(DEVICES_ENV),
                f"{CHUNKED_CARDS[0]} needs four cards or {DEVICES_ENV}")
        todo = [CHUNKED_CARDS]
    else:
        chunked_reference_check(torch)
        todo = CHUNKED_RUNS + ([CHUNKED_CARDS] if n_cards >= 4 else [])
    oracles = {}
    for label, n_reads, n_chunks, extra in todo:
        if (n_reads, n_chunks) not in oracles:
            torch.cuda.empty_cache()
            start = time.monotonic()
            spectra, _ = chunk_spectra_reference(FASTQ, n_reads, n_chunks,
                                                 K, HISTO_MAX, "cuda")
            print(f"reference, {n_reads} reads, {n_chunks} chunks: "
                  f"{time.monotonic() - start:.3f} s, "
                  f"{int(spectra[-1][1:].sum())} distinct k-mers, "
                  f"{int(spectra[-1][1])} singletons", flush=True)
            oracles[n_reads, n_chunks] = (
                spectra, chunked_oracle(n_reads, n_chunks, spectra))
            torch.cuda.empty_cache()
        spectra, oracle = oracles[n_reads, n_chunks]
        try:
            runs[label] = drive_main_path(
                ctx, label, n_reads, ("--chunks", str(n_chunks), *extra),
                oracle=oracle)
        except RuntimeError:
            differ = spectra_diff(os.path.join(OUT_DIR, label),
                                  f"synthetic-seed0_{n_reads}", spectra)
            print(f"{label}: the chunks whose spectrum differs from the "
                  f"reference's: {differ}", flush=True)
            raise
        torch.cuda.empty_cache()
    if n_cards < 4 and not cards_only:
        print(f"phase 22: the four-card run ({CHUNKED_CARDS[0]}) did not "
              f"run: {n_cards} card(s) visible", flush=True)


def long_k_kernels(torch, np, card: str, k: int = LONG_K) -> dict:
    """Phase 23 (0) at k = 31, phase 26 at OPTION_KS: the kernels whose
    k-dependent code runs past the packed count field (at k = 31 62-bit
    neighbour masks, a revcomp shift of 2) against their plain versions
    on the card. ``reach_closure`` on a LONG_K_ROWS-row k-mer
    ``closure_table``: the narrow roots of ``closure_cases`` on one
    partition, its wide roots on LONG_K_PARTS key-range partitions, and a
    warm start whose ``pre`` rows come from ``probe_rows`` (held to its
    plain version too); ``hash_insert`` of the k-mers of the FASTQ's
    first HASH_READS reads into a fresh table, and the directional
    ``hash_lookup`` of their reverse complements and as many random keys.
    Returns ``{name: {max_abs_err, ms, plain_ms}}``."""
    from sharkmer_tpu_torch.kernels import closure, probe
    from sharkmer_tpu_torch.kernels import hash as hk
    from sharkmer_tpu_torch.ops import reach
    from sharkmer_tpu_torch.ops.histogram import revcomp
    from sharkmer_tpu_torch.ops.keys import keys_to_device, keys_to_numpy

    keys, counts, n_real, fwd = closure_table(np, torch, LONG_K_ROWS, k)
    tables = {"1 partition": probe.PartTable(
                  [reach.build_sidecar(keys, counts, k)], [0]),
              f"{LONG_K_PARTS} partitions": cut_table(
                  torch, keys, counts, n_real, LONG_K_PARTS, k)}
    cases = closure_cases(np, fwd)
    record = {}

    def timed(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out

    def check_closure(key, label, table, c0, pre_ids, shape):
        """Kernel against plain on one call; a call from roots (no
        ``pre_ids``) must walk past half its depth."""
        args = (table, c0, pre_ids, CLOSURE_MC, k, *shape)
        plain_ms, want = timed(lambda: closure.closure_plain(*args))
        ms, got = timed(lambda: closure.reach_closure(*args))
        gs, ws = closure.unpack_state(got[2]), closure.unpack_state(want[2])
        g_log, w_log = (torch.sort(x[0]).values for x in (got, want))
        g_b, w_b = (torch.unique(x[1][x[1] != INT64_MAX]) for x in (got, want))
        require(gs == ws and torch.equal(g_log, w_log)
                and torch.equal(g_b, w_b) and not gs[2]
                and (pre_ids is not None or gs[1] > shape[0] // 2),
                f"reach_closure at k={k}, {label}: [n_vis, iters, overflow, "
                f"done] {gs} vs plain {ws}, or the logs or boundaries differ")
        print(f"reach_closure at k={k}: exact on {label}: [n_vis, iters, "
              f"overflow, done] {gs}, {int(g_b.numel())} boundary keys; "
              f"{ms:.4f} ms vs {plain_ms:.4f} ms plain on {card}", flush=True)
        record[f"reach_closure {key}"] = {"max_abs_err": 0, "ms": ms,
                                          "plain_ms": plain_ms}
        return got, gs

    for call, name in (("narrow", "1 partition"),
                       ("wide", f"{LONG_K_PARTS} partitions")):
        roots, shape = cases[call]
        table = tables[name]
        got, gs = check_closure(call, f"{name}, {call}: {len(roots)} roots",
                                table, closure_roots(np, roots), None, shape)
        # a re-prefetch from the boundary, warm-started with the interior
        visited, _ = reach._gather_rows(table,
                                        torch.sort(got[0]).values[: gs[0]])
        bound = keys_to_numpy(got[1])
        bound = bound[bound != reach.EMPTY]
        pre = np.setdiff1d(keys_to_numpy(visited), bound)
        pre_t = keys_to_device(reach._pad_pre(pre, roots=bound), "cuda")
        ids = probe.probe_rows(table, pre_t, CLOSURE_MC)
        want_ids = probe.probe_rows_plain(table, pre_t, CLOSURE_MC)
        require(torch.equal(ids, want_ids),
                f"probe_rows at k={k}, {name}: ids differ from plain")
        record[f"probe_rows {call} warm"] = {"max_abs_err": 0}
        check_closure(f"{call} warm",
                      f"{name}, {call} warm start: {bound.size} roots, "
                      f"{pre.size} pre keys", table,
                      closure_roots(np, bound[:8 * reach.F_CAP]), ids, shape)
    del tables, keys, counts
    torch.cuda.empty_cache()

    kmers, n_valid = first_batch_kmers(torch, np, k)
    kern = (hk.new_slots((HASH_CAP,), "cuda"),
            torch.zeros(1, dtype=torch.int64, device="cuda"))
    plain = (hk.new_slots((HASH_CAP,), "cuda"),
             torch.zeros(1, dtype=torch.int64, device="cuda"))
    ms, _ = timed(lambda: hk.hash_insert(*kern, kmers))
    plain_ms, _ = timed(lambda: hk.insert_plain(*plain, kmers))
    err, distinct = same_rows(torch, "hash_insert", kern, plain,
                              f"the k={k} batch")
    total = int(hk.as_u32(hk.slot_counts(kern[0])).sum())
    require(total == n_valid, f"hash_insert at k={k}: n_total {total} != "
            f"{n_valid}")
    record["hash_insert"] = {"max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms}
    print(f"hash_insert at k={k}: exact on {HASH_READS} reads' {n_valid} "
          f"valid k-mers, {distinct} keys; {ms:.4f} ms vs {plain_ms:.4f} ms "
          f"plain on {card}", flush=True)
    live, _ = table_rows(torch, kern[0])
    rng = np.random.default_rng(k)
    queries = torch.cat([
        revcomp(live[: LOOKUP_MANY // 2], k),
        torch.from_numpy(rng.integers(0, 1 << (2 * k), LOOKUP_MANY // 2,
                                      dtype=np.int64)).cuda()]).contiguous()
    ms, got = timed(lambda: hk.hash_lookup(kern[0], queries, k))
    plain_ms, want = timed(lambda: hk.lookup_plain(kern[0], queries, k))
    require(torch.equal(got, want),
            f"hash_lookup at k={k}: counts differ from plain")
    require(bool((got[: LOOKUP_MANY // 2] != 0).all()),
            f"hash_lookup at k={k}: a table key's reverse complement missed")
    record["hash_lookup"] = {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms}
    print(f"hash_lookup at k={k}: exact on {queries.numel()} directional "
          f"queries; {ms:.4f} ms vs {plain_ms:.4f} ms plain on {card}",
          flush=True)
    from sharkmer_tpu_torch.ops.hashtable import KmerTable

    gen = torch.Generator(device="cuda").manual_seed(k)
    wave_checks(torch, np, KmerTable(k, *kern, kern[0].device),
                f"the k={k} table", gen)
    del kern, plain
    torch.cuda.empty_cache()
    return record


def reference_dirs(out: str, sample: str, spectra, n_kmers: int, k: int,
                   dirs: dict) -> None:
    """The expected outputs of the k=31 runs at one depth, from the first
    run's output directory ``out``: its ``stats.yaml`` must hold the
    reference's ``n_kmers``, ``n_singleton_kmers`` (final bin 1) and
    ``n_multi_kmers`` (``n_kmers`` less those); then each directory of
    ``dirs`` (``--chunks`` N -> path) gets the reference's ``.histo`` and
    ``.final.histo`` for N chunks (the final spectrum alone for one), the
    run's FASTA, and its ``stats.yaml`` with ``chunks`` N."""
    import yaml

    with open(os.path.join(out, f"{sample}.stats.yaml")) as f:
        stats = yaml.safe_load(f)
    singletons = int(spectra[-1][1])
    want = {"n_kmers": n_kmers, "n_singleton_kmers": singletons,
            "n_multi_kmers": n_kmers - singletons}
    got = {key: stats.get(key) for key in want}
    require(got == want, f"{out}: stats.yaml's counts {got} are not the "
            f"reference's {want}")
    fasta = [f for f in os.listdir(out) if f.endswith(".fasta")]
    require(fasta, f"{out}: no FASTA")
    for n_chunks, path in dirs.items():
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
        for name in fasta:
            shutil.copy(os.path.join(out, name), path)
        write_spectra(path, sample, spectra if n_chunks > 1 else spectra[-1:],
                      k, n_chunks)
        with open(os.path.join(path, f"{sample}.stats.yaml"), "w") as f:
            yaml.safe_dump(dict(stats, chunks=n_chunks), f, sort_keys=False)


def long_k_phase(ctx, np, runs: dict, card: str) -> dict:
    """Phase 23: k = 31, where no count fits beside a key. (0)
    ``long_k_kernels``. (a) ``--chunks 10`` on the first CHUNK_READS reads,
    sorted and ``--backend hash``, each byte-identical to the JAX
    package's LONG_K_ORACLE. (b) LONG_K_RUNS at 8M reads: every ``.histo``
    and ``.final.histo`` byte-identical to ``chunk_spectra_reference``'s
    (10 chunks; its last spectrum is the whole run's), FASTA
    byte-identical across the runs (the store with the reach closure, the
    hash kernels with ``hash_lookup`` a wave, since the table's ~2.6e8
    keys pass MIRROR_MAX_UNIQUE and no host mirror is built, and the
    chunk merges of both) and ``stats.yaml`` equal but for ``command``,
    ``peak_memory_bytes`` and ``chunks``, its k-mer counts the
    reference's. (c) The same at 1M reads, where ``--mirror full``
    builds the host mirror and ``--chunks 1 --n-shards 4`` runs the
    sharded store. When a run's outputs differ, the chunks whose
    spectrum differs are printed first. Returns ``long_k_kernels``'
    record."""
    from sharkmer_tpu_torch.pcr.counts import MIRROR_MAX_UNIQUE

    torch = ctx.torch
    record = long_k_kernels(torch, np, card)
    for backend in ("sorted", "hash"):
        label = f"k31_chunks_{backend}_250k"
        runs[label] = drive_main_path(
            ctx, label, CHUNK_READS, ("--chunks", "10", "--backend", backend),
            oracle=LONG_K_ORACLE, k=LONG_K)
        torch.cuda.empty_cache()
    got = (runs["k31_chunks_hash_250k"][0]["hash_exports"],
           runs["k31_chunks_hash_250k"][0]["shard_exports"])
    require(got == (1, 0), f"k31_chunks_hash_250k: KmerTable and "
            f"ShardedKmerTable.to_sorted_arrays ran {got} times, not (1, 0)")
    for n_reads, todo in LONG_K_RUNS.items():
        n_chunks = max(c for _, c, _ in todo)
        start = time.monotonic()
        spectra, n_kmers = chunk_spectra_reference(
            FASTQ, n_reads, n_chunks, LONG_K, HISTO_MAX, "cuda")
        print(f"reference, {n_reads} reads, k={LONG_K}, {n_chunks} chunks: "
              f"{time.monotonic() - start:.3f} s, {n_kmers} k-mers, "
              f"{int(spectra[-1][1:].sum())} distinct, "
              f"{int(spectra[-1][1])} singletons", flush=True)
        torch.cuda.empty_cache()
        sample = f"synthetic-seed0_{n_reads}"
        dirs = {c: os.path.join(OUT_DIR, f"expected_k31_{n_reads}_chunks{c}")
                for _, c, _ in todo}
        for i, (label, chunks, extra) in enumerate(todo):
            first = (lambda out, sample: reference_dirs(
                out, sample, spectra, n_kmers, LONG_K, dirs)) if i == 0 \
                else None
            try:
                runs[label] = drive_main_path(
                    ctx, label, n_reads, ("--chunks", str(chunks), *extra),
                    oracle=dirs[chunks], k=LONG_K, before_check=first)
            except RuntimeError:
                want = spectra if chunks > 1 else spectra[-1:]
                differ = spectra_diff(os.path.join(OUT_DIR, label), sample,
                                      want)
                print(f"{label}: the chunks whose spectrum differs from the "
                      f"reference's: {differ}", flush=True)
                raise
            torch.cuda.empty_cache()
        # past MIRROR_MAX_UNIQUE keys (pcr/counts.py) neither the hash
        # table's --mirror auto nor --mirror full builds the host mirror:
        # each extension wave is a lookup on the card instead
        distinct = int(spectra[-1][1:].sum())
        mirrored = distinct <= MIRROR_MAX_UNIQUE
        how = ("the host mirror" if mirrored
               else "a lookup on the card a wave, no host mirror")
        for label, _, extra in todo:
            counts = runs[label][0]
            if "--backend" in extra:  # host mirror builds, lookup waves
                got = (counts["hash_exports"], counts["lookup_waves"] > 0)
                want = (int(mirrored), not mirrored)
            elif "--mirror" in extra:
                got, want = counts["mirror_builds"], int(mirrored)
            else:
                continue
            require(got == want, f"{label}: {got}, not {want}, for {distinct} "
                    f"keys against MIRROR_MAX_UNIQUE {MIRROR_MAX_UNIQUE}")
            print(f"{label}: {distinct} keys: {how} (MIRROR_MAX_UNIQUE "
                  f"{MIRROR_MAX_UNIQUE})", flush=True)
    return record


def check_long_k_runs(runs) -> None:
    """Phase 23's runs beside ``required_launches``: ``stitch_rows`` never
    (no count field beside a k=31 key: no drain v2); each hash run as
    ``check_hash_run`` (its host mirror or lookups as ``long_k_phase``
    checks); each sorted run no hash kernel. (The unsharded 1M runs
    launch no ``run_starts``: their k-mers fill one ghosted drain.)"""
    for label in (label for label in runs if label.startswith("k31_")):
        counts = runs[label][0]
        require(counts["stitch_rows"] == 0,
                f"stitch_rows was launched {counts['stitch_rows']} times in "
                f"the {label} run")
        if "hash" in label:
            check_hash_run(runs, label, 1)
            continue
        require(not counts["hash_insert"],
                f"hash_insert was launched in the {label} run")


class _Stdin:
    """``sys.stdin`` as the CLI reads it: a binary ``buffer``, not a
    terminal."""

    def __init__(self, stream):
        self.buffer = stream

    def isatty(self) -> bool:
        return False


def entry_inputs() -> dict:
    """Phase 24's inputs in OUT_DIR from the first M reads of the cnidaria
    FASTQ (gzip, level 1): R1 the reads at even positions and R2 those at
    odd ones (so that ``--paired`` takes them back in the file's order),
    part1 and part2 the first and second half."""
    import gzip

    paths = {name: os.path.join(OUT_DIR, f"entries_{name}.fastq.gz")
             for name in ENTRY_FILES}
    outs = {name: gzip.open(path, "wb", compresslevel=1)
            for name, path in paths.items()}
    try:
        with gzip.open(FASTQ, "rb") as src:
            lines = []
            for i in range(M):
                lines.append(b"".join(next(src) for _ in range(4)))
                if len(lines) == 10_000 or i == M - 1:
                    base = i + 1 - len(lines)
                    outs["R1"].write(b"".join(lines[(-base) % 2 :: 2]))
                    outs["R2"].write(b"".join(lines[1 - base % 2 :: 2]))
                    cut = min(max(M // 2 - base, 0), len(lines))
                    outs["part1"].write(b"".join(lines[:cut]))
                    outs["part2"].write(b"".join(lines[cut:]))
                    lines = []
    finally:
        for f in outs.values():
            f.close()
    return paths


def entries_phase(ctx, runs: dict) -> None:
    """Phase 24: the 1M cnidaria cell through the record-stream entries,
    each byte-identical to the committed cell: from stdin (the gzip stream
    of the 8M FASTQ in ``sys.stdin``, ``-m`` 1M), ``--paired R1 R2``, two
    gzip files through the native loader, and the one FASTQ with
    ``--validate-every`` VALIDATE_EVERY. Each must launch phase 4's
    kernels (``required_launches``) and no hash kernel; each prints its
    ingest wall beside phase 4's."""
    import gzip

    start = time.monotonic()
    paths = entry_inputs()
    names = ", ".join(os.path.relpath(p, HERE) for p in paths.values())
    print(f"entry inputs {names}: {time.monotonic() - start:.3f} s",
          flush=True)
    stdin = sys.stdin
    sys.stdin = _Stdin(gzip.open(FASTQ, "rb"))
    try:
        runs["entry_stdin"] = drive_main_path(ctx, "entry_stdin", M,
                                              ("-m", str(M)), fastq=False)
    finally:
        sys.stdin.buffer.close()
        sys.stdin = stdin
    runs["entry_paired"] = drive_main_path(
        ctx, "entry_paired", M, ("--paired", paths["R1"], paths["R2"]),
        fastq=False)
    runs["entry_two_files"] = drive_main_path(
        ctx, "entry_two_files", M, (paths["part1"], paths["part2"]),
        fastq=False)
    runs["entry_validate"] = drive_main_path(
        ctx, "entry_validate", M, ("--validate-every", VALIDATE_EVERY))

    def ingest(label):
        return float(runs[label][1].split("ingest ")[1].split(" s")[0])

    for label in ("entry_stdin", "entry_paired", "entry_two_files",
                  "entry_validate"):
        counts = runs[label][0]
        for name in ("hash_insert", "hash_lookup"):
            require(not counts[name], f"{name} was launched in the {label} "
                    f"run")
        print(f"{label}: ingest {ingest(label):.3f} s vs "
              f"{ingest('default'):.3f} s through the native loader (phase 4)",
              flush=True)


def panel_labels() -> dict:
    """Phase 25's run labels: {"sorted": the runs on the sorted store's
    reach closure, "deep": those of them past the oracles' depth (drain
    v2), "full": insecta's ``--mirror full`` run, "hash": the
    ``--backend hash`` runs}."""
    labels = {"sorted": [], "deep": [], "full": ["panels_full_insecta_1M"],
              "hash": ["panels_hash_insecta_1M"]}
    for panel in BUILTIN_SEEDS:
        labels["sorted"].append(f"panels_{panel}_250k")
        labels["hash"].append(f"panels_hash_{panel}_250k")
        for n_reads in PANEL_DEPTHS[panel]:
            labels["deep"].append(f"panels_{panel}_{n_reads // M}M")
    labels["sorted"] += labels["deep"]
    return labels


def fasta_seqs(path: str) -> list[str]:
    """The sequences of a FASTA file."""
    seqs = []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                seqs.append("")
            elif seqs:
                seqs[-1] += line.strip()
    return seqs


def amplified(out: str, sample: str) -> tuple[set, int]:
    """(the genes ``out``'s ``stats.yaml`` amplified, its primer pairs)."""
    import yaml

    with open(os.path.join(out, f"{sample}.stats.yaml")) as f:
        results = yaml.safe_load(f)["pcr_results"]
    return ({r["gene_name"] for r in results if r["status"] == "success"},
            len(results))


def amplicon_distance(np, product: str, amplicon: str) -> int:
    """The fewest substitutions that put ``product`` inside ``amplicon``,
    on either strand (its length if it is longer)."""
    if len(product) > len(amplicon):
        return len(product)
    rc = str.maketrans("ACGT", "TGCA")
    amp = np.frombuffer(amplicon.encode(), np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(amp, len(product))
    return min(int((windows != np.frombuffer(s.encode(), np.uint8))
                   .sum(axis=1).min())
               for s in (product, product.translate(rc)[::-1]))


def check_amplicons(label: str, out: str, sample: str, panel: str,
                    genes: set) -> None:
    """A run past the oracles' depth, held to an independent reference:
    every gene of ``genes`` (those its panel's JAX oracle amplified)
    amplified, each with a product within its pair's [min_length,
    max_length] that lies inside an amplicon ``tools/synth.py`` embedded
    (either strand) up to AMPLICON_SUBST of its bases: the consensus of
    reads with that rate of substitutions. The amplicon is its own
    pair's, or, where a panel's pairs share primer sites (bacteria's 16S
    pairs), another pair's, which the mismatch-tolerant primer match
    also finds. Prints the genes whose products lie only in another
    pair's amplicon, and each gene's substitutions."""
    import numpy as np

    from sharkmer_tpu_torch.pcr.panels import get_panel
    from sharkmer_tpu_torch.tools.synth import panel_amplicons

    params = {p.gene_name: p for p in get_panel(panel)}
    # synth names a gene as the panel file does; the CLI prefixes the panel
    amplicons = {f"{panel}_{gene}": amp for gene, amp in
                 panel_amplicons(PANELS[panel], seed=SEEDS[panel]).items()}
    done, n_pairs = amplified(out, sample)
    require(genes <= done, f"{label}: the oracle's genes "
            f"{sorted(genes - done)} not amplified")
    best, elsewhere = {}, {}
    for gene in sorted(done):
        p = params[gene]
        # (substitutions, not its own pair's, host) of each product that
        # lies inside an amplicon; the fewest, its own pair's first
        fits = [(d, host != gene, host)
                for s in fasta_seqs(os.path.join(out, f"{sample}_{gene}"
                                                 f".fasta"))
                if p.min_length <= len(s) <= p.max_length
                for host, amp in amplicons.items()
                for d in (amplicon_distance(np, s, amp),)
                if d <= len(s) * AMPLICON_SUBST]
        if fits:
            d, other, host = min(fits)
            best[gene] = d
            if other:
                elsewhere[gene] = host
    require(genes <= set(best), f"{label}: no product inside an embedded "
            f"amplicon for {sorted(genes - set(best))}")
    print(f"{label}: {len(done)}/{n_pairs} genes amplified; each of the "
          f"oracle's {len(genes)} with a product inside an embedded "
          f"amplicon (substitutions {best}; only in another pair's: "
          f"{elsewhere}); beyond the oracle's: {sorted(done - genes)} "
          f"({sorted((done - genes) - set(best))} outside every amplicon)",
          flush=True)


def panels_phase(ctx, runs: dict) -> None:
    """Phase 25: the built-in panels of BUILTIN_SEEDS by name, each from
    its own synthetic FASTQ. (a) The first PANEL_ORACLE_READS reads,
    sorted (``--mirror auto``, the reach closure) and ``--backend hash``,
    each byte-identical to the panel's JAX oracle in ``oracles/``. (b)
    Each depth of PANEL_DEPTHS (1M; insecta also 8M), sorted, held to the
    embedded amplicons (``check_amplicons``) for every gene the oracle
    amplified; insecta's 1M run again under INSECTA_1M (``--mirror
    full``, ``--backend hash``), byte-identical to its sorted run. Each
    run prints its stage walls, every card's peak, its launches, its
    ``panel_scan`` calls (widths, retries), its closure calls and
    retries, and its genes amplified of the panel's pairs."""
    torch = ctx.torch
    for panel, seed in BUILTIN_SEEDS.items():
        oracle = os.path.join(HERE, "oracles", panel, f"synthetic-seed{seed}",
                              str(PANEL_ORACLE_READS))
        genes, n_pairs = amplified(
            oracle, f"synthetic-seed{seed}_{PANEL_ORACLE_READS}")
        print(f"{panel}: the JAX oracle amplified {len(genes)}/{n_pairs} "
              f"genes", flush=True)
        for label, extra in ((f"panels_{panel}_250k", ("-vv",)),
                             (f"panels_hash_{panel}_250k",
                              ("--backend", "hash"))):
            torch.cuda.empty_cache()
            runs[label] = drive_main_path(ctx, label, PANEL_ORACLE_READS,
                                          extra, oracle=oracle, panel=panel)
            done, _ = amplified(os.path.join(OUT_DIR, label),
                                f"synthetic-seed{seed}_{PANEL_ORACLE_READS}")
            print(f"{label}: {len(done)}/{n_pairs} genes amplified")
        for n_reads in PANEL_DEPTHS[panel]:
            label = f"panels_{panel}_{n_reads // M}M"
            expected = os.path.join(OUT_DIR, f"expected_{label}")

            def hold(out, sample, label=label, expected=expected):
                """The amplicon check; then the run is its own oracle,
                and that of the runs that follow it at its depth."""
                check_amplicons(label, out, sample, panel, genes)
                shutil.rmtree(expected, ignore_errors=True)
                shutil.copytree(out, expected)

            torch.cuda.empty_cache()
            runs[label] = drive_main_path(ctx, label, n_reads, ("-vv",),
                                          oracle=expected, panel=panel,
                                          before_check=hold)
            if panel == "insecta" and n_reads == M:
                for tag, extra in INSECTA_1M:
                    torch.cuda.empty_cache()
                    other = f"panels_{tag}_insecta_1M"
                    runs[other] = drive_main_path(ctx, other, M, extra,
                                                  oracle=expected,
                                                  panel=panel)


def check_panel_runs(runs) -> None:
    """Phase 25's runs beside ``required_launches``: the sorted runs
    launch no hash kernel, and insecta's batched scan is 2^20 wide; the
    ``--mirror full`` run builds the host mirror once and launches no
    closure; each hash run as ``check_hash_run``, its host mirror built
    once."""
    labels = panel_labels()
    for label in labels["sorted"] + labels["full"]:
        counts = runs[label][0]
        require(not counts["hash_insert"],
                f"hash_insert was launched in the {label} run")
        if "insecta" in label:
            require(counts["scan_width"] == 1 << 20, f"{label}: batched "
                    f"primer scan {counts['scan_width']} wide, not 2^20")
    full = runs["panels_full_insecta_1M"][0]
    require(full["mirror_builds"] == 1 and not full["reach_closure"],
            f"panels_full_insecta_1M: {full['mirror_builds']} host mirrors, "
            f"{full['reach_closure']} reach_closure launches")
    for label in labels["hash"]:
        check_hash_run(runs, label, 1)
        got = (runs[label][0]["hash_exports"], runs[label][0]["shard_exports"])
        require(got == (1, 0), f"{label}: KmerTable and ShardedKmerTable."
                f"to_sorted_arrays ran {got} times, not (1, 0)")


def option_labels() -> dict:
    """Phase 26's run labels: {"sorted": the runs on the sorted store's
    reach closure (KNOB_RUNS among them), "hash": the hash table's,
    "device": those of them under ``--mirror device``}."""
    hashed = [label for label, _, extra, _, _ in OPTION_RUNS
              if "hash" in extra]
    return {"sorted": [label for label, *_ in OPTION_RUNS
                       if label not in hashed]
            + [label for label, *_ in KNOB_RUNS],
            "hash": hashed,
            "device": [label for label, _, extra, _, _ in OPTION_RUNS
                       if "device" in extra]}


def threading_lines(messages) -> list[str]:
    """The THREADING_LINES of a run's log without their walls, sorted
    (the gene threads log in any order)."""
    return sorted(m.split(" Time: ")[0] for m in messages
                  if any(line in m for line in THREADING_LINES))


def paths_found(messages) -> int:
    """The paths a run's walks found, from its ``Found N paths`` lines."""
    return sum(int(m.split("Found ")[1].split(" paths")[0])
               for m in messages if "Found " in m and " paths" in m)


def gene_results(stats_path: str) -> dict:
    """{gene: its failure reason, or None where it was amplified}."""
    import yaml

    with open(stats_path) as f:
        return {r["gene_name"]: r.get("failure_reason")
                for r in yaml.safe_load(f)["pcr_results"]}


def options_phase(ctx, np, runs: dict, card: str) -> dict:
    """Phase 26: the paths of the CLI no other phase runs, each on the
    first OPTIONS_READS reads and byte-identical to its JAX oracle in
    ``oracles/cnidaria/synthetic-seed0/<name>_250000/`` (OPTION_RUNS):
    k = 25 (the JAX reach's packed probe) sorted at the CLI's default
    ``-t`` (one thread: ``run_pcr``'s sequential branch) and hash, k = 27
    (its unpacked probe) sorted and hash; ``--read-threading`` with
    cnidaria's 18S pair inline, its Pass 2 and threading counts those of
    the JAX CLI's log; ``--min-kmer-count 4 --dump-graph`` sorted and
    ``--backend hash --mirror device`` (every ``.dot`` file compared);
    ``--backend hash --table-capacity 2^17``; the graph-walk limits
    (WALK_LIMITS), which must stop genes that the unlimited run of the
    same reads amplifies; then KNOB_RUNS, where ``--max-node-visits`` and
    ``--max-paths-per-pair`` bind. First ``long_k_kernels`` at each k of
    OPTION_KS. Returns ``{k: long_k_kernels' record}``."""
    torch = ctx.torch
    record = {}
    for k in OPTION_KS:
        start = time.monotonic()
        record[k] = long_k_kernels(torch, np, card, k)
        print(f"the kernels at k={k}: {time.monotonic() - start:.1f} s",
              flush=True)
        torch.cuda.empty_cache()
    base = os.path.join(HERE, "oracles", "cnidaria", "synthetic-seed0")
    for label, name, extra, k, threads in OPTION_RUNS:
        torch.cuda.empty_cache()
        oracle = os.path.join(base, f"{name}_{OPTIONS_READS}")
        primers = (("--pcr-primers", SPEC_18S) if name == "read_threading"
                   else None)
        runs[label] = drive_main_path(
            ctx, label, OPTIONS_READS, extra, oracle=oracle, k=k,
            threads=threads, primers=primers)
        if threads is None:
            print(f"{label}: at the CLI's default -t (one thread: the gene "
                  f"pairs in turn, each closure and wave on one thread)",
                  flush=True)
        if name == "read_threading":
            got = threading_lines(ctx.run_log.messages)
            with open(f"{oracle}.threading.txt") as f:
                want = f.read().splitlines()
            require(got == want, f"{label}: the threading log lines {got} "
                    f"are not the JAX CLI's {want}")
            print(f"{label}: {got} as in the JAX CLI's log", flush=True)
        if name == "walk_limits":
            sample = f"synthetic-seed0_{OPTIONS_READS}"
            limited = gene_results(os.path.join(
                OUT_DIR, label, f"{sample}.stats.yaml"))
            free = gene_results(os.path.join(CHUNK_ORACLE,
                                             f"{sample}.stats.yaml"))
            stopped = {gene: reason for gene, reason in limited.items()
                       if reason and free[gene] is None}
            require({"node budget exceeded", "no path found"}
                    <= set(stopped.values()),
                    f"{label}: the limits stopped {stopped} of the genes "
                    f"the unlimited run amplifies")
            abandoned = [m for m in ctx.run_log.messages
                         if "abandoning search" in m]
            print(f"{label}: {WALK_LIMITS} stopped {stopped}; "
                  f"{abandoned}", flush=True)
    found = {}
    for label, name, extra in KNOB_RUNS:
        runs[label] = drive_main_path(
            ctx, label, 0, ("-v", "--dump-graph", *extra,
                            os.path.join(KNOB_DIR, "knobs.fastq")),
            fastq=False, oracle=os.path.join(KNOB_DIR, name), k=21,
            primers=("--pcr-primers", KNOB_SPEC), sample="knobs")
        with open(os.path.join(OUT_DIR, label, "knobs_18s.fasta")) as f:
            products = f.read().count(">")
        found[name] = (paths_found(ctx.run_log.messages), products)
    free = found.pop("free")
    for name, (paths, products) in found.items():
        require(paths < free[0] and products < free[1],
                f"knobs_{name}: {paths} paths found, {products} products "
                f"kept; unlimited {free[0]} and {free[1]}")
    print(f"knobs: (paths found, products kept) unlimited {free}, "
          f"{found}", flush=True)
    return record


def check_option_runs(runs) -> None:
    """Phase 26's runs beside ``required_launches``: the sorted runs
    launch no hash kernel and no ``stitch_rows`` (one ghosted drain at
    this depth, none past k = 21); each hash run as ``check_hash_run``,
    its host mirror built once, but under ``--mirror device`` (none, a
    ``hash_lookup`` a wave); the run at the CLI's default ``-t`` ran every
    gene on the calling thread (``run_pcr``'s sequential branch), a run
    at ``-t 8`` none; the ``--table-capacity`` run's table grew more often
    than the default capacity's in the k = 19 ``--mirror device`` run."""
    labels = option_labels()
    for label, _, _, _, threads in OPTION_RUNS:
        counts = runs[label][0]
        got = (counts["genes_on_caller"], counts["gene_threads"])
        require(got[0] == (threads is None) and got[1] >= 1,
                f"{label} at -t {threads}: genes on the calling thread "
                f"{got[0]}, {got[1]} gene threads")
    grows = [runs[label][0]["hash_grows"] for label in
             ("options_table_capacity", "options_min_count4_device")]
    require(grows[0] > grows[1], f"--table-capacity {1 << 17}: {grows[0]} "
            f"grows, the default capacity {grows[1]}")
    print("phase 26: each run's gene threads and whether every gene ran "
          "on the calling thread: " + ", ".join(
              f"{label} {runs[label][0]['gene_threads']} "
              f"{runs[label][0]['genes_on_caller']}"
              for label, *_ in OPTION_RUNS)
          + f"; hash grows at 2^17 {grows[0]}, by default {grows[1]}",
          flush=True)
    for label in labels["sorted"]:
        counts = runs[label][0]
        require(not counts["hash_insert"] and not counts["stitch_rows"],
                f"{label}: hash_insert {counts['hash_insert']}, "
                f"stitch_rows {counts['stitch_rows']}")
    for label in labels["hash"]:
        check_hash_run(runs, label, 1)
        device = label in labels["device"]
        got = (runs[label][0]["hash_exports"], runs[label][0]["lookup_waves"]
               > 0)
        require(got == (int(not device), device),
                f"{label}: {got[0]} host mirror builds, lookup waves "
                f"{got[1]}")


def run_scan_phase(torch, np, card: str, kernels) -> dict:
    """``run_ends`` and ``run_starts`` against their plain versions and
    ``torch.searchsorted`` (exact), with median times: at 2^27 on
    ``sorted_test_keys`` (the drain width; the record's main row) and on
    all-equal keys, at 2^24 (the 2^24 cell's drain width), and at ragged
    lengths around the kernels' tile, once at a key pointer offset by one
    element. A ragged input is a slice across the start of the 2^24
    keys' sentinel tail. The plain versions at 2^27 and 2^24 (0.36 and
    0.045 s a call, host-bound and steady) are timed one call a turn."""
    from sharkmer_tpu_torch.kernels import run_scan

    library = {
        "run_starts": lambda keys: torch.searchsorted(keys, keys,
                                                      out_int32=True),
        "run_ends": lambda keys: torch.searchsorted(
            keys, keys, right=True, out_int32=True) - 1,
    }
    inputs = {name: {} for name in library}

    def check(what, keys, reps, plain_reps=None):
        for name, lib_call in library.items():
            kernel, plain = kernels[name], getattr(run_scan, f"{name}_plain")
            result = compare(torch, name, lambda: kernel(keys),
                             lambda: plain(keys), reps, card, what,
                             lambda: lib_call(keys), plain_reps)
            # read each 8 B key, write each 4 B position
            inputs[name][what] = {**result, **byte_bound(12 * keys.numel())}

    main_what = f"{KERNEL_N} sorted keys"
    keys = torch.from_numpy(sorted_test_keys(np, KERNEL_N)).cuda()
    check(main_what, keys, 5, 1)
    keys.zero_()
    check(f"{KERNEL_N} equal keys", keys, 5, 1)
    del keys
    torch.cuda.empty_cache()
    n = 1 << 24
    keys = torch.from_numpy(sorted_test_keys(np, n)).cuda()
    check(f"{n} sorted keys", keys, 10, 1)
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


def encode_codes(np, n: int, width: int, seed: int):
    """``[n, width]`` codes as the loader gives them: reads of 5/8 of the
    width or more, a base in 200 an N, runs of 8 Ns in a read in 20, the
    rest of each row pad."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, width), dtype=np.uint8)
    codes[rng.random((n, width)) < 0.005] = 4
    rows = np.flatnonzero(rng.random(n) < 0.05)
    starts = rng.integers(0, max(width - 8, 1), size=rows.size)
    cols = np.minimum(starts[:, None] + np.arange(8), width - 1)
    codes[rows[:, None], cols] = 4
    lens = rng.integers(width * 5 // 8, width + 1, size=n)
    codes[np.arange(width)[None, :] >= lens[:, None]] = 5
    return codes


class GuardedBuffer:
    """``n_bytes`` of device memory with no mapped byte next to either
    end: one allocation of CUDA's virtual memory management mapped alone
    in a reserved range that is a granule wider on each side, the buffer
    placed at the mapping's start or, ``at_end``, ending at its last
    byte. A kernel that reads or writes past the buffer on the guarded
    side faults with an illegal address, where memory from the caching
    allocator would give it a neighbour's bytes. ``view(torch, dtype,
    shape)`` is a tensor on it (``__cuda_array_interface__``);
    ``free()`` unmaps it once the card is done with it."""

    def __init__(self, torch, n_bytes: int, at_end: bool):
        import ctypes

        class Location(ctypes.Structure):
            _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]

        class AllocFlags(ctypes.Structure):
            _fields_ = [("compressionType", ctypes.c_ubyte),
                        ("gpuDirectRDMACapable", ctypes.c_ubyte),
                        ("usage", ctypes.c_ushort),
                        ("reserved", ctypes.c_ubyte * 4)]

        class Prop(ctypes.Structure):
            _fields_ = [("type", ctypes.c_int),
                        ("requestedHandleTypes", ctypes.c_int),
                        ("location", Location),
                        ("win32HandleMetaData", ctypes.c_void_p),
                        ("allocFlags", AllocFlags)]

        class Access(ctypes.Structure):
            _fields_ = [("location", Location), ("flags", ctypes.c_int)]

        u64, size_t = ctypes.c_uint64, ctypes.c_size_t
        self.cu = cu = ctypes.CDLL("libcuda.so.1")
        torch.cuda.synchronize()  # the primary context, current here
        here = Location(1, torch.cuda.current_device())  # a device
        prop = Prop(type=1, location=here)  # pinned, no handle type
        gran = size_t()
        self._ok(cu.cuMemGetAllocationGranularity(ctypes.byref(gran),
                                                  ctypes.byref(prop), 0),
                 "cuMemGetAllocationGranularity")
        g = gran.value
        self.size = max(-(-n_bytes // g), 1) * g
        self.span = self.size + 2 * g
        base, self.handle = u64(), u64()
        self._ok(cu.cuMemAddressReserve(ctypes.byref(base), size_t(self.span),
                                        size_t(g), u64(0), u64(0)),
                 "cuMemAddressReserve")
        self.base = base.value
        self._ok(cu.cuMemCreate(ctypes.byref(self.handle), size_t(self.size),
                                ctypes.byref(prop), u64(0)), "cuMemCreate")
        self.mapped = self.base + g
        self._ok(cu.cuMemMap(u64(self.mapped), size_t(self.size), size_t(0),
                             self.handle, u64(0)), "cuMemMap")
        access = Access(here, 3)  # read and write
        self._ok(cu.cuMemSetAccess(u64(self.mapped), size_t(self.size),
                                   ctypes.byref(access), size_t(1)),
                 "cuMemSetAccess")
        self.ptr = self.mapped + (self.size - n_bytes if at_end else 0)
        self.n_bytes = n_bytes

    @staticmethod
    def _ok(rc: int, what: str) -> None:
        require(rc == 0, f"{what} returned CUresult {rc}")

    def view(self, torch, dtype, shape):
        typestr = {torch.uint8: "|u1", torch.int64: "<i8"}[dtype]
        itemsize = 1 if dtype == torch.uint8 else 8
        n = 1
        for d in shape:
            n *= d
        require(n * itemsize == self.n_bytes,
                f"a {shape} {dtype} view of {self.n_bytes} bytes")
        holder = types.SimpleNamespace(__cuda_array_interface__={
            "shape": tuple(shape), "typestr": typestr, "strides": None,
            "data": (self.ptr, False), "version": 2})
        return torch.as_tensor(holder, device="cuda")

    def free(self) -> None:
        import ctypes

        u64, size_t = ctypes.c_uint64, ctypes.c_size_t
        self._ok(self.cu.cuMemUnmap(u64(self.mapped), size_t(self.size)),
                 "cuMemUnmap")
        self._ok(self.cu.cuMemRelease(self.handle), "cuMemRelease")
        self._ok(self.cu.cuMemAddressFree(u64(self.base), size_t(self.span)),
                 "cuMemAddressFree")


def encode_guarded(torch, codes, k: int, at_end: bool) -> None:
    """``codes`` (uint8 [n, width] on the card) encoded by one launch of
    ``shk_encode`` from a ``GuardedBuffer`` into one, each placed with
    ``at_end``, held to ``canonical_kmers_plain``: keys and both totals.
    Past the guarded end of either buffer lies no mapped byte, so a read
    past the batch or a write past the keys faults."""
    from sharkmer_tpu_torch.kernels import encode
    from sharkmer_tpu_torch.ops.encoding import (CODE_N,
                                                 canonical_kmers_plain)

    n, width = codes.shape
    w = max(width - k + 1, 0)
    src = GuardedBuffer(torch, n * width, at_end)
    guarded = src.view(torch, torch.uint8, (n, width))
    guarded.copy_(codes)
    dst = GuardedBuffer(torch, 8 * n * w, at_end) if w else None
    keys = (dst.view(torch, torch.int64, (n, w)) if dst else
            torch.empty((n, 0), dtype=torch.int64, device="cuda"))
    keys.fill_(-1)
    totals = torch.zeros(2, dtype=torch.int64, device="cuda")
    p = encode.plan(width, k)
    rc = encode._lib().shk_encode(
        guarded.data_ptr(), keys.data_ptr(), totals.data_ptr(), n, width, k,
        p.tile, p.n_tiles, p.seg_per_block, p.slot_words,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()  # a read or write past a guard raises here
    what = (f"[{n}, {width}] at k={k}, guarded "
            f"{'after its last' if at_end else 'before its first'} byte")
    require(rc == 0, f"encode: launch failed (cudaError {rc}) on {what}")
    want, valid = canonical_kmers_plain(codes, k)
    require(torch.equal(keys, want), f"encode: keys differ on {what}")
    want_totals = [int(valid.sum()), int((codes < CODE_N).sum())]
    require(totals.tolist() == want_totals,
            f"encode: totals {totals.tolist()} vs {want_totals} on {what}")
    del guarded, keys
    torch.cuda.synchronize()
    src.free()
    if dst:
        dst.free()


def encode_phase(torch, np, card: str) -> dict:
    """The encode kernel (``kernels/encode.encode``) against
    ``canonical_kmers_plain`` on the card: keys exact, and its two totals
    (valid windows, codes below 4) equal to the plain mask's and a count
    of the codes. At the main path's ``ENCODE_SHAPE`` and K, timed
    beside the plain version with its byte bound (the codes read once,
    the keys written once); then at every k of ENCODE_KS on each width
    of ENCODE_WIDTHS and 160, batches narrower than k (no key, the bases
    added), single long reads cut into tiles that overlap by k - 1 (an N
    run across a seam), a batch whose rows start off the 16 B loads'
    alignment, and batches held in a ``GuardedBuffer`` against either end
    of their mapping (``encode_guarded``)."""
    from sharkmer_tpu_torch.kernels import encode
    from sharkmer_tpu_torch.ops.encoding import (CODE_N,
                                                 canonical_kmers_plain)

    def check(what, codes, k):
        totals = torch.zeros(2, dtype=torch.int64, device="cuda")
        before = encode.encode.launches
        keys = encode.encode(codes, k, totals)
        want, valid = canonical_kmers_plain(codes, k)
        torch.cuda.synchronize()
        require(encode.encode.launches == before + 1,
                f"encode: {encode.encode.launches - before} launches on "
                f"{what}")
        require(keys.shape == want.shape and torch.equal(keys, want),
                f"encode: keys differ from plain on {what}")
        want_totals = [int(valid.sum()), int((codes < CODE_N).sum())]
        require(totals.tolist() == want_totals,
                f"encode: totals {totals.tolist()} vs {want_totals} on "
                f"{what}")
        return want_totals

    n, width = ENCODE_SHAPE
    codes = torch.from_numpy(encode_codes(np, n, width, 5)).cuda()
    what = f"[{n}, {width}] codes at k={K}"
    totals = check(what, codes, K)
    w = width - K + 1
    record = compare(torch, "encode", lambda: encode.encode(codes, K),
                     lambda: canonical_kmers_plain(codes, K)[0], 20, card,
                     what, plain_reps=5)
    record.update(byte_bound(n * width + 8 * n * w), kmers=totals[0],
                  bases=totals[1])
    del codes
    checked = []
    for k in ENCODE_KS + (K,):
        for width in ENCODE_WIDTHS + (160,):
            rows = max(1, (1 << 21) // width)
            codes = torch.from_numpy(
                encode_codes(np, rows, width, k * width)).cuda()
            check(f"[{rows}, {width}] at k={k}", codes, k)
            checked.append((k, width))
        if k > 1:
            narrow = torch.from_numpy(encode_codes(np, 1000, k - 1, k)).cuda()
            check(f"[1000, {k - 1}] (narrower than k={k})", narrow, k)
    for width, k in ((20_000, K), (9000, 31), (4097, 1)):
        long = encode_codes(np, 1, width, width)
        long[0, :] = np.random.default_rng(k).integers(0, 4, width)
        long[0, encode.LONG_TILE - 3:encode.LONG_TILE + 2] = 4  # a seam
        check(f"one read of {width} codes at k={k}",
              torch.from_numpy(long).cuda(), k)
    flat = torch.from_numpy(encode_codes(np, 4097, 160, 9).reshape(-1)).cuda()
    shifted = flat[1:1 + 4096 * 160].view(4096, 160)
    require(shifted.data_ptr() % 16 == 1, "the shifted codes are aligned")
    check("[4096, 160] codes 1 B past a 16 B boundary", shifted, K)
    del flat, shifted
    # each batch and its keys alone in a mapping, against either end of it
    guarded = [((n, width), K, 5), ((4099, 33), 31, 6), ((1000, K - 1), K, 7),
               ((1, 20_000), K, 8), ((1, 9000), 31, 9)]
    for (rows, cols), k, seed in guarded:
        codes = torch.from_numpy(encode_codes(np, rows, cols, seed)).cuda()
        for at_end in (True, False):
            encode_guarded(torch, codes, k, at_end)
    print(f"encode: exact with both totals at k x width {checked}, "
          f"narrower than each k, three long reads and off-alignment rows; "
          f"no read or write past the batch or its keys on "
          f"{[shape for shape, _, _ in guarded]}, each guarded after its "
          f"last byte and before its first, on {card}", flush=True)
    return record


def kernel_phase(torch, np, card: str, kernels) -> dict:
    from sharkmer_tpu_torch.kernels import stitch

    record = run_scan_phase(torch, np, card, kernels)
    record["encode"] = encode_phase(torch, np, card)
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


def first_batch_kmers(torch, np, k: int = K):
    """The port's canonical ``k``-mers of the FASTQ's first HASH_READS
    reads, as one ingest batch of the CLI hands them to the table (flat,
    with the sentinels of invalid windows), and the count of valid
    ones."""
    from sharkmer_tpu_torch.io import native
    from sharkmer_tpu_torch.ops.encoding import canonical_kmers

    require(native.available(), "the native FASTQ reader did not build")
    with native.NativeFastqReader(FASTQ) as reader:
        codes, _ = reader.read_batch(HASH_READS)
    require(codes.shape[0] == HASH_READS,
            f"read {codes.shape[0]} of {HASH_READS} reads in one batch")
    kmers = canonical_kmers(
        torch.from_numpy(np.ascontiguousarray(codes)).cuda(), k)
    return kmers.reshape(-1).contiguous(), int((kmers != INT64_MAX).sum())


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


def wave_pool(torch, table, gen):
    """LOOKUP_MANY keys of ``table`` (a ``KmerTable`` or
    ``ShardedKmerTable``) drawn at random, on its launching device."""
    from sharkmer_tpu_torch.kernels import hash as hk

    groups = getattr(table, "group_slots", None) or [table.slots]
    keys = torch.cat([hk.slot_keys(g).reshape(-1).to(table.device)
                      for g in groups])
    keys = keys[keys != INT64_MAX]
    pick = torch.randint(0, keys.numel(), (LOOKUP_MANY,), device=keys.device,
                         generator=gen)
    return keys[pick]


def wave_queries(torch, np, pool, k: int, n: int, gen):
    """A wave of ``n`` directional queries as the graph extension hands
    them over (numpy uint64): half keys of the table from ``pool``,
    every other one as its reverse complement, half random keys; with 2
    queries or more, one KMER_SENTINEL and one INT64_MAX among them."""
    from sharkmer_tpu_torch.ops.histogram import revcomp

    half = n // 2
    pick = pool[torch.randint(0, pool.numel(), (half,), device=pool.device,
                              generator=gen)]
    pick[::2] = revcomp(pick[::2], k)
    absent = torch.randint(0, 1 << (2 * k), (n - half,), device=pool.device,
                           generator=gen)
    q = torch.cat([pick, absent]).cpu().numpy().view(np.uint64).copy()
    if n >= 2:
        q[0], q[-1] = KMER_SENTINEL, INT64_MAX
    return q


def wave_plain(torch, np, table, q):
    """``lookup_plain``'s counts (numpy uint32) of the wave ``q`` on
    ``table``'s slots, on the card, the queries through the key codec."""
    from sharkmer_tpu_torch.kernels import hash as hk
    from sharkmer_tpu_torch.ops.keys import keys_to_device

    groups = getattr(table, "group_slots", None)
    slots = (table.slots if groups is None else
             groups[0] if len(groups) == 1 else groups)
    out = hk.lookup_plain(slots, keys_to_device(q, table.device), table.k)
    return out.cpu().numpy().view(np.uint32)


def thread_waves(table, waves, want=None) -> tuple[float, list]:
    """WAVE_THREADS threads, started together after one untimed wave
    each, each issuing every wave of ``waves`` through
    ``table.lookup_directional`` (thread t from wave t on): waves a
    second in all, and the (thread, wave) pairs whose answer differs
    from ``want``'s, where given."""
    import threading

    barrier = threading.Barrier(WAVE_THREADS + 1)
    bad = []

    def issue(t: int) -> None:
        # the thread's first wave makes its stream and buffers: untimed
        table.lookup_directional(waves[t % len(waves)])
        barrier.wait()
        for i in range(len(waves)):
            j = (i + t) % len(waves)
            got = table.lookup_directional(waves[j])
            if want is not None and not (got == want[j]).all():
                bad.append((t, j))

    threads = [threading.Thread(target=issue, args=(t,))
               for t in range(WAVE_THREADS)]
    for thread in threads:
        thread.start()
    barrier.wait()
    start = time.perf_counter()
    for thread in threads:
        thread.join()
    return WAVE_THREADS * len(waves) / (time.perf_counter() - start), bad


def wave_checks(torch, np, table, label: str, gen) -> None:
    """The wave path (``lookup_directional``: numpy in, numpy out, one
    ``shk_hash_lookup_wave`` call) against ``lookup_plain`` on the card
    at WAVE_SIZES, each non-empty wave one ``hash_lookup`` launch; then
    WAVE_THREADS threads issuing THREAD_WAVES waves each at once, every
    answer exact."""
    from sharkmer_tpu_torch.kernels import hash as hk

    pool = wave_pool(torch, table, gen)
    for n in WAVE_SIZES:
        q = wave_queries(torch, np, pool, table.k, n, gen)
        want = wave_plain(torch, np, table, q)
        before = hk.hash_lookup.launches
        got = table.lookup_directional(q)
        require(got.dtype == np.uint32 and got.shape == (n,)
                and (got == want).all(),
                f"hash_lookup: a {n}-query wave ({label}) differs from "
                f"lookup_plain")
        require(hk.hash_lookup.launches - before == int(n > 0),
                f"hash_lookup: a {n}-query wave launched "
                f"{hk.hash_lookup.launches - before} times")
        found = int((want != 0).sum())
        # the table's keys but the one the first sentinel replaced
        require(found >= n // 2 - 1, f"hash_lookup: {found} of {n} found")
    sizes = np.random.default_rng(7).integers(1, 2 * LOOKUP_WAVE,
                                              THREAD_WAVES)
    waves = [wave_queries(torch, np, pool, table.k, int(n), gen)
             for n in sizes]
    want = [wave_plain(torch, np, table, q) for q in waves]
    rate, bad = thread_waves(table, waves, want)
    require(not bad, f"hash_lookup: {len(bad)} waves of {WAVE_THREADS} "
            f"threads differ from lookup_plain ({label})")
    print(f"hash_lookup wave path: exact against lookup_plain on {label}, "
          f"k={table.k}: waves of {', '.join(map(str, WAVE_SIZES))} "
          f"queries (both sentinels in each of 2 or more), one launch "
          f"each; {WAVE_THREADS} threads x {THREAD_WAVES} waves at once "
          f"exact ({rate:.0f} waves/s)", flush=True)


def late_wave(torch, np, table, gen) -> None:
    """The wave stream's ordering: ``table``'s slots copied into a
    cleared table behind ``torch.cuda._sleep`` (SLEEP_CYCLES) on the
    current stream, the new ``KmerTable`` on them looked up at once
    through the wave path (its own stream; the table's ``WriteFence``
    orders it after the copy), at LOOKUP_WAVE and LOOKUP_MANY queries:
    exact against the wave on the source table. A wave that did not wait
    would read empty slots."""
    from sharkmer_tpu_torch.kernels import hash as hk
    from sharkmer_tpu_torch.ops.hashtable import KmerTable

    pool = wave_pool(torch, table, gen)
    for n in (LOOKUP_WAVE, LOOKUP_MANY):
        q = wave_queries(torch, np, pool, table.k, n, gen)
        want = table.lookup_directional(q)
        slots = hk.new_slots(table.slots.shape[:-1], table.device)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        slots.copy_(table.slots)
        late = KmerTable(table.k, slots, table.claims.clone(), table.device)
        start = time.perf_counter()
        got = late.lookup_directional(q)
        wall = (time.perf_counter() - start) * 1e3
        require((got == want).all() and (want != 0).sum() >= n // 2 - 1,
                f"hash_lookup: a {n}-query wave read a table written late "
                f"on the current stream")
        print(f"hash_lookup wave path: exact on a {n}-query wave of a table "
              f"written behind torch.cuda._sleep({SLEEP_CYCLES}) on the "
              f"current stream (the wave took {wall:.1f} ms: it waited)",
              flush=True)
        del late, slots
    torch.cuda.empty_cache()


def wave_times(torch, np, card: str, table, sizes, label: str, gen) -> dict:
    """Host-clock ms (the median of 200 calls, 20 past LOOKUP_WAVE
    queries, after a warm one) at each of ``sizes``: one wave numpy to
    numpy (``lookup_directional``); its foreign call alone
    (``shk_hash_lookup_wave`` on the staged wave: the launch and the
    synchronisation), and that call with no query (ctypes and the
    call's own checks); then waves of ``sizes[0]`` queries a second,
    THREAD_WAVES from one thread and from WAVE_THREADS threads at
    once."""
    from sharkmer_tpu_torch.kernels import hash as hk

    def median_wall(fn, reps: int) -> float:
        walls = []
        for _ in range(reps):
            start = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - start) * 1e3)
        return statistics.median(walls)

    pool = wave_pool(torch, table, gen)
    rec = {}
    for n in sizes:
        q = wave_queries(torch, np, pool, table.k, n, gen)
        reps = 200 if n <= LOOKUP_WAVE else 20
        table.lookup_directional(q)
        times = {"wave": median_wall(lambda: table.lookup_directional(q),
                                     reps)}
        # the foreign call alone on the wave as staged, and with no query
        waves = table._waves
        lib, index = waves.lib, waves.device.index
        state = hk._wave_stream(lib, waves.device)
        state.stage(lib, n)
        state.q[:n] = q
        for name, size in (("call", n), ("empty call", 0)):
            times[name] = median_wall(
                lambda size=size: require(lib.shk_hash_lookup_wave(
                    index, *waves.table, table.k, size, *state.mapped,
                    state.stream) == 0, "hash_lookup: the wave failed"),
                reps)
        print(f"hash_lookup wave, {label}: {n} queries numpy to numpy "
              f"{times['wave']:.4f} ms (its foreign call alone "
              f"{times['call']:.4f} ms, with no query "
              f"{times['empty call']:.4f} ms) on {card}", flush=True)
        rec[str(n)] = times
    waves = [wave_queries(torch, np, pool, table.k, sizes[0], gen)
             for _ in range(THREAD_WAVES)]
    start = time.perf_counter()
    for q in waves:
        table.lookup_directional(q)
    one = len(waves) / (time.perf_counter() - start)
    rate, _ = thread_waves(table, waves)
    print(f"hash_lookup wave, {label}: {sizes[0]}-query waves a second: "
          f"{one:.0f} from one thread, {rate:.0f} from {WAVE_THREADS} "
          f"threads at once on {card}", flush=True)
    rec["waves_per_s"] = {"one thread": one, f"{WAVE_THREADS} threads": rate}
    return rec


def cli_wave_times(ctx, card: str, label: str) -> dict:
    """``wave_times`` on the table of the run just driven (``label``),
    at its median and largest wave, LOOKUP_WAVE and LOOKUP_MANY queries;
    the table is then let go."""
    torch = ctx.torch
    import numpy as np

    waves = sorted(n for n in ctx.lookup_waves if n)
    require(waves and ctx.lookup_table is not None,
            f"{label}: no lookup wave to time")
    sizes = [waves[len(waves) // 2], waves[-1], LOOKUP_WAVE, LOOKUP_MANY]
    gen = torch.Generator(device=ctx.lookup_table.device).manual_seed(9)
    try:
        return wave_times(torch, np, card, ctx.lookup_table, sizes,
                          f"{label}'s table", gen)
    finally:
        ctx.lookup_table = None
        torch.cuda.empty_cache()


def waves_alone(torch, np, card: str) -> None:
    """``--waves``: the wave path on tables of 2^25 random canonical keys
    in HASH_CAP slots: ``wave_checks`` on one table, HASH_SHARDS shards
    and HASH_SHARDS groups on the card (the pointer table) at k = K and
    on one table at LONG_K, ``late_wave``, and ``wave_times`` at 4^0 to
    4^10 queries on the one table at K."""
    from sharkmer_tpu_torch.device import device_list
    from sharkmer_tpu_torch.ops.hashtable import KmerTable
    from sharkmer_tpu_torch.ops.histogram import revcomp
    from sharkmer_tpu_torch.parallel.sharded_table import ShardedKmerTable

    gen = torch.Generator(device="cuda").manual_seed(17)
    for k in (K, LONG_K):
        keys = torch.randint(0, 1 << (2 * k), (1 << 25,), device="cuda",
                             generator=gen)
        keys = torch.minimum(keys, revcomp(keys, k))
        what = f"{keys.numel()} random keys"
        one = KmerTable.create(k, HASH_CAP, "cuda").insert_kmers(keys)
        wave_checks(torch, np, one, f"one table of {what}", gen)
        if k == LONG_K:
            break
        late_wave(torch, np, one, gen)
        wave_times(torch, np, card, one, [4 ** i for i in range(11)],
                   f"one table of {what}", gen)
        del one
        for devices in (["cuda"], ["cuda:0"] * HASH_SHARDS):
            table = ShardedKmerTable.create(k, HASH_SHARDS,
                                            HASH_CAP // HASH_SHARDS,
                                            device_list(devices))
            wave_checks(torch, np, table.insert_kmers(keys),
                        f"{HASH_SHARDS} shards in {len(devices)} group(s) "
                        f"of {what}", gen)
            del table
        torch.cuda.empty_cache()


def hash_phase(torch, np, card: str, latency: dict) -> dict:
    """``hash_insert`` and ``hash_lookup`` against ``insert_plain`` and
    ``lookup_plain`` on the card, on one real ingest batch and the 16 B
    slot layout: the batch into a fresh 2^27-slot table, the batch again
    (all hits), the rehash of a 2^26-slot table holding it into 2^27
    slots, the batch routed by owner into HASH_SHARDS shards of
    2^27 / HASH_SHARDS slots in one launch, phase 22's largest merge
    (``merge_phase``) and the batch into phase 18's shard groups on the
    card (``window_phase``); directional lookups on the
    one table and on the shards, a LOOKUP_WAVE wave and LOOKUP_MANY
    queries, half of them random keys. The tables must hold equal rows
    shard by shard (the slot layouts may differ: the kernel's claims
    race) and claim counters equal to their occupied slots; lookups must
    be equal. Median CUDA-event ms, the plain insert timed once; each
    insert on a table reset (or restored) outside the timed span. An
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

    def restore(table, saved):
        table[0].copy_(saved[0])
        table[1].copy_(saved[1])

    def timed(run, reset_kernel, check, reps=10):
        """``run()``'s median CUDA-event ms, each run after an untimed
        ``reset_kernel``; then ``check()`` on its last run's result."""
        ms = median_ms(torch, run, reps, reset_kernel)
        torch.cuda.synchronize()
        check()
        return ms

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
            # all hits: into the table as one insert left it, each time
            once = fresh(shape)
            hk.insert_plain(*once, kmers)
            hits_plain_ms = median_ms(
                torch, lambda: hk.insert_plain(*plain, kmers), 1,
                lambda: restore(plain, once))
            hits_ms = timed(lambda: hk.hash_insert(*kern, kmers),
                            lambda: restore(kern, once),
                            lambda: same_rows(torch, "hash_insert", kern,
                                              plain, f"{what}, hits"))
            del once
        plain_ms = median_ms(torch, lambda: hk.insert_plain(*plain, kmers), 1,
                             lambda: reset(plain))
        ms = timed(lambda: hk.hash_insert(*kern, kmers), lambda: reset(kern),
                   lambda: same_rows(torch, "hash_insert", kern, plain, what))
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
    rehash_plain_ms = median_ms(torch,
                                lambda: hk.insert_plain(*new_p, src[0]), 1,
                                lambda: reset(new_p))
    rehash_ms = timed(lambda: hk.hash_insert(*new_k, src[0]),
                      lambda: reset(new_k),
                      lambda: same_rows(torch, "hash_insert", new_k, new_p,
                                        "the rehash, timed"), reps=5)
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
    insert.update(merge_phase(torch, card, timed))
    insert.update(window_phase(torch, kmers, n_valid, card, timed))
    insert.update(band_phase(torch, kmers, card))

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
    # the wave path on the same tables, as their lookups issue it
    from sharkmer_tpu_torch.ops.hashtable import KmerTable
    from sharkmer_tpu_torch.parallel.sharded_table import ShardedKmerTable

    cuda = torch.device("cuda", torch.cuda.current_device())
    one_table = KmerTable(K, *tables["1 table"], cuda)
    wave_checks(torch, np, one_table, "1 table", gen)
    late_wave(torch, np, one_table, gen)
    slots, claims = tables[f"{HASH_SHARDS} shards"]
    wave_checks(torch, np, ShardedKmerTable(K, [cuda], [slots], [claims]),
                f"{HASH_SHARDS} shards", gen)
    del tables, kmers, valid, one_table, slots, claims
    torch.cuda.empty_cache()
    return {"hash_insert": insert, "hash_lookup": lookup}


def window_phase(torch, kmers, n_valid: int, card: str, timed) -> dict:
    """Phase 8's batch into HASH_SHARDS shards of HASH_CAP / HASH_SHARDS
    slots placed as phase 18 places them on one card (ONE_CARD_GROUPS:
    groups of shards in separate allocations): one windowed
    ``hash_insert`` a group, each group held to the windowed
    ``insert_plain`` (rows, claim counters) and the groups' n_total to
    the batch's valid k-mers; the groups' launches timed together
    (``timed``)."""
    from sharkmer_tpu_torch.device import shard_groups
    from sharkmer_tpu_torch.kernels import hash as hk

    S, cap = HASH_SHARDS, HASH_CAP // HASH_SHARDS
    groups = shard_groups(S, len(ONE_CARD_GROUPS))

    def fresh():
        return [(hk.new_slots((hi - lo, cap), "cuda"),
                 torch.zeros(hi - lo, dtype=torch.int64, device="cuda"))
                for lo, hi in groups]

    def reset(tables):
        for slots, claims in tables:
            slots[..., 0].fill_(INT64_MAX)
            slots[..., 1].zero_()
            claims.zero_()

    def insert(tables, fn, **kw):
        for (lo, _), (slots, claims) in zip(groups, tables):
            fn(slots, claims, kmers, shard_lo=lo, n_shards=S, **kw)

    kern, plain = fresh(), fresh()
    what = (f"{kmers.numel()} k-mers into {S} shards of {cap} slots in "
            f"{len(groups)} groups on {','.join(ONE_CARD_GROUPS)}")
    plain_ms = median_ms(torch, lambda: insert(plain, hk.insert_plain), 1,
                         lambda: reset(plain))

    def check():
        for d, (got, want) in enumerate(zip(kern, plain)):
            same_rows(torch, "hash_insert", got, want, f"{what}, group {d}")
        total = sum(int(hk.as_u32(hk.slot_counts(g)).sum()) for g, _ in kern)
        require(total == n_valid,
                f"hash_insert: n_total {total} != {n_valid} ({what})")

    ms = timed(lambda: insert(kern, hk.hash_insert), lambda: reset(kern),
               check)
    # the batch read once, each slot sector that holds a key read and
    # written once
    sectors = sum(touched_sectors(torch, g)["slot_sectors"] for g, _ in kern)
    print(f"hash_insert: exact on {what}: median {ms:.4f} ms for "
          f"{len(groups)} windowed launches vs {plain_ms:.4f} ms plain on "
          f"{card}", flush=True)
    del kern, plain
    torch.cuda.empty_cache()
    return {
        "window_ms": ms, "window_plain_ms": plain_ms,
        "window_bound_ms": (8 * kmers.numel() + 64 * sectors)
        / HBM_BYTES_PER_MS}


def merge_phase(torch, card: str, timed) -> dict:
    """The largest merge of phase 22's 8M ``--chunks 10`` hash run, at
    its shapes (MERGE_SHAPE, printed by that run): a chunk table's keys
    into a master that holds some of them; random keys below 2^38
    (19-mers) from a seeded generator, counts 1-9. The master after the
    merge held to ``insert_plain``'s (rows, claim counter); timed
    (``timed``), each run from the master as it was."""
    from sharkmer_tpu_torch.kernels import hash as hk

    src_cap, src_keys, dst_cap, dst_keys, shared = MERGE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(11)

    def keys(n):
        return torch.randint(0, 1 << (2 * K), (n,), device="cuda",
                             generator=gen)

    def table(cap, entries):
        slots = hk.new_slots((cap,), "cuda")
        claims = torch.zeros(1, dtype=torch.int64, device="cuda")
        hk.hash_insert(slots, claims, entries, torch.randint(
            1, 10, entries.shape, dtype=torch.int32, device="cuda",
            generator=gen))
        return slots, claims

    master_keys = keys(dst_keys)
    base = table(dst_cap, master_keys)
    src = table(src_cap, torch.cat([master_keys[:shared],
                                    keys(src_keys - shared)]))
    del master_keys
    kern = (base[0].clone(), base[1].clone())
    plain = (base[0].clone(), base[1].clone())
    what = (f"the merge of a {src_cap}-slot table holding {int(src[1])} keys "
            f"into a {dst_cap}-slot table holding {int(base[1])}")

    def restore(table):
        table[0].copy_(base[0])
        table[1].copy_(base[1])

    plain_ms = median_ms(torch, lambda: hk.insert_plain(*plain, src[0]), 1,
                         lambda: restore(plain))
    ms = timed(lambda: hk.hash_insert(*kern, src[0]), lambda: restore(kern),
               lambda: same_rows(torch, "hash_insert", kern, plain, what),
               reps=5)
    # the source's 16 B slots read once; the master's sectors that hold a
    # key of the source read and written once
    hit = torch.zeros(dst_cap, dtype=torch.bool, device="cuda")
    occupied = hk.slot_keys(kern[0]) != INT64_MAX
    hit[occupied] = torch.isin(hk.slot_keys(kern[0])[occupied],
                               hk.slot_keys(src[0]))
    sectors = torch.unique_consecutive(
        torch.nonzero(hit).reshape(-1) >> 1).numel()
    print(f"hash_insert: exact on {what} ({int(kern[1])} after): median "
          f"{ms:.4f} ms kernel vs {plain_ms:.4f} ms plain on {card}",
          flush=True)
    del base, src, kern, plain, hit, occupied
    torch.cuda.empty_cache()
    return {
        "merge_ms": ms, "merge_plain_ms": plain_ms,
        "merge_bound_ms": (16 * src_cap + 64 * sectors) / HBM_BYTES_PER_MS}


def band_phase(torch, kmers, card: str) -> dict:
    """Phase 8's band: ``hash_insert`` where the freeze decides, held to
    ``insert_plain`` and to the JAX table's values written above (BAND,
    MERGE_BAND). Keys absent from the batch start near SAT_THRESHOLD
    (written by the kernel, so their slots hold an earlier epoch); then
    (insert) phase 8's batch with BAND_ENTRIES entries of each BAND key
    at random places in it, or (merge) a 2^26-slot table holding the
    MERGE_BAND keys at their source counts and the batch's k-mers (a hit
    on the master for every key of the batch, into which the batch was
    inserted once) goes in, BAND_REPS times from the same start on each
    layout: one table, HASH_SHARDS shards in one launch, and HASH_SHARDS
    shard groups on the card (ONE_CARD_GROUPS, one windowed launch a
    group), read back through the groups'
    pointer table. Every launch's rows must equal the plain version's,
    shard by shard, and the band keys' counts the JAX values."""
    from sharkmer_tpu_torch.device import shard_groups
    from sharkmer_tpu_torch.kernels import hash as hk

    S = HASH_SHARDS
    layouts = {"1 table": (1, [(0, 1)]), f"{S} shards": (S, [(0, S)]),
               f"{S} groups": (S, shard_groups(S, len(ONE_CARD_GROUPS)))}
    gen = torch.Generator(device="cuda").manual_seed(17)
    n_keys = len(BAND) + len(MERGE_BAND)
    absent = torch.unique(torch.randint(0, 1 << (2 * K), (4 * n_keys,),
                                        device="cuda", generator=gen))
    absent = absent[~torch.isin(absent, kmers)]
    absent = absent[torch.randperm(absent.numel(), device="cuda",
                                   generator=gen)]
    require(absent.numel() >= n_keys, "phase 8's band: too few keys")
    insert_keys, merge_keys = absent[:len(BAND)], absent[len(BAND):n_keys]
    # the batch, BAND_ENTRIES entries of each insert key spread through it
    entries = insert_keys.repeat_interleave(BAND_ENTRIES)
    n = kmers.numel() + entries.numel()
    spot = torch.zeros(n, dtype=torch.bool, device="cuda")
    spot[torch.randperm(n, device="cuda", generator=gen)[:entries.numel()]] \
        = True
    batch = torch.empty(n, dtype=torch.int64, device="cuda")
    batch[spot] = entries
    batch[~spot] = kmers

    def u32s(values):
        return hk.as_i32(torch.tensor(values, dtype=torch.int64,
                                      device="cuda"))

    src = (hk.new_slots((HASH_CAP // 2,), "cuda"),
           torch.zeros(1, dtype=torch.int64, device="cuda"))
    hk.hash_insert(*src, merge_keys, u32s([c for _, c, _ in MERGE_BAND]))
    hk.hash_insert(*src, kmers)
    cases = {"insert": (insert_keys, [c for c, _ in BAND], batch,
                        [c for _, c in BAND], False),
             "merge": (merge_keys, [c for c, _, _ in MERGE_BAND],
                       src[0].view(-1, 2), [c for _, _, c in MERGE_BAND],
                       True)}
    record = {"band_launches": 0, "band_max_abs_err": 0}
    launches = 0  # one a group a launch of the batch
    for layout, (n_shards, groups) in layouts.items():
        cap = HASH_CAP // n_shards

        def fresh():
            return [(hk.new_slots((cap,) if n_shards == 1
                                  else (hi - lo, cap), "cuda"),
                     torch.zeros(hi - lo, dtype=torch.int64, device="cuda"))
                    for lo, hi in groups]

        def insert(tables, entries, amounts=None, fn=hk.hash_insert):
            """One batch into every group, a windowed launch a group."""
            for (lo, _), (slots, claims) in zip(groups, tables):
                fn(slots, claims, entries, amounts, shard_lo=lo,
                   n_shards=n_shards)

        def counts_of(tables, keys):
            slots = (tables[0][0] if len(tables) == 1
                     else [g for g, _ in tables])
            return hk.as_u32(hk.hash_lookup(slots, keys)).tolist()

        for case, (keys, start, entries, want, batch_first) in cases.items():
            start_tables = fresh()
            insert(start_tables, keys, u32s(start))
            if batch_first:  # the master holds the batch's keys too
                insert(start_tables, kmers)
            plain = [(g.clone(), c.clone()) for g, c in start_tables]
            insert(plain, entries, fn=hk.insert_plain)
            torch.cuda.synchronize()
            require(counts_of(plain, keys) == want,
                    f"insert_plain: the band's counts {counts_of(plain, keys)}"
                    f" are not the JAX values {want} ({case}, {layout})")
            kern = [(g.clone(), c.clone()) for g, c in start_tables]
            what = (f"the band's {case} into {layout} of {HASH_CAP} slots")
            for rep in range(BAND_REPS):
                for (g, c), (g0, c0) in zip(kern, start_tables):
                    g.copy_(g0)
                    c.copy_(c0)
                before = hk.hash_insert.launches
                insert(kern, entries)
                record["band_launches"] += hk.hash_insert.launches - before
                launches += len(groups)
                torch.cuda.synchronize()
                got = counts_of(kern, keys)
                require(got == want, f"hash_insert: the band's counts {got} "
                        f"are not the JAX values {want} on launch {rep} of "
                        f"{what}")
                for d, (g, w) in enumerate(zip(kern, plain)):
                    err, _ = same_rows(torch, "hash_insert", g, w,
                                       f"{what}, launch {rep}, group {d}")
                    record["band_max_abs_err"] = max(
                        record["band_max_abs_err"], err)
            print(f"hash_insert: exact on {what}: {BAND_REPS} launches from "
                  f"one start, each equal to insert_plain and the band keys "
                  f"at the JAX values {[hex(c) for c in want]} on {card}",
                  flush=True)
            del start_tables, plain, kern
            torch.cuda.empty_cache()
    require(record["band_launches"] == launches,
            f"hash_insert: {record['band_launches']} launches for the band's "
            f"{launches} group inserts")
    del src, batch
    torch.cuda.empty_cache()
    return record


def ingest_codes(np):
    """The first INGEST_READS cnidaria reads through the port's native
    loader, as uint8 codes [INGEST_READS, READ_LEN]."""
    from sharkmer_tpu_torch.io import native

    require(native.available(), "the native FASTQ loader did not build")
    with native.NativeFastqReader(FASTQ) as reader:
        codes, lens = reader.read_batch(INGEST_READS)
    require(codes.shape[0] == INGEST_READS and (lens == READ_LEN).all(),
            f"phase 27: {codes.shape[0]} reads of lengths "
            f"{sorted(set(lens.tolist()))}, not {INGEST_READS} of {READ_LEN}")
    return np.ascontiguousarray(codes[:, :READ_LEN])


def ingest_steps_phase(ctx, np, card: str, runs: dict, placements) -> dict:
    """Phase 27: the fused sharded ingest steps (the JAX package's
    ``make_ingest_step`` and ``make_sorted_ingest_step``, its multi-chip
    "training step": data-parallel encode, keyspace-sharded insert,
    summed spectrum) on the first INGEST_READS cnidaria reads, in steps
    of INGEST_STEP_READS reads a shard over INGEST_SHARDS shards, on each
    placement (a device list, one shard group a device): the hash step
    on a ``ShardedKmerTable`` of INGEST_CAP slots a shard, the sorted
    step at ``cap`` INGEST_CAP a shard. Each is held to
    ``chunk_spectra_reference`` on the same reads (one chunk): the last
    step's histogram to its spectrum, the exported table (every shard's
    rows, sorted) to its distinct keys and counts, after no shard passed
    INGEST_LOAD of its slots (hash) or holds ``cap`` keys (sorted: the
    step cuts there). ``hash_insert`` must launch once a group a step,
    ``run_starts`` once a shard a step, and no kernel of the other
    backend. Prints each step's wall and each card's peak; the runs'
    launches go into ``runs`` (``ingest_<tag>_<backend>``)."""
    from sharkmer_tpu_torch.kernels.hash import slot_keys
    from sharkmer_tpu_torch.parallel.sharded_table import (ShardedKmerTable,
                                                          make_ingest_step)
    from sharkmer_tpu_torch.parallel.sorted_sharded import (
        ShardedSortedStore, make_sorted_ingest_step)

    torch, kernels = ctx.torch, ctx.kernels
    S, R = INGEST_SHARDS, INGEST_STEP_READS
    n_steps = INGEST_READS // (S * R)
    start = time.monotonic()
    codes = ingest_codes(np)
    first = torch.device(next(iter(placements.values()))[0])
    spectra, n_kmers, (ref_keys, ref_counts) = chunk_spectra_reference(
        FASTQ, INGEST_READS, 1, K, HISTO_MAX, first, with_rows=True)
    print(f"phase 27: {INGEST_READS} reads' codes and the reference "
          f"({n_kmers} k-mers, {ref_keys.numel()} distinct) in "
          f"{time.monotonic() - start:.2f} s", flush=True)
    record = {}
    for tag, devices in placements.items():
        devices = [torch.device(d) for d in devices]
        groups = len(devices)
        for backend in ("hash", "sorted"):
            label = f"ingest_{tag}_{backend}"
            cards = sorted({d.index for d in devices if d.type == "cuda"})
            for index in cards:
                torch.cuda.reset_peak_memory_stats(index)
            if backend == "hash":
                store = ShardedKmerTable.create(K, S, INGEST_CAP,
                                                devices=devices)
                step = make_ingest_step(devices, K, HISTO_MAX)
                state = (store.group_slots, store.group_claims)
            else:
                store = ShardedSortedStore.create(K, S, INGEST_CAP,
                                                  devices=devices)
                step = make_sorted_ingest_step(devices, K, HISTO_MAX,
                                               INGEST_CAP)
                state = (store.kmers, store.counts)
            for fn in kernels.values():
                fn.launches = 0
            walls = []
            for i in range(n_steps):
                batch = codes[i * S * R:(i + 1) * S * R].reshape(S, R, -1)
                t0 = time.monotonic()
                *state, histo = step(*state, batch)
                for index in cards:
                    torch.cuda.synchronize(index)
                walls.append(time.monotonic() - t0)
            counts = {name: fn.launches for name, fn in kernels.items()}
            peaks = [torch.cuda.max_memory_allocated(i) for i in cards]
            require(np.array_equal(histo, spectra[-1]),
                    f"{label}: the last step's histogram differs from the "
                    f"reference's spectrum in bins "
                    f"{np.nonzero(histo != spectra[-1])[0][:10].tolist()}")
            keys, counts_, shard_keys = [], [], []
            if backend == "hash":
                for g in state[0]:
                    for j in range(g.shape[0]):
                        k_, c_ = table_rows(torch, g[j])
                        shard_keys.append(k_.numel())
                        keys.append(k_.to(first))
                        counts_.append(c_.to(first))
                claimed = [int(c) for g in state[1] for c in g]
                require(claimed == shard_keys,
                        f"{label}: claim counters {claimed} for shards of "
                        f"{shard_keys} keys")
                require(max(shard_keys) <= INGEST_LOAD * INGEST_CAP,
                        f"{label}: a shard holds {max(shard_keys)} keys, past "
                        f"{INGEST_LOAD} of {INGEST_CAP} slots")
                want_launches = {"hash_insert": groups * n_steps,
                                 "encode": S * n_steps}
            else:
                for mk, mc in zip(*state):
                    live = mk != INT64_MAX
                    shard_keys.append(int(live.sum()))
                    keys.append(mk[live].to(first))
                    counts_.append(mc[live].to(first))
                require(max(shard_keys) < INGEST_CAP,
                        f"{label}: a shard holds {max(shard_keys)} keys, "
                        f"cap {INGEST_CAP} (the step cuts there)")
                want_launches = {"run_starts": S * n_steps,
                                 "encode": S * n_steps}
            keys, order = torch.sort(torch.cat(keys))
            counts_ = torch.cat(counts_)[order]
            require(torch.equal(keys, ref_keys)
                    and torch.equal(counts_, ref_counts),
                    f"{label}: the table's {keys.numel()} keys and counts "
                    f"differ from the reference's {ref_keys.numel()}")
            for name, n in counts.items():
                want = want_launches.get(name, 0)
                require(n == want, f"{label}: {name} launched {n} times, "
                        f"not {want} ({groups} groups, {S} shards, "
                        f"{n_steps} steps)")
            print(f"{label}: {n_steps} steps of [{S}, {R}, {READ_LEN}] codes "
                  f"on {','.join(map(str, devices))}: step walls "
                  f"{[round(w, 4) for w in walls]} s; histogram and "
                  f"{keys.numel()} keys and counts equal to the reference; "
                  f"keys a shard {shard_keys}; launches {counts}; each "
                  f"card's torch.cuda.max_memory_allocated() {peaks} bytes "
                  f"on {card}", flush=True)
            runs[label] = ({**counts, "steps": n_steps}, walls)
            record[label] = {"step_s": walls, "peaks": peaks,
                             "shard_keys": shard_keys}
            del store, state, step, keys, counts_
            torch.cuda.empty_cache()
    del ref_keys, ref_counts, codes
    torch.cuda.empty_cache()
    return record


def ingest_phase_of_cards(ctx, np, card: str, runs: dict) -> dict:
    """Phase 27 on ``[cuda:0]``, on ONE_CARD_GROUPS and, with
    INGEST_SHARDS cards or more, a group a card."""
    placements = {"one": ["cuda:0"], "groups": ONE_CARD_GROUPS}
    n_cards = ctx.torch.cuda.device_count()
    if n_cards >= INGEST_SHARDS:
        placements["cards"] = [f"cuda:{i}" for i in range(INGEST_SHARDS)]
    record = ingest_steps_phase(ctx, np, card, runs, placements)
    if "cards" not in placements:
        print(f"phase 27: the {INGEST_SHARDS}-card placement did not run: "
              f"{n_cards} card(s) visible", flush=True)
    return record


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
                 tag: str, reuse: dict | None = None) -> dict:
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
      owner shards on ``devices``, launched on ``devices[0]``; with
      ``reuse`` (``closure_phase``), against phase 13's plain results.

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
        if not one_card:
            held = late_writes(torch, launch, kern[0], lambda slots: (
                slots[..., 0].fill_(INT64_MAX), slots[..., 1].zero_()))
            require(torch.equal(hk.hash_lookup(kern[0], q, K, pointers), got),
                    "hash_lookup: differs when peer cards write their "
                    "shards late")
            print(f"hash_lookup: exact on the {n_q}-query wave while {held} "
                  f"peer groups' slots were written late on their cards' "
                  f"streams", flush=True)
    lookup_rec["max_abs_err"] = max(lookup_rec["max_abs_err"],
                                    lookup_rec["many_max_abs_err"])
    # the wave path through the groups' pointer table
    from sharkmer_tpu_torch.parallel.sharded_table import ShardedKmerTable

    table = ShardedKmerTable(K, list(devices), kern[0], kern[1])
    where = (f"the pointer table of {S} shards on "
             f"{','.join(map(str, devices))}")
    wave_checks(torch, np, table, where, gen)
    if not one_card:
        # the peer groups' slots written late on their cards' streams;
        # the table made on them records an event on each card
        pool = wave_pool(torch, table, gen)
        q = wave_queries(torch, np, pool, K, LOOKUP_WAVE, gen)
        want = table.lookup_directional(q)
        held = late_writes(torch, launch, kern[0], lambda slots: (
            slots[..., 0].fill_(INT64_MAX), slots[..., 1].zero_()))
        late = ShardedKmerTable(K, list(devices), kern[0], kern[1])
        require((late.lookup_directional(q) == want).all(),
                "hash_lookup: a wave differs when peer cards write their "
                "shards late")
        print(f"hash_lookup wave path: exact on {where} while {held} peer "
              f"groups' slots were written late on their cards' streams",
              flush=True)
        del late, pool
    del table, kern, one, batches, kmers, valid, pointers
    torch.cuda.empty_cache()

    closures = closure_phase(torch, np, card, latency, {
        tag: lambda keys, counts, n_real: shard_table(
            torch, keys, counts, n_real, CLOSURE_SHARDS, K, devices)},
        reuse=reuse)
    if not one_card:
        late_closure(torch, np, devices)
    return {f"hash_insert, {tag}": insert_rec,
            f"hash_lookup, {tag}": lookup_rec, **closures}


def late_writes(torch, launch, tensors, clear) -> int:
    """For each of ``tensors`` that lies on a card other than ``launch``:
    ``clear`` it and wait for that, then queue the restore of its
    contents on its card's current stream behind ``torch.cuda._sleep``
    (SLEEP_CYCLES), so that the write lands late. A launch on ``launch``
    that did not order itself after the peers' streams
    (``kernels/peer.wait_for_peers``) would read the cleared contents.
    Returns how many tensors it held back."""
    from sharkmer_tpu_torch.device import indexed

    held = [(t, t.clone()) for t in tensors
            if indexed(t.device) != indexed(launch)]
    require(held, f"no tensor lies on a card other than {launch}")
    for t, _ in held:
        clear(t)
        torch.cuda.synchronize(t.device)
    for t, saved in held:
        with torch.cuda.device(t.device):
            torch.cuda._sleep(SLEEP_CYCLES)
            t.copy_(saved)
    return len(held)


def late_closure(torch, np, devices) -> None:
    """Phase 18b's stream-ordering check of ``reach_closure``: phase 13's
    narrow call over the closure table's owner shards on ``devices``,
    launched on ``devices[0]`` while the shards on the other cards write
    their counts late (``late_writes``), against ``closure_plain`` on the
    intact table."""
    from sharkmer_tpu_torch.kernels import closure

    keys, counts, n_real, fwd = closure_table(np, torch, PART_ROWS, K)
    table = shard_table(torch, keys, counts, n_real, CLOSURE_SHARDS, K,
                        devices)
    del keys, counts
    roots, shape = closure_cases(np, fwd)["narrow"]
    with torch.cuda.device(devices[0]):
        c0 = closure_roots(np, roots)
    want = closure.closure_plain(table, c0, None, CLOSURE_MC, K, *shape)
    held = late_writes(torch, devices[0],
                       [sc.counts1d for sc in table.sidecars],
                       lambda t: t.zero_())
    got = closure.reach_closure(table, c0, None, CLOSURE_MC, K, *shape)
    state = closure.unpack_state(got[2])
    require(state == closure.unpack_state(want[2])
            and torch.equal(torch.sort(got[0]).values,
                            torch.sort(want[0]).values)
            and torch.equal(torch.unique(got[1]), torch.unique(want[1])),
            "reach_closure: differs from plain when peer cards write their "
            "shards late")
    print(f"reach_closure: exact on the narrow call ({len(roots)} roots, "
          f"[n_vis, iters, overflow, done] {state}) while {held} shards on "
          f"peer cards wrote their counts late", flush=True)
    del table, want, got
    torch.cuda.empty_cache()


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


def check_chunked_runs(runs) -> None:
    """Phase 22's runs: the single sorted store's chunk stores and master
    drain (``run_ends`` for each ghosted first drain, ``run_starts`` and
    ``stitch_rows`` for drain v2) and the sharded stores aggregate
    (``run_starts``), none of them on the hash kernels, and each runs
    its closures on ``reach_closure`` and its warm starts on
    ``probe_rows`` (two on this data); the hash run as
    ``check_hash_run``, its host mirror exported once."""
    for label in runs:
        if not label.startswith("chunked_") or label == "chunked_hash_8M":
            continue
        counts = runs[label][0]
        need = (("run_starts", "probe_rows")
                if "shards" in label or "cards" in label
                else ("run_ends", "run_starts", "stitch_rows", "probe_rows"))
        for name in need:
            require(counts[name] >= 1,
                    f"{name} was not launched in the {label} run")
        require(not counts["hash_insert"],
                f"hash_insert was launched in the {label} run")
        check_closure_run(runs, label)
    if "chunked_hash_8M" in runs:
        check_hash_run(runs, "chunked_hash_8M", 1)
        got = (runs["chunked_hash_8M"][0]["hash_exports"],
               runs["chunked_hash_8M"][0]["shard_exports"])
        require(got == (1, 0), f"chunked_hash_8M: KmerTable and ShardedKmer"
                f"Table.to_sorted_arrays ran {got} times, not (1, 0)")


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
                    record: dict, runs: dict, waves: dict,
                    load: bool = True, reuse: dict | None = None) -> str:
    """Phase 18 on one placement, ``devices`` (names, one a shard group):
    ``groups_phase``, then the 1M cell with ``--n-shards`` N_SHARDS under
    ``SHARKMER_TORCH_DEVICES``: sorted, hash ``--mirror device`` (its
    table's waves timed into ``waves``) and, with ``load``,
    ``--load-table`` of phase 9's checkpoint (runs ``<tag>_sorted``,
    ``<tag>_hash_device``, ``<tag>_load``). Returns the records'
    label."""
    torch = ctx.torch
    label = f"{len(devices)} groups on {len(set(devices))} card(s)"
    record.update(groups_phase(torch, np, card, latency,
                               [torch.device(d) for d in devices], label,
                               reuse))
    os.environ[DEVICES_ENV] = ",".join(devices)
    try:
        runs[f"{tag}_sorted"] = drive_main_path(
            ctx, f"{tag}_sorted", 1_000_000, ("--n-shards", N_SHARDS))
        runs[f"{tag}_hash_device"] = drive_main_path(
            ctx, f"{tag}_hash_device", 1_000_000,
            ("--n-shards", N_SHARDS, "--backend", "hash", "--mirror",
             "device"))
        waves[f"{tag}_hash_device"] = cli_wave_times(ctx, card,
                                                     f"{tag}_hash_device")
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
                            **owner_layouts(torch)}, plain=False,
                           device_times=True)
    print(f"card: {card}")
    print("RESULT " + json.dumps(record), flush=True)
    return 0


def run_tool(name: str, *args: str, timeout: int) -> dict:
    """``python -m sharkmer_tpu_torch.tools.<name> ARGS`` on the card, its
    output printed; fails if it fails. Returns its last line's JSON."""
    start = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", f"sharkmer_tpu_torch.tools.{name}", *args],
        cwd=HERE, capture_output=True, text=True, timeout=timeout)
    print(proc.stdout, end="")
    require(proc.returncode == 0,
            f"{name} exited {proc.returncode}: {proc.stderr[-3000:]}")
    print(f"{name}: {time.monotonic() - start:.1f} s", flush=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


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

    bench = run_tool("bench", "--quick", timeout=600)
    ok, n_genes = bench["spcr_genes_ok"].split("/")
    require(ok == n_genes and int(n_genes) > 0,
            f"bench --quick recovered {bench['spcr_genes_ok']} genes")


def profile_phase() -> None:
    """Phase 21: the port's profilers, each a subprocess on the card.
    ``tools/ingest_phase.py`` at the cell's k: the drain path's stages
    at 2^27 keys (each must launch its kernels), then the host stages of
    the CLI's ingest over the 8M cnidaria FASTQ (its reads, bases and
    k-mers those of the committed 8M cell); ``tools/cold_start.py``
    bare, then ``--cli`` on the 1M cnidaria cell (its outputs held to
    the committed cell, the three parts of its split within
    SPLIT_SLACK_S of the child's wall)."""
    import yaml

    n_reads = 8 * M
    record = run_tool("ingest_phase", "--width", "27", "--fastq",
                      FASTQS["cnidaria"], "--max-reads", str(n_reads),
                      "--k", str(K), timeout=600)
    stages = record["stages"]
    for label, kernels in (("run_starts (fwd)", ("run_starts",)),
                           ("ghosted drain", ("run_ends",)),
                           ("v2 drain", ("run_starts", "stitch_rows"))):
        launches = next(v["launches"] for key, v in stages.items()
                        if key.startswith(label))
        require(all(launches[name] >= 1 for name in kernels),
                f"ingest_phase: {label} launched {launches}")
    fastq = record["fastq"]
    sample = f"synthetic-seed0_{n_reads}"
    with open(os.path.join(oracle_of("cnidaria", n_reads),
                           f"{sample}.stats.yaml")) as f:
        stats = yaml.safe_load(f)
    got = (fastq["reads"], fastq["bases"], fastq["kmers"])
    want = (stats["n_reads_read"], stats["n_bases_read"], stats["n_kmers"])
    require(got == want, f"ingest_phase --fastq: reads, bases, k-mers {got} "
            f"vs the committed 8M cell's {want}")
    print(f"ingest_phase --fastq: reads, bases and k-mers {got} equal the "
          f"committed 8M cell's", flush=True)
    inflated = fastq["inflate"]
    require(inflated is not None
            and inflated["inflated_lines"] >= 4 * n_reads,
            f"ingest_phase --fastq: zlib's inflate alone gave {inflated}")
    print(f"ingest_phase --fastq: read_batch alone {fastq['read_batch_s']:.3f}"
          f" s, zlib's inflate alone {inflated['inflate_s']:.3f} s "
          f"({inflated['gzip_bytes']} gzip bytes to "
          f"{inflated['inflated_bytes']}) on the card's host", flush=True)

    run_tool("cold_start", timeout=300)
    sample = f"synthetic-seed0_{M}"
    out = os.path.join(OUT_DIR, "cold_start_cli")
    shutil.rmtree(out, ignore_errors=True)
    split = run_tool("cold_start", "--cli", "-s", sample, "-k", str(K),
                     "-t", "8", "-o", out, "--pcr-panel-file",
                     PANELS["cnidaria"], "-m", str(M), FASTQS["cnidaria"],
                     timeout=300)
    check_outputs("cold_start --cli", out, oracle_of("cnidaria", M), sample)
    require(abs(split["sum_s"] - split["wall_s"]) <= SPLIT_SLACK_S,
            f"cold_start --cli: the parts sum to {split['sum_s']:.3f} s, the "
            f"child's wall is {split['wall_s']:.3f} s")


def required_launches() -> dict:
    """Each kernel and the runs that must launch it at least once."""
    chunked_sorted = ("chunks_sorted_1", f"chunks_sorted_{N_SHARDS}")
    chunked_hash = ("chunks_hash_1", f"chunks_hash_{N_SHARDS}")
    # phase 23 (and stitch_rows in none of its runs: check_long_k_runs),
    # phase 24 (phase 4's kernels)
    k31_drains = ("k31_chunks_sorted_250k", "k31_sorted_8M",
                  "k31_chunked_sorted_8M")
    k31_closures = ("k31_chunks_sorted_250k", "k31_sorted_8M",
                    "k31_chunked_sorted_8M", "k31_1M", "k31_shards_1M")
    k31_hash = ("k31_chunks_hash_250k", "k31_hash_8M", "k31_chunked_hash_8M")
    entries = ("entry_stdin", "entry_paired", "entry_two_files",
               "entry_validate")
    # phase 25: every sorted run its ghosted first drain, the closures and
    # their warm starts; drain v2 past the oracles' depth (and in the
    # --mirror full run, whose ingest is the 1M run's)
    panels = panel_labels()
    deep = (*panels["deep"], *panels["full"])
    # phase 26: each sorted run its ghosted first drain and the closures,
    # each hash run its inserts, the --mirror device run its waves
    options = option_labels()
    return {"run_ends": ("default", "max_agg_2^24", *k31_drains, "k31_1M",
                         "k31_mirror_full_1M", *entries, *panels["sorted"],
                         *panels["full"], *options["sorted"]),
            "run_starts": ("default", "max_agg_2^24", "shards",
                           *chunked_sorted, *k31_drains, "k31_shards_1M",
                           *entries, *deep),
            "probe_rows": ("default", "max_agg_2^24", *entries,
                           *panels["sorted"]),
            "stitch_rows": ("max_agg_2^24", "4M", *deep),
            "reach_closure": ("default", "max_agg_2^24", "4M",
                              "load_sorted", "shards", *chunked_sorted,
                              *k31_closures, *entries, *panels["sorted"],
                              *options["sorted"]),
            "hash_insert": ("hash", "load_hash", "hash_4M",
                            "shards_hash", "shards_hash_device",
                            "shards_load", *chunked_hash, *k31_hash,
                            *panels["hash"], *options["hash"]),
            "hash_lookup": ("hash_device", "shards_hash_device",
                            *options["device"]),
            "encode": ("default", "max_agg_2^24", "4M", "hash",
                       "hash_device", "hash_4M", "shards", "shards_hash",
                       *chunked_sorted, *chunked_hash, *k31_hash,
                       *entries)}


def check_required(runs, present_only: bool = False) -> None:
    """``required_launches`` on ``runs``, and ``check_closure_run`` on its
    ``reach_closure`` runs; with ``present_only`` (a phase run alone) only
    on the runs that ran."""
    for name, labels in required_launches().items():
        for label in labels:
            if present_only and label not in runs:
                continue
            require(runs[label][0][name] >= 1,
                    f"{name} was not launched in the {label} run")
            if name == "reach_closure":
                check_closure_run(runs, label)


def main() -> int:
    require(os.path.isdir(os.path.join(HERE, "sharkmer_tpu_torch")),
            f"no sharkmer_tpu_torch package beside {__file__}")
    import torch

    require(torch.cuda.is_available(), "torch sees no CUDA device")
    args = sys.argv[1:]
    require(args in ([], ["--closure-times"], ["--chunked"],
                     ["--chunked-cards"], ["--long-k"], ["--entries"],
                     ["--panels"], ["--waves"], ["--options"],
                     ["--profiles"], ["--ingest"]),
            f"unknown arguments {args}: none, --closure-times, --chunked, "
            f"--chunked-cards, --long-k, --entries, --panels, --waves, "
            f"--options, --profiles or --ingest")
    # the options that run one phase after phases 1 and 2 (and, for
    # --entries, phase 4's run, its ingest wall the one to compare with)
    chunked_only = args in (["--chunked"], ["--chunked-cards"])
    alone = chunked_only or args in (["--long-k"], ["--entries"],
                                     ["--panels"], ["--options"],
                                     ["--profiles"], ["--ingest"])
    # the panels whose FASTQ phase 1 starts: each option's; the whole
    # script's grid panels (phase 25's start after phase 3, so that
    # phases 2 and 3, the builds, the timed kernels and their profiler
    # sessions, run beside the grid's three children only)
    needed = (set() if args in (["--closure-times"], ["--waves"]) else
              set(BUILTIN_SEEDS) if args == ["--panels"] else
              {"cnidaria"} if alone else set(GRID_SEEDS))
    sys.path.insert(0, HERE)
    import numpy as np

    from sharkmer_tpu_torch.device import shard_devices
    from sharkmer_tpu_torch.io import native
    from sharkmer_tpu_torch.kernels import (build, closure, encode, probe,
                                            run_scan, stitch)
    from sharkmer_tpu_torch.kernels import hash as hash_kernels

    phase("1. card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s); using {kind}", flush=True)
    synth = {}

    def start_synth(panels) -> None:
        """One child process a missing FASTQ of ``panels``, all at once."""
        for panel in panels:
            if panel not in synth and not os.path.exists(FASTQS[panel]):
                synth[panel] = subprocess.Popen([
                    sys.executable, "-c",
                    "import sys; from sharkmer_tpu_torch.tools.synth import "
                    "synthesize_panel_fastq as s; s(sys.argv[1], "
                    "sys.argv[2], n_reads=int(sys.argv[3]), "
                    "seed=int(sys.argv[4]))",
                    PANELS[panel], FASTQS[panel], str(FASTQ_READS[panel]),
                    str(SEEDS[panel])], cwd=HERE)

    start_synth(needed)

    def wait_fastq(panel: str) -> None:
        start = time.monotonic()
        child = synth.pop(panel, None)
        require(child is None or child.wait() == 0,
                f"the {panel} FASTQ synthesis failed")
        print(f"FASTQ {os.path.relpath(FASTQS[panel], HERE)} ready "
              f"({time.monotonic() - start:.2f} s waited)", flush=True)

    try:
        if args == ["--closure-times"]:
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
                   "hash_lookup": hash_kernels.hash_lookup,
                   "encode": encode.encode}
        if args == ["--waves"]:
            phase("8b. the lookup wave path on synthetic tables (alone: "
                  "--waves)")
            waves_alone(torch, np, card)
            print(f"chip_smoke --waves wall: "
                  f"{time.monotonic() - T_START:.1f} s; passed")
            return 0
        if chunked_only:
            wait_fastq("cnidaria")
            os.makedirs(OUT_DIR, exist_ok=True)
            ctx = instrument(torch, kernels)
            os.environ["SHARKMER_TORCH_DEVICE"] = "cuda"
            phase(f"22. chunked spectra at depth (alone: {args[0]})")
            runs = {}
            chunked_phase(ctx, runs, torch.cuda.device_count(),
                          cards_only=args == ["--chunked-cards"])
            check_chunked_runs(runs)
            print(f"chip_smoke --chunked wall: "
                  f"{time.monotonic() - T_START:.1f} s; phase 22 passed")
            return 0
        if alone:
            if args != ["--panels"]:
                wait_fastq("cnidaria")
            os.makedirs(OUT_DIR, exist_ok=True)
            ctx = instrument(torch, kernels)
            os.environ["SHARKMER_TORCH_DEVICE"] = "cuda"
            runs = {}
            if args == ["--long-k"]:
                phase(f"23. k={LONG_K} (alone: --long-k)")
                long_k_phase(ctx, np, runs, card)
                check_long_k_runs(runs)
            elif args == ["--panels"]:
                phase("25. the built-in panels (alone: --panels)")
                for panel in BUILTIN_SEEDS:
                    wait_fastq(panel)
                panels_phase(ctx, runs)
                check_panel_runs(runs)
            elif args == ["--options"]:
                phase("26. the options the card has never run (alone: "
                      "--options)")
                options_phase(ctx, np, runs, card)
                check_option_runs(runs)
            elif args == ["--profiles"]:
                phase("21. the profilers: ingest_phase at 2^27 keys and on "
                      "the 8M FASTQ, cold_start bare and --cli on the 1M "
                      "cell (alone: --profiles)")
                profile_phase()
            elif args == ["--ingest"]:
                phase("27. the fused sharded ingest steps (alone: --ingest)")
                ingest_phase_of_cards(ctx, np, card, runs)
            else:
                phase("4. main path: 1M reads, cnidaria panel (for --entries)")
                runs["default"] = drive_main_path(ctx, "default", M)
                phase("24. the record-stream entries (alone: --entries)")
                entries_phase(ctx, runs)
            check_required(runs, present_only=True)
            print(f"chip_smoke {args[0]} wall: "
                  f"{time.monotonic() - T_START:.1f} s; passed")
            return 0

        phase("3. kernels vs plain PyTorch at the main path's shapes")
        latency = load_latency(torch)
        print(f"dependent-load latency: {latency['l2_ns']:.1f} ns through "
              f"L2, {latency['dram_ns']:.1f} ns from DRAM on {card}",
              flush=True)
        record = kernel_phase(torch, np, card, kernels)
        record.update(closure_phase(torch, np, card, latency,
                                    key_range_layouts(torch),
                                    device_times=True))

        phase("4. main path: 1M reads, cnidaria panel, default drain budget")
        start_synth(BUILTIN_SEEDS)
        wait_fastq("cnidaria")
        os.makedirs(OUT_DIR, exist_ok=True)
        ctx = instrument(torch, kernels)
        os.environ.pop("SHARKMER_MAX_AGG", None)
        os.environ["SHARKMER_TORCH_DEVICE"] = "cuda"
        # -vv: _drive_closure's debug line of each closure call
        runs = {"default": drive_main_path(ctx, "default", 1_000_000,
                                           ("-vv",))}
        group_labels = {}  # phase 18's placements: tag -> record label
        waves = {}  # the --mirror device runs' tables: their waves timed

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
        waves["hash_device"] = cli_wave_times(ctx, card, "hash_device")

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
        # phase 18 reuses these plain closures on its table, held equal
        reuse = {}
        record.update(closure_phase(torch, np, card, latency,
                                    owner_layouts(torch), reuse=reuse))

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
        waves["shards_hash_device"] = cli_wave_times(ctx, card,
                                                     "shards_hash_device")

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
                                                 devices, record, runs, waves,
                                                 reuse=reuse),
                                 len(devices))
        if "cards" not in placements:
            print("phase 18: the cross-card part (and its stream-ordering "
                  "check) did not run: only one card is visible", flush=True)

        phase("19. the offline grid: the 7 committed cells not run above "
              "(sorted, --mirror auto), then --backend hash")
        for panel in GRID_SEEDS:
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

        phase("21. the profilers: not run (python3 chip_smoke.py "
              "--profiles runs them)")

        phase(f"22. chunked spectra at depth: the reference against "
              f"{os.path.relpath(CHUNK_ORACLE, HERE)}, then --chunks 10 at "
              f"8M reads (sorted, hash), --chunks 20 --n-shards {N_SHARDS} "
              f"at 1M, and on four cards --chunks 10 --n-shards {N_SHARDS} "
              f"at 8M")
        chunked_phase(ctx, runs, torch.cuda.device_count())

        phase(f"23. k={LONG_K}: the kernels against plain, --chunks 10 on "
              f"{CHUNK_READS} reads against "
              f"{os.path.relpath(LONG_K_ORACLE, HERE)}, four runs at 8M "
              f"reads and three at 1M against the reference")
        record["k31"] = long_k_phase(ctx, np, runs, card)

        phase("24. the record-stream entries: stdin, --paired, two files, "
              f"--validate-every {VALIDATE_EVERY}")
        entries_phase(ctx, runs)

        phase(f"25. the built-in panels {', '.join(BUILTIN_SEEDS)} by name: "
              f"{PANEL_ORACLE_READS} reads sorted and hash against oracles/, "
              f"1M (insecta also 8M) against the embedded amplicons")
        for panel in BUILTIN_SEEDS:
            wait_fastq(panel)
        panels_phase(ctx, runs)

        phase(f"26. the options the card has never run: the kernels at k="
              f"{' and '.join(map(str, OPTION_KS))}, then {OPTIONS_READS} "
              f"reads at k=25 (default -t) and 27, --read-threading, "
              f"--min-kmer-count 4 --dump-graph, --table-capacity 2^17 and "
              f"the graph-walk limits against their JAX oracles")
        record["options"] = options_phase(ctx, np, runs, card)

        phase(f"27. the fused sharded ingest steps on {INGEST_READS} reads: "
              f"make_ingest_step and make_sorted_ingest_step, "
              f"{INGEST_SHARDS} shards of {INGEST_CAP}, on one card, "
              f"{INGEST_SHARDS} groups on it, and {INGEST_SHARDS} cards "
              f"where there are")
        record["ingest"] = ingest_phase_of_cards(ctx, np, card, runs)
    finally:
        for child in synth.values():
            child.kill()
            child.wait()

    check_required(runs)
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
    check_chunked_runs(runs)
    check_long_k_runs(runs)
    check_panel_runs(runs)
    check_option_runs(runs)

    parts = f"{CLOSURE_PARTS} partitions"
    shards = f"{CLOSURE_SHARDS} shards"
    records = []
    for name, (source, replaces) in KERNELS.items():
        if name == "probe_rows":
            # a warm start's keys over CLOSURE_PARTS; on one partition and
            # owner-routed over CLOSURE_SHARDS beside it
            # (phase 3 also the device times alone, and an empty kernel's
            # on the same grid); past the descriptor cap (the global route)
            one = record["probe_rows, 1 partition"]
            owned = record[f"probe_rows, {shards}"]
            past = record[f"probe_rows, {PAST_CAP_PARTS} partitions"]
            rec = dict(record[f"probe_rows, {parts}"], **latency,
                       one_part_ms=one["ms"], one_part_plain_ms=one["plain_ms"],
                       one_part_device_ms=one["device_ms"],
                       one_part_floor_ms=one["floor_ms"],
                       shards_ms=owned["ms"], shards_plain_ms=owned["plain_ms"],
                       shards_bound_ms=owned["bound_ms"],
                       shards_max_abs_err=owned["max_abs_err"])
            rec.update({f"past_cap_{key}": past[key] for key in (
                "ms", "plain_ms", "device_ms", "bound_ms", "max_abs_err")})
            # 4096 keys of the 256-row-bucket table, on each layout
            for layout in ("1 partition", parts, shards):
                wide = record[f"probe_rows wide bucket, {layout}"]
                rec.update({f"wide_bucket_{layout.split()[0]}_{key}":
                            wide[key] for key in ("ms", "plain_ms", "bound_ms",
                                                  "max_abs_err", "device_ms")
                            if key in wide})
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
        if name == "hash_lookup":
            # numpy to numpy on each --mirror device run's table
            rec["waves"] = waves
        # phase 27: the fused ingest steps' walls on each placement
        backend = {"hash_insert": "hash", "run_starts": "sorted"}.get(name)
        if backend:
            rec["ingest_steps"] = {
                label: value for label, value in record["ingest"].items()
                if label.endswith(f"_{backend}")}
        # phases 23 and 26: the kernel at k=31, 25 and 27
        # (k<k>_[call_]<field>)
        for k, long_k in ((LONG_K, record["k31"]),
                          *record["options"].items()):
            for key, value in long_k.items():
                if key.split()[0] == name:
                    call = "_".join(key.split()[1:])
                    rec.update({f"k{k}_{call + '_' if call else ''}{field}":
                                v for field, v in value.items()})
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
                        "ms", "plain_ms", "plain_from", "bound_ms",
                        "latency_bound_ms", "max_abs_err", "n_vis", "iters")})
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
    print(f"chip_smoke wall: {time.monotonic() - T_START:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
