#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sharkmer_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own lines; every check raises on failure:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   the 4M-read synthetic cnidaria FASTQ starts generating in a child
   process (``tools/synth.py``, seed 0), to be ready by phase 4;
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
   partition and cut into 21 key-range partitions: a narrow and a wide
   call from roots on the genome at depth 2048 and f_cap 256, and a
   warm-started call whose ``pre`` rows come from ``probe_rows`` (held
   to its plain version at the warm start's 4096 keys): equal ``n_vis``,
   ``iters``, ``overflow``, ``done``, sorted log and boundary set, and
   median ms per call;
4. the main path: the port's CLI (``sharkmer_tpu_torch.main.main``,
   which is what ``python -m sharkmer_tpu_torch`` runs) in this process
   on the first 1M reads, ``--mirror auto`` (the device reach closure),
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
   first drain, then drain v2 at the full 2^27 width.

Each kernel's launch count is reset just before each main-path run and
read just after it: ``run_ends``, ``run_starts`` and ``probe_rows`` (the
warm starts) must launch in phases 4 and 5, ``stitch_rows`` in phases 5
and 7, ``reach_closure`` in phases 4, 5 and 7 at least once per closure
call (the run's ``closures`` sPCR phase), where ``probe_rows`` may launch
no more often than that, the plain closure loop must never run and the
host mirror must not be built. A logged
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

HERE = os.path.dirname(os.path.abspath(__file__))
PANEL = os.path.join(HERE, "sharkmer_tpu_torch", "panels", "cnidaria.yaml")
ORACLES = os.path.join(HERE, "benchmarks", "work", "cnidaria",
                       "synthetic-seed0")
N_READS_MAX = 4_000_000
FASTQ = os.path.join(HERE, "benchmarks", "work", "synth",
                     f"cnidaria_synthetic-seed0_{N_READS_MAX}.fastq.gz")
OUT_DIR = os.path.join(HERE, "build", "chip_smoke")
KERNEL_N = 1 << 27
PART_ROWS = 1 << 26
GENOME_BASES = 1 << 20
CLOSURE_PARTS = 21
CLOSURE_MC = 2  # the closures' count floor
HBM_BYTES_PER_MS = 3.35e9  # the H100 SXM's 3.35 TB/s
STITCH_SHAPE = (2048, 1 << 16)
K = 19
INT64_MAX = (1 << 63) - 1
VARYING_STATS = ("command", "peak_memory_bytes")
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


def median_ms(torch, fn, reps: int) -> float:
    times = []
    for _ in range(reps):
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


def load_latency(torch) -> dict:
    """ns per dependent load (``csrc/chase.cu``) along a random ring of
    128 B lines: 2^15 lines (4 MB) walked once before the timed walks, so
    they hit L2; 2^23 lines (1 GB, the closure table's keys and counts),
    cold, so the loads go to DRAM. Median of three timed walks each."""
    import ctypes

    from sharkmer_tpu_torch.kernels import build

    lib = build.load("chase")
    lib.shk_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p]
    lib.shk_chase.restype = ctypes.c_int
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
    cand = cand[cand != INT64_MAX]
    if not cand.numel():
        return 0
    b = torch.unique(torch.clamp(cand >> side.shift, max=side.lut.shape[0] - 2))
    n_lut = torch.unique(torch.cat([b, b + 1])).numel()
    rows = int((side.lut[b + 1] - side.lut[b]).to(torch.int64).sum())
    return 4 * n_lut + 16 * rows


def routed_bytes(torch, table, cand) -> int:
    """``bucket_bytes`` of each candidate in the partition its key range
    routes it to."""
    from sharkmer_tpu_torch.kernels import probe

    part = probe.route_plain(table.first_keys, cand)
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


def closure_phase(torch, np, card: str, latency: dict) -> dict:
    """``reach_closure`` against ``closure_plain`` on a 2^26-row table,
    as one partition and cut into CLOSURE_PARTS; ``probe_rows`` against
    ``probe_rows_plain`` at the warm start's PRE_W keys. Each with its
    byte bound and its latency bound (``chain_ms``)."""
    from sharkmer_tpu_torch.kernels import closure, probe
    from sharkmer_tpu_torch.ops import reach
    from sharkmer_tpu_torch.ops.keys import keys_to_device, keys_to_numpy

    start = time.monotonic()
    keys, counts, n_real, fwd = closure_table(np, torch, PART_ROWS, K)
    tables = {"1 partition": probe.PartTable(
                  [reach.build_sidecar(keys, counts, K)], [0]),
              f"{CLOSURE_PARTS} partitions": cut_table(
                  torch, keys, counts, n_real, CLOSURE_PARTS, K)}
    torch.cuda.synchronize()
    print(f"closure table: {PART_ROWS} rows, {n_real} keys, "
          f"{GENOME_BASES}-base genome; built in "
          f"{time.monotonic() - start:.3f} s", flush=True)
    depth, f_cap, f_narrow = reach.DEPTH, reach.F_CAP, reach.F_NARROW
    n_k = fwd.shape[0]

    def c0_of(roots):
        c0 = np.full(8 * f_cap, reach.EMPTY, np.uint64)
        roots = np.unique(np.asarray(roots, np.uint64))
        c0[: len(roots)] = roots
        return keys_to_device(c0, "cuda")

    def run(table, c0, pre_ids, fn):
        return fn(table, c0, pre_ids, CLOSURE_MC, K, depth, f_cap, f_narrow)

    def event_ms(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out

    def check(label, table, c0, pre_ids, plain_twice):
        """Kernel against plain on one call, then CUDA-event times: the
        plain run that checked, 10 kernel runs, and a second plain run
        when ``plain_twice`` (plain, kernel x 10, plain)."""
        plain_ms, want = event_ms(
            lambda: run(table, c0, pre_ids, closure.closure_plain))
        got = run(table, c0, pre_ids, closure.reach_closure)
        gs = closure.unpack_state(got[2])
        ws = closure.unpack_state(want[2])
        require(gs == ws, f"reach_closure {label}: [n_vis, iters, overflow, "
                f"done] {gs} vs plain {ws}")
        require(not gs[2] and gs[1] > depth // 2,
                f"reach_closure {label}: overflow or a short walk {gs}")
        g_log, w_log = (torch.sort(x[0]).values for x in (got, want))
        err = int((g_log.to(torch.int64) - w_log.to(torch.int64)).abs().max())
        require(err == 0 and torch.equal(g_log, w_log),
                f"reach_closure {label}: sorted logs differ")
        g_b, w_b = (torch.unique(x[1][x[1] != INT64_MAX]) for x in (got, want))
        require(torch.equal(g_b, w_b),
                f"reach_closure {label}: boundary sets differ")
        ms = statistics.median(
            event_ms(lambda: run(table, c0, pre_ids, closure.reach_closure))[0]
            for _ in range(10))
        if plain_twice:
            plain_ms = (plain_ms + event_ms(lambda: run(
                table, c0, pre_ids, closure.closure_plain))[0]) / 2
        # levels that probed: up to 3 narrow levels after `done` ran on
        # an empty frontier
        levels = gs[1] - 3 * gs[3]
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "n_vis": gs[0], "iters": gs[1], "done": gs[3],
                  "boundary": int(g_b.numel()),
                  "library_ms": None,  # no torch op runs a BFS closure
                  **byte_bound(closure_bytes(torch, table, c0, pre_ids, g_log,
                                             gs, got[1], K)),
                  "latency_bound_ms": chain_ms(latency, levels),
                  "latency_levels": levels}
        print(f"reach_closure: exact on {label}: {result}; median "
              f"{ms:.4f} ms a call vs {plain_ms:.4f} ms plain on {card}",
              flush=True)
        return result, got

    record = {}
    for name, table in tables.items():
        narrow = c0_of(fwd[[n_k // 4, 3 * n_k // 4]])
        res, got = check(f"{name}, 2 roots (narrow)", table, narrow, None,
                         name == "1 partition")
        record[f"narrow, {name}"] = res
        wide = c0_of(fwd[np.linspace(1000, n_k - 1000, 48).astype(int)])
        record[f"wide, {name}"] = check(f"{name}, 48 roots (wide)", table,
                                        wide, None, False)[0]
        # a re-prefetch from the narrow call's boundary, warm-started with
        # its interior, as pcr/prefetch.py does
        log_sorted = torch.sort(got[0]).values
        visited, _ = reach._gather_rows(table, log_sorted[: res["n_vis"]])
        bound = keys_to_numpy(got[1])
        bound = bound[bound != reach.EMPTY]
        pre = np.setdiff1d(keys_to_numpy(visited), bound)
        pre_t = keys_to_device(reach._pad_pre(pre, roots=bound), "cuda")
        args = (table, pre_t, CLOSURE_MC)
        result = compare(torch, "probe_rows", lambda: probe.probe_rows(*args),
                         lambda: probe.probe_rows_plain(*args), 20, card,
                         f"{pre_t.numel()} warm-start keys, {name}")
        # every warm-start key was visited, so each one hits
        pre_ids = probe.probe_rows(*args)
        n_pre = int((pre_t != INT64_MAX).sum())
        require(int((pre_ids != probe.INF32).sum()) == n_pre > 0,
                f"probe_rows: not every one of {n_pre} warm-start keys hit")
        result.update(byte_bound(12 * pre_t.numel()
                                 + 48 * len(table.sidecars)
                                 + routed_bytes(torch, table, pre_t)))
        # one level of probes, all in parallel: the key, the LUT, the
        # bucket rows
        result["latency_bound_ms"] = chain_ms(latency, 1)
        record[f"probe_rows, {name}"] = result
        record[f"pre, {name}"] = check(f"{name}, warm start", table,
                                       c0_of(bound), pre_ids, False)[0]
    del tables, keys, counts
    torch.cuda.empty_cache()
    return record


class _RunLog(logging.Handler):
    """Keeps the CLI's stage-wall and sPCR-phase lines of each run and
    every fallback warning of the sPCR index."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines: list[str] = []
        self.fallbacks: list[str] = []

    def emit(self, record):
        msg = record.getMessage()
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


def drive_main_path(ctx, label: str, n_reads: int, extra=()):
    """One CLI run of the cnidaria cell at ``n_reads``; returns (the
    kernels' launch counts of this run, its stage-walls line)."""
    import yaml

    from sharkmer_tpu_torch.main import main

    torch, kernels, run_log, mirror_builds, plain_closures = ctx
    sample = f"synthetic-seed0_{n_reads}"
    oracle = os.path.join(ORACLES, str(n_reads))
    out = os.path.join(OUT_DIR, label)
    shutil.rmtree(out, ignore_errors=True)
    argv = ["-s", sample, "-k", str(K), "-t", "8", "-m", str(n_reads),
            "-o", out, "--pcr-panel-file", PANEL, *extra, FASTQ]
    torch.cuda.reset_peak_memory_stats()
    n_lines = len(run_log.lines)
    mirror_builds.clear()
    plain_closures.clear()
    for fn in kernels.values():
        fn.launches = 0
    start = time.monotonic()
    rc = main(argv)
    wall = time.monotonic() - start
    counts = {name: fn.launches for name, fn in kernels.items()}
    require(rc == 0, f"{label}: the CLI exited {rc}")
    require(not run_log.fallbacks,
            f"{label}: the sPCR index fell back: {run_log.fallbacks}")
    require(not plain_closures,
            f"{label}: {len(plain_closures)} closures ran the torch loop")
    require("--mirror" in extra or not mirror_builds,
            f"{label}: the host mirror was built under --mirror auto")
    lines = run_log.lines[n_lines:]
    counts["closure_calls"] = closure_calls(lines)
    walls = next(line for line in lines if "stage walls:" in line)
    print(f"{label}: CLI wall {wall:.3f} s; {walls}")
    for line in lines:
        if "sPCR phases:" in line:
            print(f"{label}: {line}")
    print(f"{label}: torch.cuda.max_memory_allocated() "
          f"{torch.cuda.max_memory_allocated()} bytes")
    print(f"{label}: host-mirror builds (to_sorted_arrays calls) "
          f"{len(mirror_builds)}")
    print(f"{label}: kernel launches {counts}", flush=True)

    want = sorted(f for f in os.listdir(oracle) if f.endswith(".fasta"))
    got = sorted(f for f in os.listdir(out) if f.endswith(".fasta"))
    require(len(want) == 7 and got == want,
            f"{label}: FASTA files {got} != {want}")
    for name in want:
        with open(os.path.join(oracle, name), "rb") as a, \
                open(os.path.join(out, name), "rb") as b:
            require(a.read() == b.read(), f"{label}: {name} differs")
    stats_name = f"{sample}.stats.yaml"
    with open(os.path.join(oracle, stats_name)) as a, \
            open(os.path.join(out, stats_name)) as b:
        sa, sb = yaml.safe_load(a), yaml.safe_load(b)
    for key in VARYING_STATS:
        sa.pop(key), sb.pop(key)
    require(sa == sb, f"{label}: stats.yaml differs: {sb} != {sa}")
    print(f"{label}: 7/7 FASTA byte-identical, stats.yaml equal "
          f"(but for {', '.join(VARYING_STATS)})", flush=True)
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


def main() -> int:
    require(os.path.isdir(os.path.join(HERE, "sharkmer_tpu_torch")),
            f"no sharkmer_tpu_torch package beside {__file__}")
    import torch

    require(torch.cuda.is_available(), "torch sees no CUDA device")
    sys.path.insert(0, HERE)
    import numpy as np

    from sharkmer_tpu_torch.io import native
    from sharkmer_tpu_torch.kernels import build, closure, probe, run_scan, stitch
    from sharkmer_tpu_torch.ops.sorted_store import SortedKmerStore

    t_start = time.monotonic()
    phase("1. card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s); using {kind}", flush=True)
    synth = None
    if not os.path.exists(FASTQ):
        synth = subprocess.Popen([
            sys.executable, "-c",
            "import sys; from sharkmer_tpu_torch.tools.synth import "
            "synthesize_panel_fastq as s; "
            "s(sys.argv[1], sys.argv[2], n_reads=int(sys.argv[3]), seed=0)",
            PANEL, FASTQ, str(N_READS_MAX),
        ], cwd=HERE)
    try:
        phase("2. build")
        start = time.monotonic()
        sources = sorted({os.path.basename(src)[:-3]
                          for src, _ in KERNELS.values()} | {"chase"})
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
                   "reach_closure": closure.reach_closure}

        phase("3. kernels vs plain PyTorch at the main path's shapes")
        latency = load_latency(torch)
        print(f"dependent-load latency: {latency['l2_ns']:.1f} ns through "
              f"L2, {latency['dram_ns']:.1f} ns from DRAM on {card}",
              flush=True)
        record = kernel_phase(torch, np, card, kernels)
        record.update(closure_phase(torch, np, card, latency))

        phase("4. main path: 1M reads, cnidaria panel, default drain budget")
        start = time.monotonic()
        if synth is not None:
            require(synth.wait() == 0, "FASTQ synthesis failed")
            synth = None
        print(f"FASTQ {os.path.relpath(FASTQ, HERE)} ready "
              f"({time.monotonic() - start:.2f} s waited)", flush=True)
        os.makedirs(OUT_DIR, exist_ok=True)
        run_log = _RunLog()
        logging.getLogger().addHandler(run_log)
        mirror_builds = []
        to_sorted_arrays = SortedKmerStore.to_sorted_arrays

        def counted_mirror(self, *args, **kwargs):
            mirror_builds.append(1)
            return to_sorted_arrays(self, *args, **kwargs)

        SortedKmerStore.to_sorted_arrays = counted_mirror
        # on the card the closure must never fall back to its torch loop
        plain_closure = closure.closure_plain

        plain_closures = []

        def counted_plain(*args, **kwargs):
            plain_closures.append(1)
            return plain_closure(*args, **kwargs)

        closure.closure_plain = counted_plain
        ctx = (torch, kernels, run_log, mirror_builds, plain_closures)
        os.environ.pop("SHARKMER_MAX_AGG", None)
        os.environ["SHARKMER_TORCH_DEVICE"] = "cuda"
        runs = {"default": drive_main_path(ctx, "default", 1_000_000)}

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
    finally:
        if synth is not None:
            synth.kill()
            synth.wait()

    required = {"run_ends": ("default", "max_agg_2^24"),
                "run_starts": ("default", "max_agg_2^24"),
                "probe_rows": ("default", "max_agg_2^24"),
                "stitch_rows": ("max_agg_2^24", "4M"),
                "reach_closure": ("default", "max_agg_2^24", "4M")}
    for name, labels in required.items():
        for label in labels:
            require(runs[label][0][name] >= 1,
                    f"{name} was not launched in the {label} run")
    for label in required["reach_closure"]:
        counts = runs[label][0]
        calls = counts["closure_calls"]
        require(counts["probe_rows"] <= calls <= counts["reach_closure"],
                f"{label}: {counts['probe_rows']} probe_rows and "
                f"{counts['reach_closure']} reach_closure launches for "
                f"{calls} closure calls")

    parts = f"{CLOSURE_PARTS} partitions"
    records = []
    for name, (source, replaces) in KERNELS.items():
        if name == "probe_rows":
            # a warm start's keys over CLOSURE_PARTS; on one beside it
            one = record["probe_rows, 1 partition"]
            rec = dict(record[f"probe_rows, {parts}"], **latency,
                       one_part_ms=one["ms"], one_part_plain_ms=one["plain_ms"])
        elif name == "reach_closure":
            # a narrow call on one partition; on CLOSURE_PARTS and a wide
            # call beside it
            narrow, wide = record[f"narrow, {parts}"], record["wide, 1 partition"]
            rec = dict(record["narrow, 1 partition"], **latency,
                       parts_ms=narrow["ms"], parts_plain_ms=narrow["plain_ms"],
                       parts_bound_ms=narrow["bound_ms"],
                       parts_latency_bound_ms=narrow["latency_bound_ms"],
                       wide_ms=wide["ms"], wide_plain_ms=wide["plain_ms"],
                       wide_bound_ms=wide["bound_ms"],
                       wide_latency_bound_ms=wide["latency_bound_ms"])
        else:
            rec = record[name]
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
