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
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes: ``run_ends``/``run_starts`` on 2^27 sorted int64
   keys (the drain width), ``probe_rows`` on a 2^26-row partition with
   its LUT at 128 and 2048 candidates (a narrow and a wide closure
   level), ``stitch_rows`` on [2048, 65536] rows (the 2^27 drain v2):
   exact equality, and median CUDA-event times;
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
read just after it: ``run_ends``, ``run_starts`` and ``probe_rows`` must
launch in phases 4 and 5, ``stitch_rows`` in phases 5 and 7. A logged
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


def probe_partition(np, n_rows: int, k: int):
    """A de-ghosted partition from default_rng(1): 3/4 of ``n_rows``
    distinct sorted k-mer keys (random gaps, so no sort), counts in
    [1, 40), sentinel tail."""
    rng = np.random.default_rng(1)
    n_real = n_rows * 3 // 4
    gap = (1 << (2 * k)) // n_real
    keys = np.full(n_rows, INT64_MAX, np.int64)
    keys[:n_real] = np.cumsum(rng.integers(1, 2 * gap - 64, size=n_real))
    counts = np.zeros(n_rows, np.int64)
    counts[:n_real] = rng.integers(1, 40, size=n_real)
    return keys, counts, n_real


def probe_candidates(np, keys, counts, n_real: int, n_cand: int, mc: int,
                     seed: int):
    """Candidates: 40% keys at or above ``mc``, 20% keys below it, 25%
    random keys (almost all absent), 15% the sentinel."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_real, size=8 * n_cand)
    high = rows[counts[rows] >= mc][: n_cand * 2 // 5]
    low = rows[counts[rows] < mc][: n_cand // 5]
    n_rand = n_cand * 1 // 4
    cand = np.concatenate([
        keys[high], keys[low],
        rng.integers(0, int(keys[n_real - 1]), size=n_rand),
    ])
    cand = np.concatenate(
        [cand, np.full(n_cand - cand.size, INT64_MAX, np.int64)])
    rng.shuffle(cand)
    return cand


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
            what: str) -> dict:
    """Exact equality of kernel() and plain(), then median times in
    turns: plain, kernel, kernel, plain."""
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
    del got, want
    plain_ms = median_ms(torch, plain, reps)
    ms = (median_ms(torch, kernel, reps) + median_ms(torch, kernel, reps)) / 2
    plain_ms = (plain_ms + median_ms(torch, plain, reps)) / 2
    print(f"{name}: exact on {what}; median {ms:.4f} ms kernel vs "
          f"{plain_ms:.4f} ms plain on {card}", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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


def drive_main_path(ctx, label: str, n_reads: int, extra=()):
    """One CLI run of the cnidaria cell at ``n_reads``; returns (the
    kernels' launch counts of this run, its stage-walls line)."""
    import yaml

    from sharkmer_tpu_torch.main import main

    torch, kernels, run_log, mirror_builds = ctx
    sample = f"synthetic-seed0_{n_reads}"
    oracle = os.path.join(ORACLES, str(n_reads))
    out = os.path.join(OUT_DIR, label)
    shutil.rmtree(out, ignore_errors=True)
    argv = ["-s", sample, "-k", str(K), "-t", "8", "-m", str(n_reads),
            "-o", out, "--pcr-panel-file", PANEL, *extra, FASTQ]
    torch.cuda.reset_peak_memory_stats()
    n_lines = len(run_log.lines)
    mirror_builds.clear()
    for fn in kernels.values():
        fn.launches = 0
    start = time.monotonic()
    rc = main(argv)
    wall = time.monotonic() - start
    counts = {name: fn.launches for name, fn in kernels.items()}
    require(rc == 0, f"{label}: the CLI exited {rc}")
    require(not run_log.fallbacks,
            f"{label}: the sPCR index fell back: {run_log.fallbacks}")
    lines = run_log.lines[n_lines:]
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


def kernel_phase(torch, np, card: str, kernels) -> dict:
    from sharkmer_tpu_torch.kernels import probe, run_scan, stitch
    from sharkmer_tpu_torch.ops import reach

    record = {}
    keys = torch.from_numpy(sorted_test_keys(np, KERNEL_N)).cuda()
    for name in ("run_ends", "run_starts"):
        kernel, plain = kernels[name], getattr(run_scan, f"{name}_plain")
        record[name] = compare(torch, name, lambda: kernel(keys),
                               lambda: plain(keys), 5, card,
                               f"{KERNEL_N} sorted keys")
    del keys
    torch.cuda.empty_cache()

    pk, pc, n_real = probe_partition(np, PART_ROWS, K)
    keys, counts = torch.from_numpy(pk).cuda(), torch.from_numpy(pc).cuda()
    start = time.monotonic()
    side = reach.build_sidecar(keys, counts, K)
    torch.cuda.synchronize()
    print(f"probe partition: {PART_ROWS} rows, {n_real} keys; build_sidecar "
          f"{time.monotonic() - start:.3f} s: bits {side.bits}, "
          f"probe_blocks {side.probe_blocks}", flush=True)
    mc = 20
    for n_cand in (128, 2048):
        cand = torch.from_numpy(probe_candidates(
            np, pk, pc, n_real, n_cand, mc, seed=n_cand)).cuda()
        args = (keys, counts, side.lut, side.shift, cand, mc,
                side.probe_blocks)
        result = compare(torch, "probe_rows", lambda: probe.probe_rows(*args),
                         lambda: probe.probe_rows_plain(*args), 50, card,
                         f"{n_cand} candidates, a {PART_ROWS}-row partition")
        hits = int((probe.probe_rows(*args) >= 0).sum())
        require(hits >= n_cand // 3, f"probe_rows: only {hits} hits")
        print(f"probe_rows: {hits} of {n_cand} candidates hit", flush=True)
        record[f"probe_rows@{n_cand}"] = result
    del keys, counts, side
    torch.cuda.empty_cache()

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
    from sharkmer_tpu_torch.kernels import build, probe, run_scan, stitch
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
                          for src, _ in KERNELS.values()})
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
                   "stitch_rows": stitch.stitch_rows}

        phase("3. kernels vs plain PyTorch at the main path's shapes")
        record = kernel_phase(torch, np, card, kernels)

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
        ctx = (torch, kernels, run_log, mirror_builds)
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
                "stitch_rows": ("max_agg_2^24", "4M")}
    for name, labels in required.items():
        for label in labels:
            require(runs[label][0][name] >= 1,
                    f"{name} was not launched in the {label} run")

    records = []
    for name, (source, replaces) in KERNELS.items():
        if name == "probe_rows":
            # the wide level's shape; the narrow one is printed above
            rec = dict(record["probe_rows@2048"],
                       narrow_ms=record["probe_rows@128"]["ms"],
                       narrow_plain_ms=record["probe_rows@128"]["plain_ms"])
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
