#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sharkmer_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own lines; every check raises on failure:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the CUDA kernels from ``sharkmer_tpu_torch/csrc`` (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the card, on 2^27
   sorted int64 keys (the drain width of the main path): exact equality,
   and the median time of each;
4. the main path: regenerate the 1M-read synthetic cnidaria FASTQ, run
   the port's CLI (``sharkmer_tpu_torch.main.main``, which is what
   ``python -m sharkmer_tpu_torch`` runs) in this process, and require
   the 7 FASTA files byte-identical and ``stats.yaml`` equal (but for
   ``command`` and ``peak_memory_bytes``) to the committed outputs of
   the JAX package in ``benchmarks/work/cnidaria/synthetic-seed0/1000000``;
5. the same run with ``SHARKMER_MAX_AGG=2^24``: many drains, staged
   merges and partition routing.

Each kernel's launch count is reset just before each main-path run and
read just after it; every kernel must have launched in both. The last
two lines of standard output are the kernels' JSON record and the
result line ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository around it, the script exits non-zero and prints
no result.
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
SAMPLE = "synthetic-seed0_1000000"
N_READS = 1_000_000
ORACLE = os.path.join(HERE, "benchmarks", "work", "cnidaria",
                      "synthetic-seed0", "1000000")
FASTQ = os.path.join(HERE, "benchmarks", "work", "synth",
                     "cnidaria_synthetic-seed0_1000000.fastq.gz")
PANEL = os.path.join(HERE, "sharkmer_tpu_torch", "panels", "cnidaria.yaml")
OUT_DIR = os.path.join(HERE, "build", "chip_smoke")
KERNEL_N = 1 << 27
INT64_MAX = (1 << 63) - 1
VARYING_STATS = ("command", "peak_memory_bytes")

KERNELS = {
    # name: the TPU kernel it replaces (wrapper -> pallas_call)
    "run_ends": "sharkmer_tpu/ops/pallas_kernels.py:264",
    "run_starts": "sharkmer_tpu/ops/pallas_kernels.py:132",
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


def median_ms(torch, fn, arg, reps: int) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class _WallsLog(logging.Handler):
    """Keeps the CLI's one-line stage-wall report of each run."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines: list[str] = []

    def emit(self, record):
        msg = record.getMessage()
        if "stage walls:" in msg:
            self.lines.append(msg.strip())


def drive_main_path(run_scan, torch, label: str, walls_log: _WallsLog):
    """One CLI run of the 1M-read cell; returns the kernels' launch
    counts of this run."""
    import yaml

    from sharkmer_tpu_torch.main import main

    out = os.path.join(OUT_DIR, label)
    shutil.rmtree(out, ignore_errors=True)
    argv = ["-s", SAMPLE, "-k", "19", "-t", "8", "-m", str(N_READS),
            "-o", out, "--pcr-panel-file", PANEL, FASTQ]
    torch.cuda.reset_peak_memory_stats()
    run_scan.run_ends.launches = 0
    run_scan.run_starts.launches = 0
    start = time.monotonic()
    rc = main(argv)
    wall = time.monotonic() - start
    counts = {"run_ends": run_scan.run_ends.launches,
              "run_starts": run_scan.run_starts.launches}
    require(rc == 0, f"{label}: the CLI exited {rc}")
    print(f"{label}: CLI wall {wall:.3f} s; {walls_log.lines[-1]}")
    print(f"{label}: torch.cuda.max_memory_allocated() "
          f"{torch.cuda.max_memory_allocated()} bytes")
    print(f"{label}: kernel launches {counts}", flush=True)

    want = sorted(f for f in os.listdir(ORACLE) if f.endswith(".fasta"))
    got = sorted(f for f in os.listdir(out) if f.endswith(".fasta"))
    require(len(want) == 7 and got == want,
            f"{label}: FASTA files {got} != {want}")
    for name in want:
        with open(os.path.join(ORACLE, name), "rb") as a, \
                open(os.path.join(out, name), "rb") as b:
            require(a.read() == b.read(), f"{label}: {name} differs")
    stats_name = f"{SAMPLE}.stats.yaml"
    with open(os.path.join(ORACLE, stats_name)) as a, \
            open(os.path.join(out, stats_name)) as b:
        sa, sb = yaml.safe_load(a), yaml.safe_load(b)
    for key in VARYING_STATS:
        sa.pop(key), sb.pop(key)
    require(sa == sb, f"{label}: stats.yaml differs: {sb} != {sa}")
    print(f"{label}: 7/7 FASTA byte-identical, stats.yaml equal "
          f"(but for {', '.join(VARYING_STATS)})", flush=True)
    return counts


def main() -> int:
    require(os.path.isdir(os.path.join(HERE, "sharkmer_tpu_torch")),
            f"no sharkmer_tpu_torch package beside {__file__}")
    import torch

    require(torch.cuda.is_available(), "torch sees no CUDA device")
    sys.path.insert(0, HERE)
    import numpy as np

    from sharkmer_tpu_torch.io import native
    from sharkmer_tpu_torch.kernels import build, run_scan
    from sharkmer_tpu_torch.tools.synth import synthesize_panel_fastq

    phase("1. card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s); using {kind}", flush=True)

    phase("2. build")
    start = time.monotonic()
    build.load("run_scan")
    print(f"csrc/run_scan.cu: nvcc build and load "
          f"{time.monotonic() - start:.2f} s")
    start = time.monotonic()
    reader = "native C++" if native.available() else "pure Python"
    print(f"FASTQ reader: {reader} ({time.monotonic() - start:.2f} s)",
          flush=True)

    phase(f"3. kernels vs plain PyTorch, {KERNEL_N} sorted int64 keys")
    keys = torch.from_numpy(sorted_test_keys(np, KERNEL_N)).cuda()
    record = {}
    for name in KERNELS:
        kernel = getattr(run_scan, name)
        plain = getattr(run_scan, f"{name}_plain")
        got, want = kernel(keys), plain(keys)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        require(got.dtype == want.dtype == torch.int32,
                f"{name}: dtype {got.dtype}")
        require(err == 0 and torch.equal(got, want),
                f"{name}: kernel differs from plain (max abs err {err})")
        del got, want
        # turns: plain, kernel, kernel, plain
        plain_ms = median_ms(torch, plain, keys, 5)
        ms = median_ms(torch, kernel, keys, 10)
        plain_ms = (plain_ms + median_ms(torch, plain, keys, 5)) / 2
        record[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"{name}: exact on {KERNEL_N} keys; median {ms:.4f} ms "
              f"kernel vs {plain_ms:.4f} ms plain on {card}", flush=True)
    del keys
    torch.cuda.empty_cache()

    phase("4. main path: 1M reads, cnidaria panel, default drain budget")
    start = time.monotonic()
    synthesize_panel_fastq(PANEL, FASTQ, n_reads=N_READS, seed=0)
    print(f"FASTQ {os.path.relpath(FASTQ, HERE)} ready in "
          f"{time.monotonic() - start:.2f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    walls_log = _WallsLog()
    logging.getLogger().addHandler(walls_log)
    os.environ.pop("SHARKMER_MAX_AGG", None)
    os.environ["SHARKMER_TORCH_DEVICE"] = "cuda"
    runs = [drive_main_path(run_scan, torch, "default", walls_log)]

    phase("5. main path again with SHARKMER_MAX_AGG=2^24")
    os.environ["SHARKMER_MAX_AGG"] = str(1 << 24)
    try:
        runs.append(drive_main_path(run_scan, torch, "max_agg_2^24",
                                    walls_log))
    finally:
        del os.environ["SHARKMER_MAX_AGG"]
    for name in KERNELS:
        for label, counts in zip(("default", "max_agg_2^24"), runs):
            require(counts[name] >= 1,
                    f"{name} was not launched in the {label} run")

    kernels = [
        {"name": name, "route": "cuda",
         "source": "sharkmer_tpu_torch/csrc/run_scan.cu",
         "replaces": KERNELS[name],
         "launches": sum(counts[name] for counts in runs),
         **record[name]}
        for name in KERNELS
    ]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
