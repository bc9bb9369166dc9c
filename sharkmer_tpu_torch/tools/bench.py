#!/usr/bin/env python3
"""Benchmark of the port: k-mer counting throughput and sPCR wall time.

The counterpart of the repository's ``bench.py``: the same read
generator (``make_genome_codes``, ``make_reads_codes``: the same reads
from the same seed), the same flags where they apply, the same timed
passes and the same JSON keys, on ``sharkmer_tpu_torch``. Prints ONE
JSON line:

  {"metric": "kmers_per_sec_per_chip", "value": N, "unit": "kmer/s",
   "vs_baseline": N, "spcr_wall_s": S, "spcr_genes_ok": G,
   "mirror_export_s": M, "e2e_wall_s": E, "e2e_vs_baseline": R,
   "e2e_8m_wall_s": E8, "e2e_8m_vs_baseline": R8, ...}

The 1M row: 1M synthetic 150 bp reads with 1% substitution errors over
a 20 Mbp genome that holds the cnidaria panel's amplicons, k=21,
2^18-read batches already on the device. ``value`` times the count pass
(encode, drains, merges, the final spectrum); ``mirror_export_s`` the
sPCR index build (or the host mirror under ``--mirror full``);
``spcr_wall_s`` the whole panel through ``run_pcr``; ``e2e_wall_s``
their sum. A second row at 8M reads (``--reads-large``) keeps every
batch on the device and frees each as it is counted. A failure in
either row exits non-zero.

The baselines are the upstream sharkmer CLI's CPU walls (``BASELINE.md``:
131,779,117 k-mer events from 1M reads in 22.5 s with the 7-gene sPCR
pass, 169.1 s at 8M reads, on a 12-core aarch64 at 8 threads), not
accelerator numbers.

Each row also reports each card's peak allocation
(``torch.cuda.max_memory_allocated``, reset before the row) and the card
(``nvidia-smi`` name and power limit). The bench runs on ``cuda`` unless
``SHARKMER_TORCH_DEVICE=cpu`` is set. Left out, as TPU workarounds: the
subprocess orchestrator (JAX's device exclusivity), the compile-cache
evidence run and the deep-shape compile warmup.

  python -m sharkmer_tpu_torch.tools.bench            # 1M and 8M rows
  python -m sharkmer_tpu_torch.tools.bench --quick    # small smoke run
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import numpy as np

_T0 = time.perf_counter()

BASELINE_KMERS_PER_SEC = 131_779_117 / 22.5
BASELINE_E2E_WALL_S = 22.5   # upstream CLI: 1M-read cnidaria run, count+sPCR
BASELINE_E2E_8M_WALL_S = 169.1  # upstream CLI: same panel at 8M reads

GEN_SLAB = 1_000_000  # reads generated per host slab (bounds peak RAM)


def _stage(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def make_genome_codes(genome_mbp: float, seed: int = 0,
                      panel: str | None = None) -> np.ndarray:
    """uint8-code genome; optionally embeds one exact amplicon per
    primer pair of ``panel`` (IUPAC positions realized concretely)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=int(genome_mbp * 1e6), dtype=np.uint8)
    if panel is None:
        return genome
    from sharkmer_tpu_torch.ops.encoding import ascii_to_codes
    from sharkmer_tpu_torch.pcr.panels import get_panel
    from sharkmer_tpu_torch.pcr.params import IUPAC

    rc = str.maketrans("ACGT", "TGCA")
    pos = 1000
    for p in get_panel(panel):
        fwd = "".join(
            c if c in "ACGT" else rng.choice(list(IUPAC[c]))
            for c in p.forward_seq
        )
        rev = "".join(
            c if c in "ACGT" else rng.choice(list(IUPAC[c]))
            for c in p.reverse_seq
        )
        total = p.expected_length or (p.min_length + p.max_length) // 2
        insert = "".join(
            rng.choice(list("ACGT"), size=total - len(fwd) - len(rev))
        )
        amp = fwd + insert + rev.translate(rc)[::-1]
        # panel targets are high-copy genes (rRNA repeats, mito): embed
        # 8 copies so amplicon k-mers sit well above min_count at ~7.5x
        # genome-wide coverage, like real data
        codes = ascii_to_codes(amp)
        for _ in range(8):
            genome[pos : pos + len(codes)] = codes
            pos += len(codes) + 2000
    return genome


def make_reads_codes(n_reads: int, read_len: int, genome_mbp: float,
                     seed: int = 0, panel: str | None = None,
                     error_rate: float = 0.01):
    """Reads as uint8 code batches sliced straight out of a code genome,
    with uniform random substitution errors at ``error_rate`` per base,
    generated in GEN_SLAB slabs (bounded temporaries at 8M reads)."""
    rng = np.random.default_rng(seed)
    genome = make_genome_codes(genome_mbp, seed, panel)
    out = np.empty((n_reads, read_len), np.uint8)
    col = np.arange(read_len)[None, :]
    for s in range(0, n_reads, GEN_SLAB):
        n = min(GEN_SLAB, n_reads - s)
        starts = rng.integers(0, len(genome) - read_len, size=n)
        reads = genome[starts[:, None] + col]
        if error_rate > 0.0:
            err = rng.random(reads.shape) < error_rate
            # substitute with a DIFFERENT base: add 1..3 mod 4
            shift = rng.integers(1, 4, size=reads.shape, dtype=np.uint8)
            reads = np.where(err, (reads + shift) % 4, reads).astype(np.uint8)
        out[s : s + n] = reads
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--reads", type=int, default=1_000_000)
    parser.add_argument("--reads-large", type=int, default=8_000_000,
                        help="second timed config (0 disables); the "
                             "upstream CLI's largest committed row")
    parser.add_argument("--read-len", type=int, default=150)
    parser.add_argument("--k", type=int, default=21)
    parser.add_argument("--genome-mbp", type=float, default=20.0)
    parser.add_argument("--batch", type=int, default=1 << 18)
    parser.add_argument("--capacity", type=int, default=1 << 26,
                        help="the hash table's first capacity")
    parser.add_argument("--backend", choices=["sorted", "hash"],
                        default="sorted")
    parser.add_argument("--panel", default="cnidaria",
                        help="panel whose amplicons are embedded + amplified")
    parser.add_argument("--threads", type=int, default=4,
                        help="gene-level sPCR thread pool")
    parser.add_argument("--error-rate", type=float, default=0.01,
                        help="per-base sequencing-error rate for the reads")
    parser.add_argument("--mirror", choices=["auto", "full", "device"],
                        default="auto",
                        help="sPCR lookup strategy (auto = device "
                             "reach-prefetch, full = host mirror export)")
    parser.add_argument("--quick", action="store_true",
                        help="small shapes for smoke testing")
    return parser


def make_store_factory(args, device):
    """A function that makes an empty count table of ``args.backend``."""
    if args.backend == "sorted":
        from sharkmer_tpu_torch.ops.sorted_store import SortedKmerStore

        def make_store():
            return SortedKmerStore(args.k, device)
    else:
        from sharkmer_tpu_torch.ops.hashtable import KmerTable

        def make_store():
            return KmerTable.create(args.k, args.capacity, device)
    return make_store


def build_batches(args, n_reads: int, device, seed: int = 0):
    """``make_reads_codes``' reads as [batch, read_len] uint8 tensors on
    ``device``; the last one padded with code 5 (no k-mer)."""
    import torch

    codes_all = make_reads_codes(
        n_reads, args.read_len, args.genome_mbp, seed=seed,
        panel=args.panel, error_rate=args.error_rate,
    )
    n_batches = -(-n_reads // args.batch)
    pad = n_batches * args.batch - n_reads
    if pad:
        codes_all = np.concatenate(
            [codes_all, np.full((pad, args.read_len), 5, np.uint8)]
        )
    return [
        torch.from_numpy(codes_all[b * args.batch : (b + 1) * args.batch])
        .to(device)
        for b in range(n_batches)
    ], n_batches


def count_pass(make_store, batches, consume: bool = False):
    """Count every batch into a new table (encode on the device, then
    insert), then take the spectrum. Returns (table, distinct k-mers)."""
    from sharkmer_tpu_torch.ops.encoding import canonical_kmers

    store = make_store()
    for i, codes in enumerate(batches):
        kmers = canonical_kmers(codes, store.k)
        store = store.insert_kmers(kmers.reshape(-1))
        if consume:  # free each batch's device buffer as it lands
            batches[i] = None
    histo = store.histogram(10_000)
    return store, int(np.sum(histo))


def spcr_phase(args, store, n_reads: int, device):
    """sPCR prep + full panel against ``store``. Returns
    (prep_wall, spcr_wall, genes_ok, n_genes)."""
    import tempfile

    from sharkmer_tpu_torch.device import synchronize
    from sharkmer_tpu_torch.pcr.counts import FilteredTable
    from sharkmer_tpu_torch.pcr.graph import compute_node_budget
    from sharkmer_tpu_torch.pcr.panels import get_panel
    from sharkmer_tpu_torch.stats import run_pcr

    panel_params = get_panel(args.panel)
    _memory(device, "pre-spcr")
    t0 = time.perf_counter()
    filtered = FilteredTable(store, min_count=2, mode=args.mirror)
    # one device index build (auto) or device->host export (full)
    filtered.warm_caches()
    synchronize(device)
    prep_wall = time.perf_counter() - t0
    _memory(device, "post-index")

    # the node budget the CLI resolves (graph.rs:40-52)
    max_nodes = compute_node_budget(n_reads * args.read_len)
    with tempfile.TemporaryDirectory() as outdir:
        _stage(f"timed: sPCR panel, {n_reads} reads "
               f"(node budget {max_nodes})")
        t0 = time.perf_counter()
        results = run_pcr(
            filtered, panel_params, "bench", outdir + "/",
            max_nodes=max_nodes, threads=args.threads,
        )
        synchronize(device)
        spcr_wall = time.perf_counter() - t0
    genes_ok = sum(1 for r in results if r.status == "success")
    for r in results:
        tag = "+" if r.status == "success" else "-"
        _stage(f"  {tag} {r.gene_name} ({len(r.product_lengths)} "
               f"product(s) {r.product_lengths})")
    return prep_wall, spcr_wall, genes_ok, len(panel_params)


def _memory(device, tag: str) -> None:
    """Allocated and peak device memory at a stage boundary."""
    import torch

    if device.type == "cuda":
        _stage(f"  memory[{tag}]: "
               f"{torch.cuda.memory_allocated(device) / 1e9:.2f} GB (peak "
               f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f})")


def reset_peaks() -> None:
    import torch

    if torch.cuda.is_available():
        for index in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(index)


def peaks() -> dict | None:
    """Each card's ``torch.cuda.max_memory_allocated`` since the last
    ``reset_peaks``, or None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    return {f"cuda:{i}": torch.cuda.max_memory_allocated(i)
            for i in range(torch.cuda.device_count())}


def card() -> str | None:
    """The first card's name and power limit, as ``nvidia-smi`` gives
    them, or None without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def run_bench(args) -> dict:
    """A warmup pass (the kernels' first build and load, the caching
    allocator's first growth), then the timed 1M row and the timed 8M
    row through the production tables."""
    from sharkmer_tpu_torch.device import default_device
    from sharkmer_tpu_torch.pcr.counts import FilteredTable

    device = default_device()
    make_store = make_store_factory(args, device)

    _stage(f"generating {args.reads} reads "
           f"(error rate {args.error_rate}) on {device}")
    batches, n_batches = build_batches(args, args.reads, device)
    kmers_per_batch = args.batch * (args.read_len - args.k + 1)

    _stage("warmup: count pass")
    warm_store, _ = count_pass(make_store, batches)
    _stage(f"warmup: sPCR prep, mode={args.mirror}")
    FilteredTable(warm_store, min_count=2, mode=args.mirror).warm_caches()
    del warm_store
    gc.collect()
    warmup_wall = time.perf_counter() - _T0

    reset_peaks()
    _stage("timed: count pass")
    t0 = time.perf_counter()
    store, n_unique = count_pass(make_store, batches)
    count_wall = time.perf_counter() - t0
    total_kmers = n_batches * kmers_per_batch
    assert n_unique > 0
    del batches

    _stage(f"timed: sPCR prep (mode={args.mirror}, {n_unique} unique)")
    prep_wall, spcr_wall, genes_ok, n_genes = spcr_phase(
        args, store, args.reads, device
    )
    del store
    gc.collect()

    kmers_per_sec = total_kmers / count_wall
    e2e_wall = count_wall + prep_wall + spcr_wall
    result = {
        "metric": "kmers_per_sec_per_chip",
        "value": round(kmers_per_sec),
        "unit": "kmer/s",
        "vs_baseline": round(kmers_per_sec / BASELINE_KMERS_PER_SEC, 3),
        "error_rate": args.error_rate,
        "spcr_wall_s": round(spcr_wall, 2),
        "spcr_genes_ok": f"{genes_ok}/{n_genes}",
        "mirror_export_s": round(prep_wall, 2),
        "e2e_wall_s": round(e2e_wall, 2),
        "e2e_vs_baseline": round(BASELINE_E2E_WALL_S / e2e_wall, 3),
        "warmup_wall_s": round(warmup_wall, 1),
        "count_wall_s": count_wall,
        "device_peak_bytes": peaks(),
    }

    # ---- 8M-read row (the upstream CLI's largest committed config) --------
    if args.reads_large:
        _stage(f"generating {args.reads_large} reads")
        batches8, n_batches8 = build_batches(args, args.reads_large, device)
        reset_peaks()
        _stage("timed: count pass (8M)")
        t0 = time.perf_counter()
        store8, n_unique8 = count_pass(make_store, batches8, consume=True)
        count8_wall = time.perf_counter() - t0
        _memory(device, "post-count-8m")
        del batches8
        gc.collect()
        total8 = n_batches8 * kmers_per_batch
        parts8 = [int(p.kmers.shape[0]) for p in getattr(store8, "parts", [])]
        _stage(f"timed: sPCR prep+panel (8M, {n_unique8} unique, "
               f"{len(parts8)} partitions)")
        prep8, spcr8, genes_ok8, _ = spcr_phase(
            args, store8, args.reads_large, device
        )
        del store8
        e2e8 = count8_wall + prep8 + spcr8
        result.update({
            "kmers_per_sec_8m": round(total8 / count8_wall),
            "spcr_8m_wall_s": round(prep8 + spcr8, 2),
            "spcr_8m_genes_ok": f"{genes_ok8}/{n_genes}",
            "e2e_8m_wall_s": round(e2e8, 2),
            "e2e_8m_vs_baseline": round(BASELINE_E2E_8M_WALL_S / e2e8, 3),
            "count_8m_wall_s": count8_wall,
            "device_peak_8m_bytes": peaks(),
        })
    result["device"] = str(device)
    result["card"] = card()
    return result


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.quick:
        args.reads, args.batch = 50_000, 1 << 14
        args.capacity, args.genome_mbp = 1 << 22, 1.0
        args.reads_large = 0
    print(json.dumps(run_bench(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
