#!/usr/bin/env python3
"""Per-stage times of the count loop: the drain path, and with
``--fastq`` the main path's host stages.

The counterpart of the repository's ``scripts/profile_count.py``: the
same arguments, the same keys (``default_rng(0)``: ``n // 5`` unique
keys below ``4^k``, ``n`` draws from them, masked; here as int64 on the
device through ``ops/keys.py``) and the same stages, one line each, on
``sharkmer_tpu_torch``'s sorted store at ``2^width`` raw k-mers (2^27,
the store's drain width on the card):

* the flat sort (``torch.sort`` of the int64 keys);
* ``kernels/run_scan.run_starts``, forward, and on the flipped keys;
* the ghosted drain (``ops/sorted_store._aggregate_ingest_ghosted``,
  on ``run_ends``), the first drain of a run;
* drain v2 (``_aggregate_ingest_v2`` with ``count_bits = 64 - 2k``, on
  ``run_starts`` and ``stitch_rows``; an input narrower than one
  ``ROW_W`` row is padded to one with sentinels);
* ``histogram(10000)`` of a store seeded with the keys;
* the full ``insert_kmers`` + flush + histogram pass, with its M
  elements a second.

Each stage is the median of ``--iters`` calls after one warm call, timed
by CUDA events on the card (the host clock on the CPU); each drain gets
a fresh device copy of its input, made outside the timed window. Beside
each stage: the launches of each kernel over its calls (the wrappers'
``.launches`` counters; 0 on the CPU, where the plain versions run).

With ``--fastq PATH [--max-reads N]`` it also times the CLI's host
stages over that file (the port's modules as the CLI calls them; none
is changed):

(a) ``io/native.NativeFastqReader.read_batch`` alone at the CLI's 2^17
    reads a batch: gzip inflate and parse (``csrc/sharkio.cpp``);
(a') zlib's inflate alone, in C (``gzread`` of the zlib the loader
    links into one fixed 1 MB buffer, every gzip member) until the reads
    of (a) are out: the least that (a) can take with that inflate, parse
    left out;
(b) ``PrefetchingBatches`` (depth 3) with a consumer that does nothing:
    whether one producer thread alone sets the pace;
(c) the consumer's host count of valid bases, ``np.sum(codes <
    CODE_N)`` (``engine._ingest_codes_array``), over batches in memory;
(d) the upload of those batches from pageable memory, as the engine
    does it; beside it, through one pinned buffer with
    ``non_blocking=True`` (host copy into it included, and alone);
(e) ``encoding.canonical_kmers`` + ``insert_kmers`` + the flush over
    the batches already on the device.

Its last line but one names the larger of the producer (a) and the
consumer (c + d + e) as the stage that sets the ingest wall, with (a)
over (a'); the last
line is one JSON object of every number. Runs on the card unless
``SHARKMER_TORCH_DEVICE=cpu``:

    python -m sharkmer_tpu_torch.tools.ingest_phase [--width 27] [--iters 3] [--k 21]
    python -m sharkmer_tpu_torch.tools.ingest_phase --fastq reads.fastq.gz --k 19
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from ..device import default_device, synchronize
from ..kernels import run_scan, stitch
from ..ops import encoding
from ..ops.keys import SENTINEL, keys_to_device
from ..ops.sorted_store import (
    ROW_W,
    SortedKmerStore,
    _aggregate_ingest_ghosted,
    _aggregate_ingest_v2,
)
from .bench import card

KERNELS = {"run_starts": run_scan.run_starts, "run_ends": run_scan.run_ends,
           "stitch_rows": stitch.stitch_rows}
CLI_BATCH_READS = 1 << 17  # main.py's PrefetchingBatches batch
CLI_DEPTH = 3  # and its queue depth
HISTO_MAX = 10_000


def make_keys(width: int, k: int, device) -> torch.Tensor:
    """``profile_count.py``'s keys, ~5.3x duplication like the 1M-read
    noisy workload, as device int64 keys."""
    n = 1 << width
    rng = np.random.default_rng(0)
    mask = np.uint64((1 << (2 * k)) - 1)
    uniq = rng.integers(0, 1 << (2 * k), size=n // 5, dtype=np.uint64)
    raw = uniq[rng.integers(0, len(uniq), size=n)] & mask
    return keys_to_device(raw, device)


def time_ms(fn, iters: int, device, fresh=None) -> float:
    """Median ms of ``iters`` calls of ``fn`` after one warm call; with
    ``fresh``, each call gets ``fresh()``, made before its timed window."""

    def once():
        arg = () if fresh is None else (fresh(),)
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn(*arg)
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        start = time.perf_counter()
        fn(*arg)
        return (time.perf_counter() - start) * 1e3

    once()
    return statistics.median(once() for _ in range(iters))


def full_pass(buf: torch.Tensor, k: int) -> SortedKmerStore:
    """A store fed ``buf`` (a device copy: no upload) and flushed."""
    store = SortedKmerStore(k, buf.device)
    store.insert_kmers(buf.clone())
    store._flushed()
    return store


def v2_input(buf: torch.Tensor) -> torch.Tensor:
    """``buf`` as drain v2 takes it, whole ``ROW_W`` rows: a fresh copy,
    padded with sentinels where it is narrower."""
    width = -(-buf.numel() // ROW_W) * ROW_W
    out = torch.full((width,), SENTINEL, dtype=torch.int64, device=buf.device)
    out[: buf.numel()] = buf
    return out


def drain_stages(width: int, k: int, iters: int, device) -> dict:
    """The drain path's stages at ``2^width`` keys, each printed and
    recorded as {"ms", "launches"}."""
    n = 1 << width
    buf = make_keys(width, k, device)
    synchronize(device)
    print(f"width 2^{width} = {n} kmers, k={k}, ~{n // 5} unique, device "
          f"{device}", flush=True)
    sk = torch.sort(buf).values
    count_bits = 64 - 2 * k
    stages = {
        "flat sort (torch.sort, int64)":
            (lambda: torch.sort(buf).values, None),
        "run_starts (fwd)": (lambda: run_scan.run_starts(sk), None),
        "flip + run_starts (bwd)":
            (lambda: run_scan.run_starts(torch.flip(sk, (0,))), None),
        "ghosted drain (sort + run_ends + counts)":
            (_aggregate_ingest_ghosted, buf.clone),
        "v2 drain (sort + run_starts + row compact + stitch_rows)":
            (lambda keys: _aggregate_ingest_v2(keys, count_bits),
             lambda: v2_input(buf)),
    }
    record = {}
    for label, (fn, fresh) in stages.items():
        record[label] = _stage(label, fn, iters, device, fresh)
    del sk
    _, _, n_padded, n_real = _aggregate_ingest_ghosted(buf.clone())
    print(f"  (n_padded={n_padded}, n_real={n_real})", flush=True)
    record["ghosted rows"] = {"n_padded": int(n_padded), "n_real": int(n_real)}

    store = full_pass(buf, k)
    record["histogram(10000) on seeded store"] = _stage(
        "histogram(10000) on seeded store", lambda: store.histogram(HISTO_MAX),
        iters, device)
    del store
    for fn in KERNELS.values():
        fn.launches = 0
    synchronize(device)
    start = time.perf_counter()
    histo = full_pass(buf, k).histogram(HISTO_MAX)
    seconds = time.perf_counter() - start
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    print(f"{'full insert+flush+histogram':56s} {seconds * 1e3:10.3f} ms  "
          f"launches {launches} in 1 call", flush=True)
    print(f"-> {n / seconds / 1e6:.1f} M ingest-elems/s upper bound (excl. "
          f"encode)", flush=True)
    record["full insert+flush+histogram"] = {
        "ms": seconds * 1e3, "launches": launches,
        "m_elems_per_s": n / seconds / 1e6,
        "distinct": int(histo.sum())}
    return record


def _stage(label: str, fn, iters: int, device, fresh=None) -> dict:
    for kernel in KERNELS.values():
        kernel.launches = 0
    ms = time_ms(fn, iters, device, fresh)
    launches = {name: kernel.launches for name, kernel in KERNELS.items()}
    print(f"{label:56s} {ms:10.3f} ms  launches {launches} in {iters + 1} "
          f"calls", flush=True)
    return {"ms": ms, "launches": launches, "calls": iters + 1}


def inflate_alone(path: str, max_reads: int) -> dict:
    """Stage (a'): the inflate alone, in C, through the zlib that the
    native loader links (``libz.so.1``): ``gzopen`` with the loader's 1 MB
    ``gzbuffer``, then ``gzread`` into one fixed 1 MB buffer, member after
    member, until ``4 * max_reads`` lines are out (the whole stream with
    0). ``inflate_s`` sums the ``gzread`` calls alone (the newline count
    is outside it); also the gzip bytes
    consumed, the bytes inflated and the lines (newlines) seen. A file
    that is not gzip is not measured (None)."""
    import ctypes

    with open(path, "rb") as f:
        if f.read(2) != b"\x1f\x8b":
            return None
    z = ctypes.CDLL("libz.so.1")
    z.gzopen.restype, z.gzopen.argtypes = ctypes.c_void_p, [
        ctypes.c_char_p, ctypes.c_char_p]
    z.gzbuffer.argtypes = [ctypes.c_void_p, ctypes.c_uint]
    z.gzread.restype, z.gzread.argtypes = ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint]
    z.gzoffset64.restype, z.gzoffset64.argtypes = ctypes.c_int64, [
        ctypes.c_void_p]
    z.gzclose.argtypes = [ctypes.c_void_p]
    block = np.empty(1 << 20, np.uint8)
    want = 4 * max_reads if max_reads > 0 else None
    gz = z.gzopen(os.fsencode(path), b"rb")
    if not gz:
        raise OSError(f"inflate_alone: gzopen failed on {path}")
    z.gzbuffer(gz, 1 << 20)
    n_out = lines = 0
    inflate_s = 0.0
    try:
        while want is None or lines < want:
            t0 = time.perf_counter()
            got = z.gzread(gz, block.ctypes.data, block.size)
            inflate_s += time.perf_counter() - t0
            if got < 0:
                raise OSError(f"inflate_alone: gzread failed on {path}")
            if got == 0:
                break
            n_out += got
            lines += int(np.count_nonzero(block[:got] == 10))
        n_in = z.gzoffset64(gz)
    finally:
        z.gzclose(gz)
    return {"inflate_s": inflate_s, "gzip_bytes": n_in,
            "inflated_bytes": n_out, "inflated_lines": lines}


def fastq_stages(path: str, max_reads: int, k: int, device) -> dict:
    """The host stages (a)-(e) over the first ``max_reads`` reads of
    ``path`` (all with 0), each printed and recorded in seconds."""
    from ..io import native

    if not native.available():
        raise RuntimeError("ingest_phase: the native FASTQ loader is "
                           "unavailable (g++ and zlib build it)")

    def clip(batch, n_reads):
        """``batch`` cut to the reads left after ``n_reads``."""
        codes, lens = batch
        if max_reads > 0:
            left = max_reads - n_reads
            codes, lens = codes[:left], lens[:left]
        return codes, lens

    # (a) the reader alone; the batches are kept for (c)-(e)
    batches, n_reads, n_bases = [], 0, 0
    start = time.perf_counter()
    with native.NativeFastqReader(path) as reader:
        while max_reads <= 0 or n_reads < max_reads:
            batch = reader.read_batch(CLI_BATCH_READS)
            if batch is None:
                break
            codes, lens = clip(batch, n_reads)
            batches.append(codes)
            n_reads += codes.shape[0]
            n_bases += int(lens.sum())
    read_s = time.perf_counter() - start
    print(f"(a) read_batch alone: {n_reads} reads, {n_bases} bases in "
          f"{len(batches)} batches of {CLI_BATCH_READS}: {read_s:.3f} s",
          flush=True)
    inflated = inflate_alone(path, n_reads)
    if inflated is None:
        print("(a') inflate alone: not measured (not a gzip file)",
              flush=True)
    else:
        print(f"(a') zlib gzread alone: {inflated['gzip_bytes']} gzip "
              f"bytes to {inflated['inflated_bytes']} bytes, "
              f"{inflated['inflated_lines']} lines: "
              f"{inflated['inflate_s']:.3f} s; read_batch (a) takes "
              f"{read_s / inflated['inflate_s']:.3f}x that", flush=True)

    # (b) the producer thread with a consumer that does nothing
    seen = 0
    start = time.perf_counter()
    with native.NativeFastqReader(path) as reader, \
            native.PrefetchingBatches(reader, batch_reads=CLI_BATCH_READS,
                                      depth=CLI_DEPTH) as pump:
        for batch in pump:
            seen += clip(batch, seen)[0].shape[0]
            if max_reads > 0 and seen >= max_reads:
                break
    prefetch_s = time.perf_counter() - start
    if seen != n_reads:
        raise RuntimeError(f"ingest_phase: the prefetcher gave {seen} reads, "
                           f"read_batch {n_reads}")
    print(f"(b) PrefetchingBatches (depth {CLI_DEPTH}), idle consumer: "
          f"{prefetch_s:.3f} s", flush=True)

    # (c) the consumer's host count of valid bases
    start = time.perf_counter()
    valid_bases = sum(int(np.sum(codes < encoding.CODE_N))
                      for codes in batches)
    count_s = time.perf_counter() - start
    print(f"(c) np.sum(codes < CODE_N): {valid_bases} valid bases, "
          f"{count_s:.3f} s", flush=True)

    # (d) the upload: pageable, as the engine does it; then one pinned
    # buffer, host copy included, then the pinned copies alone
    n_bytes = sum(codes.nbytes for codes in batches)
    synchronize(device)
    start = time.perf_counter()
    on_device = [torch.from_numpy(np.ascontiguousarray(codes)).to(device)
                 for codes in batches]
    synchronize(device)
    pageable_s = time.perf_counter() - start
    pinned_s = staged_s = None
    if device.type == "cuda":
        pinned_s, staged_s = _pinned_upload(batches, device)
        print(f"(d) upload of {n_bytes} bytes: pageable {pageable_s:.3f} s; "
              f"one pinned buffer, non_blocking: {pinned_s:.3f} s with the "
              f"host copy into it, {staged_s:.3f} s the copies alone",
              flush=True)
    else:
        print(f"(d) upload of {n_bytes} bytes: pageable {pageable_s:.3f} s "
              f"(to {device}: no copy); pinned: not measured (no card)",
              flush=True)

    # (e) encode + insert + flush over the batches on the device
    for fn in KERNELS.values():
        fn.launches = 0
    synchronize(device)
    start = time.perf_counter()
    store = SortedKmerStore(k, device)
    n_kmers = None
    for i, codes in enumerate(on_device):
        kmers, valid = encoding.canonical_kmers(codes, k)
        batch_kmers = valid.sum()
        n_kmers = batch_kmers if n_kmers is None else n_kmers + batch_kmers
        store.insert_kmers(kmers.reshape(-1))
        on_device[i] = None
    store._flushed()
    synchronize(device)
    device_s = time.perf_counter() - start
    n_kmers = 0 if n_kmers is None else int(n_kmers)
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    print(f"(e) canonical_kmers + insert_kmers + flush on {device}: "
          f"{n_kmers} k-mers, {device_s:.3f} s; launches {launches}",
          flush=True)
    del store

    consumer_s = count_s + pageable_s + device_s
    setter = "producer (a)" if read_s >= consumer_s else "consumer (c + d + e)"
    inflate_s = None if inflated is None else inflated["inflate_s"]
    print(f"ingest wall set by the {setter}: producer (a) {read_s:.3f} s "
          f"(zlib's inflate alone (a') {inflate_s} s) vs consumer (c + d + "
          f"e) {consumer_s:.3f} s", flush=True)
    return {"reads": n_reads, "bases": n_bases, "valid_bases": valid_bases,
            "kmers": n_kmers, "bytes": n_bytes, "read_batch_s": read_s,
            "inflate": inflated,
            "prefetch_s": prefetch_s, "valid_count_s": count_s,
            "pageable_upload_s": pageable_s, "pinned_upload_s": pinned_s,
            "pinned_copies_s": staged_s, "device_count_s": device_s,
            "device_launches": launches, "consumer_s": consumer_s,
            "sets_the_wall": setter}


def _pinned_upload(batches, device) -> tuple[float, float]:
    """Seconds to upload ``batches`` through one pinned host buffer with
    ``non_blocking`` copies: each batch copied into the buffer, then up,
    the next copy into the buffer waiting for that upload; then the
    uploads of the buffer alone, as many and as large."""
    size = max(codes.nbytes for codes in batches)
    pinned = torch.empty(size, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(size, dtype=torch.uint8, device=device)
    stream = torch.cuda.current_stream(device)
    done = None
    synchronize(device)
    start = time.perf_counter()
    for codes in batches:
        if done is not None:
            done.synchronize()
        pinned[: codes.nbytes].copy_(
            torch.from_numpy(np.ascontiguousarray(codes).reshape(-1)))
        dst[: codes.nbytes].copy_(pinned[: codes.nbytes], non_blocking=True)
        done = stream.record_event()
    synchronize(device)
    with_copy = time.perf_counter() - start
    start = time.perf_counter()
    for codes in batches:
        dst[: codes.nbytes].copy_(pinned[: codes.nbytes], non_blocking=True)
    synchronize(device)
    return with_copy, time.perf_counter() - start


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--width", type=int, default=27)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--k", type=int, default=21)
    parser.add_argument("--fastq", default=None,
                        help="also time the CLI's host stages over this file")
    parser.add_argument("--max-reads", type=int, default=0,
                        help="with --fastq: the first N reads (0: all)")
    return parser


def run(args) -> dict:
    device = default_device()
    record = {"device": str(device),
              "card": card() if device.type == "cuda" else None,
              "width": args.width, "k": args.k, "iters": args.iters,
              "stages": drain_stages(args.width, args.k, args.iters, device)}
    if args.fastq:
        record["fastq"] = fastq_stages(args.fastq, args.max_reads, args.k,
                                       device)
    return record


def main(argv=None) -> int:
    record = run(build_parser().parse_args(argv))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
