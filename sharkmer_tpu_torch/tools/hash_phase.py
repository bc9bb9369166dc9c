"""Run ``chip_smoke.py``'s phase 8 alone: the hash kernels against their
plain versions on one real ingest batch, timed, on the GPU.

Run from the root of a checkout that holds the synthetic FASTQ
(``chip_smoke.py`` makes it; its first 2^17 reads are the batch):

    python3 -m sharkmer_tpu_torch.tools.hash_phase [--variants]

It imports ``chip_smoke.py`` and the package from the current directory,
so two trees (two commits) are compared in one call by running this
file from each in turns: ``(cd <tree> && python3 <path of this file>)``.
The last line is ``RESULT <tree> <card> <JSON of every *ms field>``.

``--variants`` instead separates what holds the insert back, on the
same batch (median CUDA-event ms, each insert into a fresh 2^27-slot
table reset outside the timed span; each table held to the plain
insert's rows):

* the per-entry kernel (``shk_hash_insert``, launched directly: no
  wrapper, no overflow read) on the batch as the CLI gives it, sorted by
  home slot (address order), every key once with its count as its
  amount (no duplicate adds), and both; the batch again into the table
  that holds it (all hits);
* lookups of the batch and of its keys in address order in the full
  table (its sectors read, no atomic, no write);
* ``hash_insert`` (the wrapper, its overflow read included), fresh and
  all hits;
* the wrapper's overflow read (``int()`` of a device int after the
  kernel has ended) on its own.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time


def variants(torch, np, cs, card: str) -> dict:
    """The timed variants of ``--variants``; returns their ms."""
    from sharkmer_tpu_torch.kernels import hash as hk

    kmers, n_valid = cs.first_batch_kmers(torch, np)
    cap = cs.HASH_CAP
    lib = hk._lib()
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    valid = kmers[kmers != cs.INT64_MAX]
    keys, seen = torch.unique(valid, return_counts=True)
    amounts = seen.to(torch.int32)

    def by_home(k, a=None):
        order = torch.argsort(hk.mix64(k) & (cap - 1))
        return k[order].contiguous(), None if a is None else \
            a[order].contiguous()

    batches = {"batch": (kmers, None), "sorted by home": by_home(kmers),
               "each key once": (keys, amounts),
               "each key once, sorted by home": by_home(keys, amounts)}
    table = (hk.new_slots((cap,), "cuda"),
             torch.zeros(1, dtype=torch.int64, device="cuda"))
    plain = (hk.new_slots((cap,), "cuda"),
             torch.zeros(1, dtype=torch.int64, device="cuda"))
    hk.insert_plain(*plain, kmers)

    def reset():
        table[0][..., 0].fill_(cs.INT64_MAX)
        table[0][..., 1].zero_()
        table[1].zero_()

    def direct(k, a):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shk_hash_insert(
            table[0].data_ptr(), cap, 1, 0, 1, table[1].data_ptr(),
            k.data_ptr(), None if a is None else a.data_ptr(), None,
            k.numel(), hk.new_epoch(), flag.data_ptr(), stream)
        cs.require(rc == 0, f"shk_hash_insert: launch failed ({rc})")

    class Record(dict):
        """The variants' ms, each printed as it is taken."""

        def __setitem__(self, name, ms):
            super().__setitem__(name, ms)
            print(f"hash_insert variant: {name}: {ms:.4f} ms on {card}",
                  flush=True)

    record = Record()
    for name, (k, a) in batches.items():
        reset()
        direct(k, a)
        torch.cuda.synchronize()
        cs.same_rows(torch, "shk_hash_insert", table, plain, name)
        record[f"direct, {name}"] = cs.median_ms(
            torch, lambda: direct(k, a), 10, reset)
    reset()
    direct(kmers, None)
    record["direct, all hits"] = cs.median_ms(
        torch, lambda: direct(kmers, None), 10)
    record["hash_insert, batch"] = cs.median_ms(
        torch, lambda: hk.hash_insert(*table, kmers), 10, reset)
    reset()
    hk.hash_insert(*table, kmers)
    torch.cuda.synchronize()
    cs.same_rows(torch, "hash_insert", table, plain, "batch")
    record["hash_insert, all hits"] = cs.median_ms(
        torch, lambda: hk.hash_insert(*table, kmers), 10)
    # the table's sectors read alone: lookups of the same keys (no atomic,
    # no write), in the batch's order and in address order
    out = torch.empty(kmers.numel(), dtype=torch.int32, device="cuda")
    for name, (k, _) in (("batch", batches["batch"]),
                         ("each key once, sorted by home",
                          batches["each key once, sorted by home"])):
        def lookup(k=k):
            rc = lib.shk_hash_lookup(
                table[0].data_ptr(), None, cap, 1, k.data_ptr(), k.numel(),
                0, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            cs.require(rc == 0, f"shk_hash_lookup: launch failed ({rc})")

        record[f"lookup, {name}"] = cs.median_ms(torch, lookup, 10)
    # the overflow read alone, the kernel long done: its host round trip
    torch.cuda.synchronize()
    reads = []
    for _ in range(200):
        start = time.perf_counter()
        int(flag)
        reads.append((time.perf_counter() - start) * 1e3)
    record["overflow read"] = statistics.median(reads)
    print(f"hash_insert variants: the batch {n_valid} valid k-mers, "
          f"{keys.numel()} distinct", flush=True)
    return {"variants": dict(record)}


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from sharkmer_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("hash_phase: torch sees no CUDA device")
    build.build_all(["hash_table", "chase"])
    card = cs.card_line()
    if sys.argv[1:] == ["--variants"]:
        record = variants(torch, np, cs, card)
    else:
        record = cs.hash_phase(torch, np, card, cs.load_latency(torch))
    print("RESULT", os.getcwd(), card, json.dumps(
        {name: {k: v for k, v in r.items() if k.endswith("ms")
                or name == "variants"}
         for name, r in record.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
