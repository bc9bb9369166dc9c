"""Count-table checkpointing (``--save-table`` / ``--load-table``).

Port of ``sharkmer_tpu.io.checkpoint`` with the same ``.npz`` format, so
a table saved by either package loads into either backend of either
package:

* ``keys``: the sorted unique k-mers (uint64), ``counts``: their counts
  (uint32), both from the table's ``to_sorted_arrays()``;
* ``meta``: JSON with ``format_version`` 1, ``k``, ``backend`` (the
  table's class name, the same in both packages) and ``stats`` (the
  engine's ``IngestStats`` fields).

Loading re-inserts the rows into a fresh table on ``device`` in slabs
of 2^22, so the target's backend, capacity and shard count are free to
differ from the saved one's. As in the JAX package, ``n_shards > 1``
loads into a ``ShardedKmerTable`` whatever ``backend`` says, its shards
on ``devices`` (by default ``device.shard_devices``). A sharded table
saves its rows gathered from every device in one sorted array.
"""

from __future__ import annotations

import json
import logging

import numpy as np

from ..device import shard_devices
from ..ops.encoding import KMER_SENTINEL
from ..ops.hashtable import KmerTable
from ..ops.sorted_store import SortedKmerStore
from ..parallel.sharded_table import ShardedKmerTable

log = logging.getLogger("sharkmer")

FORMAT_VERSION = 1
SLAB = 1 << 22  # rows per re-insert, to bound peak memory


def save_table(path: str, table, stats=None) -> None:
    """Save a count backend (hash or sorted) to .npz."""
    keys, counts = table.to_sorted_arrays()
    meta = {
        "format_version": FORMAT_VERSION,
        "k": table.k,
        "backend": type(table).__name__,
    }
    if stats is not None:
        meta["stats"] = stats.__dict__
    np.savez_compressed(
        path, keys=keys, counts=counts, meta=json.dumps(meta)
    )
    occ = int((keys != np.uint64(KMER_SENTINEL)).sum())
    log.info("Saved count table to %s (%d unique kmers)", path, occ)


def load_table(path: str, device, n_shards: int = 1,
               capacity: int | None = None, backend: str = "sorted",
               devices=None):
    """Load a checkpoint into a fresh table of ``backend`` on ``device``
    (with ``n_shards > 1``, its shards on ``devices``).

    Returns (table, stats_dict | None).
    """
    with np.load(path, allow_pickle=False) as data:
        keys = data["keys"]
        counts = data["counts"]
        meta = json.loads(str(data["meta"]))
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"Unsupported table checkpoint version: {meta.get('format_version')}"
        )
    k = int(meta["k"])
    occ = keys != np.uint64(KMER_SENTINEL)
    kmers = keys[occ]
    kcounts = counts[occ].astype(np.uint32)

    if capacity is None:
        capacity = max(1 << 14, 1 << int(len(kmers) / 0.6).bit_length())

    if n_shards > 1:
        local = 1 << max(10, (capacity // n_shards - 1).bit_length())
        table = ShardedKmerTable.create(
            k, n_shards, local,
            devices=devices or shard_devices(n_shards, device))
    elif backend == "hash":
        table = KmerTable.create(k, capacity, device)
    else:
        table = SortedKmerStore(k, device)
    for i in range(0, len(kmers), SLAB):
        table = table.insert_kmers(kmers[i : i + SLAB], kcounts[i : i + SLAB])

    log.info(
        "Loaded count table from %s (%d unique kmers, k=%d)",
        path, len(kmers), k,
    )
    return table, meta.get("stats")
