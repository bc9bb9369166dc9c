"""The sPCR data plane of ``ShardedSortedStore``: the reach closure and
the primer scans over owner shards.

Torch port of ``sharkmer_tpu.parallel.sharded_reach``:

* **index** (``ShardedSpcrIndex``): each shard's bucket LUT sidecar
  (``ops/reach.build_sidecar``) and revcomp-sorted scan index
  (``ops/scan.rc_index``), built on the shard's device. The JAX
  count-packed probe plane is a Mosaic layout the port does not use.
* **reach**: the JAX package's ``sharded_reach`` runs the closure loop
  replicated on every shard, each shard probing the candidates against
  its own LUT and a ``pmin`` over the shards combining the row ids at
  every level (``sharkmer_tpu/parallel/sharded_reach.py:176-186``). On
  shards placed on several cards that is a cross-card collective at
  each of up to 2049 levels of every closure. The port instead makes
  the shards the partitions of one owner-routed ``PartTable``
  (``ShardedSpcrIndex.table``) whose launching device is the store's
  first device, so the closure is ``ops/reach.reach``, as for the
  single store: one ``reach_closure`` launch an attempt (and the warm
  start's ``probe_rows``) sends each candidate to the shard that owns
  it, and a shard on another card costs one peer load over NVLink per
  remote probe inside that launch, with no collective. Global row id =
  ``shard * local_capacity + row``, as in JAX. Ascending ids are not
  ascending keys, so the rows come back sorted by key after the gather
  (``_drive_closure``), as JAX sorts the combined rows.
* **primer scans** (``sharded_range_scan``): ``ops/scan.range_scan_part``
  on each shard, on its device, concatenated on the host in shard order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.probe import PartTable
from ..ops import reach as reach_mod
from ..ops.keys import SENTINEL
from ..ops.scan import range_scan_part, rc_index


class ShardedSpcrIndex:
    """Per-shard sidecars of one flushed ``ShardedSortedStore`` state:
    ``table``, the owner-routed ``PartTable`` of the shards' masters;
    ``rc_indexes``, each shard's (rc_sorted, rc_order); ``occupancy``,
    each shard's key count."""

    def __init__(self, store):
        cap = store.local_capacity
        # each shard's sidecar and rc index on its device (the sidecar
        # aliases the shard's master)
        self.table = PartTable(
            [reach_mod.build_sidecar(keys, counts, store.k)
             for keys, counts in zip(store.kmers, store.counts)],
            [s * cap for s in range(store.n_shards)], by_owner=True,
            device=store.device)
        self.rc_indexes = [rc_index(keys, store.k) for keys in store.kmers]
        self.occupancy = torch.stack([
            (keys != SENTINEL).sum().to(store.device)
            for keys in store.kmers]).tolist()


def sharded_range_scan(store, index: ShardedSpcrIndex, oligos: np.ndarray,
                       oligo_len: int, max_out: int = 1 << 12):
    """Every shard's primer matches (``range_scan_part``: forward
    precedence per row, reverse-strand hits reported as revcomp), as
    numpy (kmers u64, counts u32) concatenated in shard order. Count
    filtering is the caller's."""
    k = store.k
    if oligo_len <= 0 or oligo_len >= k:
        raise ValueError(
            f"oligo length {oligo_len} out of range for k={k}"
        )
    found = [
        range_scan_part(keys, counts, rc_sorted, rc_order, n, oligos,
                        oligo_len, k, max_out=max_out)
        for keys, counts, (rc_sorted, rc_order), n in zip(
            store.kmers, store.counts, index.rc_indexes, index.occupancy)
    ]
    return (np.concatenate([f[0] for f in found]),
            np.concatenate([f[1] for f in found]))
