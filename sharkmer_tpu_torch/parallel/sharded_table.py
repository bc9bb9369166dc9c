"""Hash count table sharded by owner: ``ShardedKmerTable`` (``--backend
hash --n-shards S``, and every ``--load-table`` with ``--n-shards S``).

Torch port of ``sharkmer_tpu.parallel.sharded_table``. The JAX table
shards over a device mesh; here the ``S`` shards are ``S`` hash tables
(``ops/hashtable.KmerTable``) on one device, and the collectives become
a loop over the shards:

* **owner routing**: shard ``s`` holds the keys with ``_owner(key, S) ==
  s``, the high bits of the SplitMix64 hash (``kernels/hash.owner``);
  the home slot inside a shard uses the low bits, so the two stay
  independent.
* **insert**: each shard runs one ``hash_insert`` launch on the whole
  batch with the keys it does not own masked to ``SENTINEL`` (the JAX
  gather and mask). Per-key totals equal the one-table insert's.
* **growth**: the JAX rule, global: when the occupancy plus the incoming
  entries would pass ``MAX_LOAD`` of all ``S * local`` slots, every
  shard doubles and rehashes locally (the owner does not depend on
  capacity).
* **queries**: lookups canonicalize, mask by owner and sum the shards'
  ``hash_lookup`` answers; the histogram is the sum of the shards'
  clipped bincounts (the JAX gather of u64 histograms exists only
  because a u64 all-reduce does not lower on a TPU); primer scans
  concatenate the shards' scans in shard order.

There is no device mesh: ``make_mesh`` gives the shard count that stands
in for one. Left out: ``make_ingest_step``, the JAX package's fused
ingest step, which the CLI never calls.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.hash import as_u32, hash_insert, hash_lookup
from ..kernels.hash import owner as _owner
from ..ops.encoding import canonical_kmers
from ..ops.hashtable import MAX_LOAD, KmerTable
from ..ops.histogram import revcomp
from ..ops.keys import SENTINEL, keys_to_numpy


def make_mesh(n_devices: int | None = None) -> int:
    """The JAX package's mesh of ``n_devices`` devices, as the port sees
    it: its shards are logical, all on one device, so a mesh is its shard
    count (one when not given). ``create(k, make_mesh(S))`` reads as in
    the JAX package."""
    return 1 if n_devices is None else int(n_devices)


@dataclass
class ShardedKmerTable:
    """``S`` owner shards of one hash count table, updated in place (each
    method that JAX makes return a new table returns ``self``)."""

    k: int
    shards: list  # KmerTable per shard, all of one capacity

    @staticmethod
    def create(k: int, n_shards: int, local_capacity: int = 1 << 18,
               device="cpu") -> "ShardedKmerTable":
        if local_capacity <= 0 or local_capacity & (local_capacity - 1):
            raise ValueError("local_capacity must be a power of two")
        return ShardedKmerTable(k, [KmerTable.create(k, local_capacity, device)
                                    for _ in range(n_shards)])

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def local_capacity(self) -> int:
        return self.shards[0].capacity

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    # -- growth ------------------------------------------------------------------

    def _maybe_grow(self, incoming: int) -> None:
        """Double every shard while the global occupancy plus every
        incoming entry would pass MAX_LOAD of all slots (the incoming
        entries assumed evenly routed, as JAX assumes)."""
        n_unique = self.n_unique()
        while n_unique + incoming > MAX_LOAD * (self.n_shards
                                                * self.local_capacity):
            for shard in self.shards:
                shard._grow()

    # -- ingest ------------------------------------------------------------------

    def insert_kmers(self, kmers, counts=None) -> "ShardedKmerTable":
        """Insert a flat batch of canonical k-mers (SENTINEL entries
        skipped), each adding 1 or its ``counts`` entry: one
        ``hash_insert`` a shard, on the keys it owns."""
        first = self.shards[0]
        kmers = first._keys(kmers)
        amounts = None if counts is None else first._amounts(counts)
        self._maybe_grow(kmers.shape[0])
        own = _owner(kmers, self.n_shards)
        for s, shard in enumerate(self.shards):
            mine = torch.where(own == s, kmers, SENTINEL)
            hash_insert(shard.keys, shard.counts, mine, amounts)
        return self

    def ingest_codes(self, codes) -> "ShardedKmerTable":
        codes = torch.as_tensor(np.asarray(codes, np.uint8), device=self.device)
        kmers, _ = canonical_kmers(codes, self.k)
        return self.insert_kmers(kmers.reshape(-1))

    def merge_from(self, other: "ShardedKmerTable") -> "ShardedKmerTable":
        """Fold another table of the same k and shard count into this one.
        Both route by the same owner, so the merge is shard-local: each
        shard inserts the other's slots (its empty slots skipped)."""
        if other.k != self.k or other.n_shards != self.n_shards:
            raise ValueError("merge_from requires the same k and shard count")
        self._maybe_grow(other.n_unique())
        for mine, theirs in zip(self.shards, other.shards):
            hash_insert(mine.keys, mine.counts, theirs.keys, theirs.counts)
        return self

    # -- queries -----------------------------------------------------------------

    def lookup_directional(self, queries) -> np.ndarray:
        """Counts (uint32) of directional k-mers: each canonical query is
        answered by the shard that owns it."""
        q = self.shards[0]._keys(queries)
        canon = torch.minimum(q, revcomp(q, self.k))
        own = _owner(canon, self.n_shards)
        out = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
        for s, shard in enumerate(self.shards):
            mine = torch.where(own == s, canon, SENTINEL)
            out += as_u32(hash_lookup(shard.keys, shard.counts, mine))
        return out.cpu().numpy().astype(np.uint32)

    def histogram(self, histo_max: int) -> np.ndarray:
        """uint64 vector of length histo_max+2: the shards' sum."""
        return np.sum([shard.histogram(histo_max) for shard in self.shards],
                      axis=0, dtype=np.uint64)

    def n_unique(self) -> int:
        return sum(shard.n_unique() for shard in self.shards)

    def n_total(self) -> int:
        return sum(shard.n_total() for shard in self.shards)

    def max_count(self) -> int:
        return max(shard.max_count() for shard in self.shards)

    def prefix_scan(self, oligos, oligo_len: int, min_count: int):
        """``KmerTable.prefix_scan`` of every shard, concatenated in shard
        order (each shard's hits in slot order)."""
        found = [shard.prefix_scan(oligos, oligo_len, min_count)
                 for shard in self.shards]
        return (np.concatenate([f[0] for f in found]),
                np.concatenate([f[1] for f in found]))

    # -- host export -------------------------------------------------------------

    def to_sorted_arrays(
        self, min_count: int = 1
    ) -> tuple[np.ndarray, np.ndarray]:
        """(sorted unique kmers uint64, counts uint32) over every shard,
        restricted to count >= ``min_count`` when it is above 1, filtered
        and sorted on the device."""
        keys = torch.cat([shard.keys for shard in self.shards])
        counts = torch.cat([as_u32(shard.counts) for shard in self.shards])
        keep = keys != SENTINEL
        if min_count > 1:
            keep &= counts >= min_count
        keys, order = torch.sort(keys[keep])
        counts = counts[keep][order]
        return keys_to_numpy(keys), counts.cpu().numpy().astype(np.uint32)

    def to_dict(self) -> dict[int, int]:
        keys, counts = self.to_sorted_arrays()
        return dict(zip(keys.tolist(), counts.tolist()))
