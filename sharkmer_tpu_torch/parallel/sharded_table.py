"""Hash count table sharded by owner: ``ShardedKmerTable`` (``--backend
hash --n-shards S``, and every ``--load-table`` with ``--n-shards S``),
and ``make_ingest_step``, the fused sharded ingest step.

Torch port of ``sharkmer_tpu.parallel.sharded_table``. The JAX table
shards over a device mesh; here the ``S`` shards are one ``[S,
local_capacity]`` tensor of 16 B slots on one device (``kernels/hash``
layout), and the collectives become owner routing inside the kernels:

* **owner routing**: shard ``s`` holds the keys with ``owner(key, S) ==
  s``, the high bits of the SplitMix64 hash (``kernels/hash.owner``);
  the home slot inside a shard uses the low bits, so the two stay
  independent.
* **insert**: one ``hash_insert`` launch routes each entry of the batch
  to its owner's slots (JAX all-gathers the batch and masks it on every
  shard). Per-key totals equal the one-table insert's.
* **growth**: the JAX rule, global: when the occupancy (the shards'
  claim counters) plus the incoming entries would pass ``MAX_LOAD`` of
  all ``S * local`` slots, every shard doubles: one routed launch
  rehashes all of them (the owner does not depend on capacity).
* **queries**: a lookup is one routed ``hash_lookup`` launch (JAX masks
  by owner and sums the shards' answers); the histogram is one clipped
  bincount over every shard's counts (the JAX gather of u64 histograms
  exists only because a u64 all-reduce does not lower on a TPU); primer
  scans concatenate the shards' scans in shard order.

There is no device mesh: ``make_mesh`` gives the shard count that stands
in for one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.hash import (
    as_u32,
    hash_insert,
    hash_lookup,
    new_slots,
    slot_counts,
    slot_keys,
)
from ..ops.encoding import canonical_kmers
from ..ops.hashtable import MAX_LOAD, KmerTable, batch_amounts, batch_keys
from ..ops.histogram import histogram as _histogram
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
    slots: torch.Tensor  # int64 [S, local_capacity, 2], 16 B slots
    claims: torch.Tensor  # int64 [S]: each shard's occupied slots

    @staticmethod
    def create(k: int, n_shards: int, local_capacity: int = 1 << 18,
               device="cpu") -> "ShardedKmerTable":
        if local_capacity <= 0 or local_capacity & (local_capacity - 1):
            raise ValueError("local_capacity must be a power of two")
        device = torch.device(device)
        return ShardedKmerTable(
            k, new_slots((n_shards, local_capacity), device),
            torch.zeros(n_shards, dtype=torch.int64, device=device))

    @property
    def n_shards(self) -> int:
        return self.slots.shape[0]

    @property
    def local_capacity(self) -> int:
        return self.slots.shape[1]

    @property
    def device(self) -> torch.device:
        return self.slots.device

    @property
    def shards(self) -> list:
        """Each shard as a ``KmerTable`` on views of its slots and its
        claim counter (for reading: inserts go through this table)."""
        return [KmerTable(self.k, self.slots[s], self.claims[s : s + 1],
                          self.device) for s in range(self.n_shards)]

    # -- growth ------------------------------------------------------------------

    def _maybe_grow(self, incoming: int) -> None:
        """Double every shard while the global occupancy plus every
        incoming entry would pass MAX_LOAD of all slots (the incoming
        entries assumed evenly routed, as JAX assumes)."""
        n_unique = self.n_unique()
        while n_unique + incoming > MAX_LOAD * (self.n_shards
                                                * self.local_capacity):
            self._grow()

    def _grow(self) -> None:
        """Every shard to twice its capacity: one routed insert of all the
        old slots (each key lands in the shard it came from)."""
        slots = new_slots((self.n_shards, 2 * self.local_capacity),
                          self.device)
        claims = torch.zeros_like(self.claims)
        hash_insert(slots, claims, self.slots.view(-1, 2))
        self.slots, self.claims = slots, claims

    # -- ingest ------------------------------------------------------------------

    def insert_kmers(self, kmers, counts=None) -> "ShardedKmerTable":
        """Insert a flat batch of canonical k-mers (SENTINEL entries
        skipped), each adding 1 or its ``counts`` entry: one routed
        ``hash_insert``."""
        kmers = batch_keys(kmers, self.device)
        amounts = None if counts is None else batch_amounts(counts,
                                                            self.device)
        self._maybe_grow(kmers.shape[0])
        hash_insert(self.slots, self.claims, kmers, amounts)
        return self

    def ingest_codes(self, codes) -> "ShardedKmerTable":
        codes = torch.as_tensor(np.asarray(codes, np.uint8), device=self.device)
        kmers, _ = canonical_kmers(codes, self.k)
        return self.insert_kmers(kmers.reshape(-1))

    def merge_from(self, other: "ShardedKmerTable") -> "ShardedKmerTable":
        """Fold another table of the same k and shard count into this one.
        Both route by the same owner, so each of the other's slots lands in
        the same shard here: one routed insert of all its slots (the empty
        ones skipped)."""
        if other.k != self.k or other.n_shards != self.n_shards:
            raise ValueError("merge_from requires the same k and shard count")
        self._maybe_grow(other.n_unique())
        hash_insert(self.slots, self.claims, other.slots.view(-1, 2))
        return self

    # -- queries -----------------------------------------------------------------

    def lookup_directional(self, queries) -> np.ndarray:
        """Counts (uint32) of directional k-mers: one routed lookup, each
        canonical query answered by the shard that owns it."""
        out = hash_lookup(self.slots, batch_keys(queries, self.device),
                          self.k)
        return out.cpu().numpy().view(np.uint32)

    def histogram(self, histo_max: int) -> np.ndarray:
        """uint64 vector of length histo_max+2 over every shard."""
        return _histogram(as_u32(slot_counts(self.slots).reshape(-1)),
                          histo_max)

    def n_unique(self) -> int:
        """Occupied slots: the shards' claim counters, one read."""
        return int(self.claims.sum())

    def n_total(self) -> int:
        return int(as_u32(slot_counts(self.slots)).sum())

    def max_count(self) -> int:
        occupied = slot_keys(self.slots) != SENTINEL
        return int(torch.where(occupied, as_u32(slot_counts(self.slots)),
                               0).max())

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
        keys = slot_keys(self.slots).reshape(-1)
        counts = as_u32(slot_counts(self.slots).reshape(-1))
        keep = keys != SENTINEL
        if min_count > 1:
            keep &= counts >= min_count
        keys, order = torch.sort(keys[keep])
        counts = counts[keep][order]
        return keys_to_numpy(keys), counts.cpu().numpy().astype(np.uint32)

    def to_dict(self) -> dict[int, int]:
        keys, counts = self.to_sorted_arrays()
        return dict(zip(keys.tolist(), counts.tolist()))


def make_ingest_step(mesh: int, k: int, histo_max: int):
    """The fused sharded ingest step (the JAX ``make_ingest_step``):
    encode every shard's slice of the reads, insert the whole batch into
    the shards' slots in one routed ``hash_insert`` (JAX all-gathers the
    batch and each shard inserts the keys it owns), and the histogram
    summed over the shards.

    Returns step(slots, claims, codes) -> (slots, claims, histo) where
      slots/claims: a ``ShardedKmerTable``'s ``[S, local_capacity, 2]``
        slots and ``[S]`` claim counters (JAX's keys and counts), updated
        in place;
      codes: uint8 [S, reads_per_shard, width] (numpy or a tensor);
      histo: uint64 [histo_max+2] (numpy).
    As in JAX, the step does not grow the table: an entry that finds no
    slot raises (``hash_insert``: table full).
    """
    n_shards = int(mesh)

    def step(slots, claims, codes):
        if slots.dim() != 3 or slots.shape[0] != n_shards:
            raise ValueError(f"slots {tuple(slots.shape)} are not {n_shards} "
                             f"shards")
        codes = torch.as_tensor(np.asarray(codes, np.uint8),
                                device=slots.device)
        kmers, _ = canonical_kmers(codes.reshape(-1, codes.shape[-1]), k)
        hash_insert(slots, claims, kmers.reshape(-1))
        histo = _histogram(as_u32(slot_counts(slots).reshape(-1)), histo_max)
        return slots, claims, histo

    return step
