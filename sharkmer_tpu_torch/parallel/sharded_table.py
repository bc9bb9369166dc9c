"""Hash count table sharded by owner: ``ShardedKmerTable`` (``--backend
hash --n-shards S``, and every ``--load-table`` with ``--n-shards S``),
and ``make_ingest_step``, the fused sharded ingest step.

Torch port of ``sharkmer_tpu.parallel.sharded_table``. The JAX table
shards over a mesh of devices, one shard a device. Here the ``S`` shards
live on a list of D <= S devices (``device.shard_devices``, repeats
allowed): shard ``s`` on ``devices[s * D // S]``, so each device holds
one group of contiguous shards ``[lo_d, hi_d)``, one ``[n_d,
local_capacity, 2]`` tensor of 16 B slots (``kernels/hash`` layout) and
one ``[n_d]`` tensor of claim counters. The collectives become owner
routing inside the kernels:

* **owner routing**: shard ``s`` holds the keys with ``owner(key, S) ==
  s``, the high bits of the SplitMix64 hash (``kernels/hash.owner``);
  the home slot inside a shard uses the low bits, so the two stay
  independent.
* **insert**: the batch is copied once to each group's device (the JAX
  all-gather), and one ``hash_insert`` launch a group routes each entry
  of its window to its owner's slots and skips the rest (JAX masks the
  batch on every shard). Writes stay on their owner's device. Per-key
  totals equal the one-table insert's.
* **growth**: the JAX rule, global: when the occupancy (every group's
  claim counters, gathered in one host read) plus the incoming entries
  would pass ``MAX_LOAD`` of all ``S * local`` slots, every shard
  doubles: one launch a group rehashes its own old slots (the owner does
  not depend on capacity, so no key changes group).
* **queries**: a lookup is one wave (``kernels.hash.LookupWaves``: one
  ``hash_lookup`` launch on ``devices[0]``, on the calling thread's
  stream, ordered after the groups' writes by ``fence``) that reads each
  shard through a pointer table, wherever it lives (on one group, from
  the group's tensor, without the pointer table; JAX masks by owner and
  sums the shards' answers); the histogram is one
  clipped bincount a group, summed (the JAX gather of u64 histograms
  exists only because a u64 all-reduce does not lower on a TPU); primer
  scans concatenate the shards' scans in shard order.

On one device (D = 1) the table is one group: one ``[S, local, 2]``
tensor and one launch an insert.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import device_list, shard_groups
from ..kernels.hash import (
    LookupWaves,
    WriteFence,
    as_u32,
    hash_insert,
    new_slots,
    slot_counts,
    slot_keys,
)
from ..ops.encoding import canonical_kmers
from ..ops.hashtable import MAX_LOAD, KmerTable, batch_amounts, batch_keys
from ..ops.histogram import histogram_across
from ..ops.keys import SENTINEL, keys_to_numpy
from ..utils import phases


@dataclass
class ShardedKmerTable:
    """``S`` owner shards of one hash count table in D device groups,
    updated in place (each method that JAX makes return a new table
    returns ``self``)."""

    k: int
    devices: list  # D torch devices, group d on devices[d]
    group_slots: list  # int64 [n_d, local_capacity, 2] a group, 16 B slots
    group_claims: list  # int64 [n_d] a group: each shard's occupied slots
    fence: WriteFence = field(init=False, repr=False, compare=False)
    _waves: LookupWaves | None = field(default=None, init=False,
                                       repr=False, compare=False)

    def __post_init__(self):
        # the slots arrive written on their devices' current streams
        self.fence = WriteFence(self.devices)

    @staticmethod
    def create(k: int, n_shards: int, local_capacity: int = 1 << 18,
               devices=("cpu",)) -> "ShardedKmerTable":
        """An empty table; its shards on ``devices`` (a list: shard ``s``
        on ``devices[s * D // S]``)."""
        if local_capacity <= 0 or local_capacity & (local_capacity - 1):
            raise ValueError("local_capacity must be a power of two")
        devices = device_list(devices)
        groups = shard_groups(n_shards, len(devices))
        return ShardedKmerTable(
            k, devices,
            [new_slots((hi - lo, local_capacity), dev)
             for (lo, hi), dev in zip(groups, devices)],
            [torch.zeros(hi - lo, dtype=torch.int64, device=dev)
             for (lo, hi), dev in zip(groups, devices)])

    @property
    def n_shards(self) -> int:
        return sum(g.shape[0] for g in self.group_slots)

    @property
    def local_capacity(self) -> int:
        return self.group_slots[0].shape[1]

    @property
    def device(self) -> torch.device:
        """The device that takes the batches, queries and launches that
        read every shard: the first of the list."""
        return self.devices[0]

    @property
    def groups(self) -> list[tuple[int, int]]:
        """Each group's shard range ``[lo, hi)``."""
        return shard_groups(self.n_shards, len(self.devices))

    @property
    def shards(self) -> list:
        """Each shard as a ``KmerTable`` on views of its slots and its
        claim counter, on its device (for reading: inserts go through this
        table)."""
        return [KmerTable(self.k, slots[j], claims[j : j + 1], dev)
                for slots, claims, dev in zip(self.group_slots,
                                              self.group_claims, self.devices)
                for j in range(slots.shape[0])]

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
        """Every shard to twice its capacity: one insert a group of its
        own old slots (each key lands in the shard it came from)."""
        with phases.span("store.grow"):
            cap = 2 * self.local_capacity
            slots = [new_slots((old.shape[0], cap), old.device)
                     for old in self.group_slots]
            claims = [torch.zeros_like(c) for c in self.group_claims]
            self._each_group(slots, claims, self.group_slots)
            self.group_slots, self.group_claims = slots, claims
            self.fence.written(self.devices)

    def _each_group(self, slots, claims, sources, amounts=None) -> None:
        """One windowed ``hash_insert`` a group: ``sources[d]`` (a batch
        of keys, or slots) into group d on its device."""
        n_shards = self.n_shards
        for (lo, _), g_slots, g_claims, src in zip(self.groups, slots, claims,
                                                   sources):
            src = src.view(-1, 2) if src.dim() == 3 else src
            hash_insert(g_slots, g_claims, src,
                        None if amounts is None else amounts.to(src.device),
                        shard_lo=lo, n_shards=n_shards)

    # -- ingest ------------------------------------------------------------------

    def insert_kmers(self, kmers, counts=None) -> "ShardedKmerTable":
        """Insert a flat batch of canonical k-mers (SENTINEL entries
        skipped), each adding 1 or its ``counts`` entry: the batch on
        every group's device, one windowed ``hash_insert`` a group."""
        kmers = batch_keys(kmers, self.device)
        amounts = None if counts is None else batch_amounts(counts,
                                                            self.device)
        self._maybe_grow(kmers.shape[0])
        self._each_group(self.group_slots, self.group_claims,
                         [kmers.to(dev) for dev in self.devices], amounts)
        self.fence.written(self.devices)
        return self

    def ingest_codes(self, codes) -> "ShardedKmerTable":
        codes = torch.as_tensor(np.asarray(codes, np.uint8), device=self.device)
        kmers = canonical_kmers(codes, self.k)
        return self.insert_kmers(kmers.reshape(-1))

    def merge_from(self, other: "ShardedKmerTable") -> "ShardedKmerTable":
        """Fold another table of the same k and shard count into this one.
        Both route by the same owner, so each of the other's slots lands in
        the same shard here: a group takes the other's groups that overlap
        its window, on its device (one launch a group when both tables
        share the device list)."""
        if other.k != self.k or other.n_shards != self.n_shards:
            raise ValueError("merge_from requires the same k and shard count")
        self._maybe_grow(other.n_unique())
        for d, (lo, hi) in enumerate(self.groups):
            for (o_lo, o_hi), src in zip(other.groups, other.group_slots):
                if o_lo < hi and lo < o_hi:
                    hash_insert(self.group_slots[d], self.group_claims[d],
                                src.to(self.devices[d]).view(-1, 2),
                                shard_lo=lo, n_shards=self.n_shards)
        self.fence.written(self.devices)
        return self

    # -- queries -----------------------------------------------------------------

    def lookup_directional(self, queries) -> np.ndarray:
        """Counts (uint32) of directional k-mers: one wave on
        ``device``, each canonical query answered by the shard that owns
        it: in the one group's ``[S, cap, 2]`` tensor, or, over several
        groups, through the shards' pointer table."""
        slots = (self.group_slots[0] if len(self.group_slots) == 1
                 else self.group_slots)
        waves = self._waves
        if waves is None or waves.slots is not slots:
            waves = self._waves = LookupWaves(slots, self.device, self.fence)
        return waves(queries, self.k)

    def histogram(self, histo_max: int) -> np.ndarray:
        """uint64 vector of length histo_max+2 over every shard: a
        clipped bincount a group, summed."""
        return histogram_across([as_u32(slot_counts(g))
                                 for g in self.group_slots], histo_max)

    def _gather(self, per_group) -> torch.Tensor:
        """``per_group(slots, claims)`` of each group, on ``device``."""
        return torch.stack([per_group(s, c).to(self.device) for s, c in
                            zip(self.group_slots, self.group_claims)])

    def n_unique(self) -> int:
        """Occupied slots: every group's claim counters, one host read."""
        with phases.sync("claims.read"):
            return int(self._gather(lambda s, c: c.sum()).sum())

    def n_total(self) -> int:
        with phases.sync("counts.sum"):
            return int(self._gather(
                lambda s, c: as_u32(slot_counts(s)).sum()).sum())

    def max_count(self) -> int:
        def group_max(slots, _claims):
            occupied = slot_keys(slots) != SENTINEL
            return torch.where(occupied, as_u32(slot_counts(slots)), 0).max()
        with phases.sync("counts.max"):
            return int(self._gather(group_max).max())

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
        restricted to count >= ``min_count`` when it is above 1: each
        group filtered on its device, the groups' rows sorted on
        ``device``."""
        keys, counts = [], []
        for slots in self.group_slots:
            g_keys = slot_keys(slots).reshape(-1)
            g_counts = as_u32(slot_counts(slots).reshape(-1))
            keep = g_keys != SENTINEL
            if min_count > 1:
                keep &= g_counts >= min_count
            keys.append(g_keys[keep].to(self.device))
            counts.append(g_counts[keep].to(self.device))
        keys, order = torch.sort(torch.cat(keys))
        counts = torch.cat(counts)[order]
        return keys_to_numpy(keys), counts.cpu().numpy().astype(np.uint32)

    def to_dict(self) -> dict[int, int]:
        keys, counts = self.to_sorted_arrays()
        return dict(zip(keys.tolist(), counts.tolist()))


def make_ingest_step(devices, k: int, histo_max: int):
    """The fused sharded ingest step (the JAX ``make_ingest_step``) on
    the shard groups of ``devices`` (the mesh: ``device.shard_devices``):
    encode each shard's slice of the reads on its device, copy the whole
    batch to every group's device (JAX all-gathers it), one windowed
    ``hash_insert`` a group (each shard takes the keys it owns), and the
    histogram summed over the groups.

    Returns step(slots, claims, codes) -> (slots, claims, histo) where
      slots/claims: a ``ShardedKmerTable``'s ``group_slots`` and
        ``group_claims`` on ``devices`` (JAX's keys and counts), updated
        in place;
      codes: uint8 [S, reads_per_shard, width] (numpy or a tensor);
      histo: uint64 [histo_max+2] (numpy).
    As in JAX, the step does not grow the table: an entry that finds no
    slot raises (``hash_insert``: table full).
    """
    devices = device_list(devices)

    def step(slots, claims, codes):
        codes = np.asarray(codes, np.uint8)
        n_shards = codes.shape[0]
        groups = shard_groups(n_shards, len(devices))
        if len(slots) != len(devices) or any(
                s.device != dev or s.shape[0] != hi - lo
                for s, dev, (lo, hi) in zip(slots, devices, groups)):
            raise ValueError(f"slots {[tuple(s.shape) for s in slots]} are "
                             f"not {n_shards} shards on {devices}")
        shard_kmers = []
        for s in range(n_shards):
            dev = devices[s * len(devices) // n_shards]
            kmers = canonical_kmers(torch.as_tensor(codes[s], device=dev), k)
            shard_kmers.append(kmers.reshape(-1))
        for (lo, _), g_slots, g_claims, dev in zip(groups, slots, claims,
                                                   devices):
            batch = torch.cat([km.to(dev) for km in shard_kmers])
            hash_insert(g_slots, g_claims, batch, shard_lo=lo,
                        n_shards=n_shards)
        histo = histogram_across([as_u32(slot_counts(g)) for g in slots],
                                 histo_max)
        return slots, claims, histo

    return step
