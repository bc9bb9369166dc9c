"""Open-addressed canonical k-mer count table: the hash backend.

Torch port of ``sharkmer_tpu.ops.hashtable.KmerTable`` (``--backend
hash``): one device tensor of 16 B slots with linear probing, filled and
probed by the ``hash_insert`` and ``hash_lookup`` kernels
(``kernels/hash.py``, ``csrc/hash_table.cu``).

* ``slots``: int64 ``[capacity, 2]``. A slot holds the key (int64,
  ``ops/keys.py``; ``SENTINEL``, INT64_MAX, the device form of
  ``EMPTY``, for an empty slot) at byte 0, the bit pattern of the JAX
  table's uint32 count at byte 8 and a 4 B pad word (the kernel's
  epoch of the last batch that added; no reader takes it for part of a
  count): 16 B a slot, one sector access for a key and its count.
* ``keys`` and ``counts`` are views of the slots (int64 and int32, 16 B
  strides), so every reader sees the two arrays of the JAX table. An
  add is modulo 2^32, and the freeze is read once a key a batch, as the
  JAX table reads it: a batch adds its sum for a key to a count that
  was below ``SAT_THRESHOLD`` (0xE0000000) before the batch, and
  nothing to one at or above it. From 0xE0000000 - 2, a batch of five
  entries of the key gives 0xE0000003, and the next batch adds nothing
  (a freeze, not a clamp; ``kernels.hash.SAT_THRESHOLD``; the kernel's
  epoch in the pad word, ``kernels/hash.py``). Histograms, sums,
  compares and the numpy boundary widen the counts with ``&
  0xFFFFFFFF`` to int64 (``kernels.hash.as_u32``).
* ``claims``: int64 ``[1]``, the slots the inserts claimed: the
  occupancy, read by ``n_unique`` without a sweep of the table.
* ``lookup`` and ``lookup_directional`` run a wave of numpy queries
  through ``kernels.hash.LookupWaves`` (one foreign call, one launch on
  the calling thread's own stream, one synchronisation); ``fence``
  orders those streams after the table's writes.

Unlike the JAX class, the table updates in place (``insert_kmers``
returns ``self``; a grow replaces the tensors). The slot layout never
reaches an output: the host mirror, the checkpoint and every primer
consumer sort what they read, so the kernel's racing claims are exact
where it counts. Left out as TPU workarounds: the power-of-two padding
of ``lookup_directional`` and ``prefix_scan``'s fixed-size output with
its grow-and-retry (``torch.nonzero`` has no fixed size).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels.hash import (
    LookupWaves,
    WriteFence,
    as_u32,
    hash_insert,
    new_slots,
    slot_counts,
    slot_keys,
)
from .encoding import canonical_kmers, revcomp_kmer
from .histogram import histogram as _histogram
from .histogram import revcomp
from .keys import SENTINEL, keys_to_device, keys_to_numpy

SCAN_CHUNK = 1 << 24  # slots per step of a primer scan's sweep
MAX_LOAD = 0.70  # occupancy a grow keeps the table under (JAX's max_load)


def _member(sorted_set: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    if not sorted_set.numel():
        return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    idx = torch.searchsorted(sorted_set, values)
    idx = torch.clamp(idx, max=sorted_set.shape[0] - 1)
    return sorted_set[idx] == values


def batch_keys(kmers, device) -> torch.Tensor:
    """A flat int64 key batch on ``device``: numpy uint64 (through the
    key codec) or an int64 tensor."""
    if isinstance(kmers, torch.Tensor):
        if kmers.dtype != torch.int64:
            raise TypeError(f"keys must be int64, got {kmers.dtype}")
        return kmers.to(device).reshape(-1).contiguous()
    return keys_to_device(kmers, device)


def batch_amounts(counts, device) -> torch.Tensor:
    """u32 amounts as int32 bit patterns on ``device``: numpy (cast to
    uint32) or an int32 tensor of bit patterns."""
    if isinstance(counts, torch.Tensor):
        if counts.dtype != torch.int32:
            raise TypeError(f"counts must be int32, got {counts.dtype}")
        return counts.to(device).reshape(-1).contiguous()
    arr = np.ascontiguousarray(np.asarray(counts, np.uint32)).reshape(-1)
    return torch.from_numpy(arr.view(np.int32)).to(device)


@dataclass
class KmerTable:
    """The device-resident hash count table."""

    k: int
    slots: torch.Tensor  # int64 [capacity, 2]: key, u32 count + 4 B pad
    claims: torch.Tensor  # int64 [1]: occupied slots
    device: torch.device
    fence: WriteFence = field(init=False, repr=False, compare=False)
    _waves: LookupWaves | None = field(default=None, init=False,
                                       repr=False, compare=False)

    def __post_init__(self):
        # the slots arrive written on the current stream (a fill, a copy)
        self.fence = WriteFence([self.device])

    @staticmethod
    def create(k: int, capacity: int, device) -> "KmerTable":
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        device = torch.device(device)
        return KmerTable(k, new_slots((capacity,), device),
                         torch.zeros(1, dtype=torch.int64, device=device),
                         device)

    @property
    def capacity(self) -> int:
        return self.slots.shape[0]

    @property
    def keys(self) -> torch.Tensor:
        """int64 [capacity] keys, SENTINEL = empty (a view)."""
        return slot_keys(self.slots)

    @property
    def counts(self) -> torch.Tensor:
        """int32 [capacity] u32 count bit patterns (a view)."""
        return slot_counts(self.slots)

    # -- ingest --------------------------------------------------------------

    def insert_kmers(self, kmers, counts=None) -> "KmerTable":
        """Insert a flat batch of canonical k-mers (SENTINEL entries
        skipped), each adding 1 or its ``counts`` entry."""
        kmers = batch_keys(kmers, self.device)
        amounts = None if counts is None else batch_amounts(counts,
                                                            self.device)
        self._maybe_grow(kmers.shape[0])
        hash_insert(self.slots, self.claims, kmers, amounts)
        self.fence.written([self.device])
        return self

    def ingest_codes(self, codes) -> "KmerTable":
        """Encode a [n, width] uint8 code batch and insert its canonical
        k-mers."""
        codes = torch.as_tensor(np.asarray(codes, np.uint8), device=self.device)
        kmers, _ = canonical_kmers(codes, self.k)
        return self.insert_kmers(kmers.reshape(-1))

    def merge_from(self, other: "KmerTable") -> "KmerTable":
        """Fold another table's slots into this one (every slot counts as
        incoming, as in JAX): the insert kernel reads each source slot's
        key and count at once and skips the empty ones."""
        if other.k != self.k:
            raise ValueError("k mismatch in merge_from")
        self._maybe_grow(other.capacity)
        hash_insert(self.slots, self.claims, other.slots)
        self.fence.written([self.device])
        return self

    def _maybe_grow(self, incoming: int) -> None:
        """The JAX growth rule: double while the occupancy plus every
        incoming entry (sentinels too) would pass ``MAX_LOAD``."""
        n_unique = self.n_unique()
        while n_unique + incoming > MAX_LOAD * self.capacity:
            self._grow()

    def _grow(self) -> None:
        """Rehash into twice the capacity: the old slots feed the insert
        kernel."""
        slots = new_slots((2 * self.capacity,), self.device)
        claims = torch.zeros_like(self.claims)
        hash_insert(slots, claims, self.slots)
        self.slots, self.claims = slots, claims
        self.fence.written([self.device])

    # -- queries -------------------------------------------------------------

    def _wave(self, queries, k: int) -> np.ndarray:
        waves = self._waves
        if waves is None or waves.slots is not self.slots:
            waves = self._waves = LookupWaves(self.slots, self.device,
                                              self.fence)
        return waves(queries, k)

    def lookup(self, queries) -> np.ndarray:
        """Counts (uint32) of canonical queries, 0 when absent: one
        wave."""
        return self._wave(queries, 0)

    def lookup_directional(self, queries) -> np.ndarray:
        """Counts (uint32) of directional k-mers, canonicalized (min of
        the k-mer and its revcomp) in the kernel: one wave."""
        return self._wave(queries, self.k)

    def histogram(self, histo_max: int) -> np.ndarray:
        """uint64 vector of length histo_max+2 (Histogram::get_vector)."""
        return _histogram(as_u32(self.counts), histo_max)

    def n_unique(self) -> int:
        """Occupied slots: the inserts' claim counter, one number read."""
        return int(self.claims.sum())

    def n_total(self) -> int:
        return int(as_u32(self.counts).sum())

    def max_count(self) -> int:
        occupied = self.keys != SENTINEL
        return int(torch.where(occupied, as_u32(self.counts), 0).max())

    def prefix_scan(self, oligos, oligo_len: int, min_count: int):
        """All table k-mers whose start matches an oligo (either strand),
        with count >= ``min_count``, as numpy (kmers, counts): a forward
        hit has the oligo as its high 2L bits; a reverse hit, taken only
        where the forward test missed, has an oligo's revcomp as its low
        2L bits and is reported as its revcomp, so the primer sits at
        the k-mer start. In slot order."""
        if oligo_len <= 0 or oligo_len >= self.k:
            raise ValueError(
                f"oligo length {oligo_len} out of range for k={self.k}"
            )
        oligos = np.asarray(oligos, dtype=np.uint64)
        fwd = keys_to_device(np.sort(oligos), self.device)
        rc = keys_to_device(np.array(
            sorted({revcomp_kmer(int(o), oligo_len) for o in oligos}),
            dtype=np.uint64), self.device)
        hit = torch.empty(self.capacity, dtype=torch.bool, device=self.device)
        is_rc = torch.empty_like(hit)
        # the masks in sweeps of SCAN_CHUNK slots: the gene threads scan
        # concurrently, and whole-table int64 temporaries would take
        # several GB a scan; one nonzero at the end, one device sync
        for lo in range(0, self.capacity, SCAN_CHUNK):
            keys = self.keys[lo : lo + SCAN_CHUNK]
            counts = as_u32(self.counts[lo : lo + SCAN_CHUNK])
            occupied = (keys != SENTINEL) & (counts >= min_count)
            fwd_hit = occupied & _member(fwd, keys >> 2 * (self.k - oligo_len))
            low = keys & ((1 << 2 * oligo_len) - 1)
            rc_hit = occupied & ~fwd_hit & _member(rc, low)
            hit[lo : lo + SCAN_CHUNK] = fwd_hit | rc_hit
            is_rc[lo : lo + SCAN_CHUNK] = rc_hit
        idx = torch.nonzero(hit).reshape(-1)
        kmers = self.keys[idx]
        # revcomp only the hits, not the whole table
        kmers = torch.where(is_rc[idx], revcomp(kmers, self.k), kmers)
        counts = as_u32(self.counts[idx])
        return keys_to_numpy(kmers), counts.cpu().numpy().astype(np.uint32)

    # -- host export ---------------------------------------------------------

    def to_sorted_arrays(
        self, min_count: int = 1
    ) -> tuple[np.ndarray, np.ndarray]:
        """Host mirror: (sorted unique kmers uint64, counts uint32),
        restricted to rows with count >= ``min_count`` when it is above
        1 (as the JAX table: at 1 every occupied slot is kept), filtered
        and sorted on the device."""
        keep = self.keys != SENTINEL
        counts = as_u32(self.counts)
        if min_count > 1:
            keep &= counts >= min_count
        keys, order = torch.sort(self.keys[keep])
        counts = counts[keep][order]
        return keys_to_numpy(keys), counts.cpu().numpy().astype(np.uint32)

    def to_dict(self) -> dict[int, int]:
        keys, counts = self.to_sorted_arrays()
        return dict(zip(keys.tolist(), counts.tolist()))
