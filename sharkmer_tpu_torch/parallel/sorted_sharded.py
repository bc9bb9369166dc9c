"""Sorted-run count store sharded by owner: ``ShardedSortedStore``
(``--backend sorted --n-shards S``), and ``make_sorted_ingest_step``, the
fused sharded ingest step on the sorted backend.

Torch port of ``sharkmer_tpu.parallel.sorted_sharded``. The keyspace is
split by the high bits of the SplitMix64 hash (``kernels/hash.owner``);
each of the ``S`` shards keeps one sorted master run of the keys it owns
(``kmers[s]``/``counts[s]``, ``[local_capacity]`` each, sentinel tail) on
its device: shard ``s`` on ``devices[s * D // S]`` of a list of D <= S
devices (``device.shard_devices``; JAX places one shard a device):

* **insert**: the batch is grouped by owner on its device (one stable
  sort of the owners, one host read of the group sizes), and each
  shard's keys are copied to the shard's device and aggregated there
  (``ops/sorted_store._aggregate``: sort, the ``run_starts`` kernel,
  segmented sums) into a pending run. JAX masks the whole batch for
  every shard and slices the result to a fixed width, with a
  ``RuntimeError`` when one shard's share overflows it: static shapes
  that the port does not need, so its runs have the width of their keys
  and it never raises on skew.
* **flush**: when the pending runs' width reaches ``max(2^14, local //
  2)`` (the JAX trigger, counted on the JAX widths), each shard
  aggregates its master with its pending runs on its device; while a
  shard holds ``local_capacity`` keys or more, every master doubles
  (the JAX grow).
* **merge_from**: the other store's masters become pending runs of this
  one, shard by shard (each copied to the shard's device), then a flush:
  both stores share the owner route.
* **queries**: lookups run each shard's binary search on its device and
  sum the answers on ``devices[0]`` (a key lives in one shard), the
  histogram is one clipped bincount a device, summed, and the sPCR data
  plane (``sharded_reach.py``) runs the reach closure over the shards as
  one owner-routed table launched on ``devices[0]`` and the primer scans
  shard by shard, each on its device.

Bit-identical to the single store by construction: the same aggregation
arithmetic, and ownership only partitions the keyspace.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import device_list, shard_groups
from ..kernels.hash import owner
from ..ops import reach as reach_mod
from ..ops.encoding import canonical_kmers
from ..ops.histogram import histogram_across
from ..ops.histogram import revcomp
from ..ops.keys import (
    SENTINEL,
    counts_to_device,
    counts_to_numpy,
    keys_to_device,
    keys_to_numpy,
)
from ..ops.sorted_store import (
    _aggregate,
    _lookup_part,
    _next_pow2,
    packed_count_bits,
)
from ..utils import phases
from .sharded_reach import ShardedSpcrIndex, sharded_range_scan


def _by_owner(kmers, counts, n_shards: int) -> list:
    """The batch grouped by owner shard (SENTINEL entries dropped): one
    stable sort of the owners and one host read of the group sizes; each
    shard's (keys, counts) in batch order."""
    own = torch.where(kmers != SENTINEL, owner(kmers, n_shards), n_shards)
    order = torch.sort(own, stable=True).indices
    # bincount reads the owners' min and max, then the sizes are read
    with phases.sync("route.sizes", calls=3):
        sizes = torch.bincount(own, minlength=n_shards + 1)[:n_shards].tolist()
    kmers, counts = kmers[order], counts[order]
    groups, pos = [], 0
    for size in sizes:
        groups.append((kmers[pos : pos + size], counts[pos : pos + size]))
        pos += size
    return groups


@dataclass
class ShardedSortedStore:
    k: int
    devices: list  # D torch devices; shard s on devices[s * D // S]
    kmers: list  # S int64 [cap] masters, each sorted, sentinel tail
    counts: list  # S int64 [cap], each beside its master
    # one entry a batch or merge: S (keys, counts) runs, sorted, compact,
    # each on its shard's device
    pending: list = field(default_factory=list)
    pending_width: int = 0  # the JAX widths of the pending runs
    # (masters, ShardedSpcrIndex) for reach and the primer scans
    _spcr_cache: tuple | None = None

    @staticmethod
    def create(k: int, n_shards: int, local_capacity: int = 1 << 14,
               devices=("cpu",)) -> "ShardedSortedStore":
        """An empty store; its shards on ``devices`` (a list: shard ``s``
        on ``devices[s * D // S]``)."""
        cap = _next_pow2(local_capacity)
        devices = device_list(devices)
        shard_groups(n_shards, len(devices))  # D <= S
        homes = [devices[s * len(devices) // n_shards]
                 for s in range(n_shards)]
        return ShardedSortedStore(
            k, devices,
            [torch.full((cap,), SENTINEL, dtype=torch.int64, device=dev)
             for dev in homes],
            [torch.zeros(cap, dtype=torch.int64, device=dev) for dev in homes],
        )

    @property
    def n_shards(self) -> int:
        return len(self.kmers)

    @property
    def local_capacity(self) -> int:
        return self.kmers[0].shape[0]

    @property
    def device(self) -> torch.device:
        """The device that takes the batches and queries and launches the
        closures over every shard: the first of the list."""
        return self.devices[0]

    def shard_device(self, s: int) -> torch.device:
        return self.devices[s * len(self.devices) // self.n_shards]

    # -- insert ----------------------------------------------------------------

    def insert_kmers(self, kmers, counts=None) -> "ShardedSortedStore":
        """Add k-mers (int64 tensors or numpy uint64; SENTINEL entries
        skipped), each counting 1 or its ``counts`` entry, as one pending
        run a shard."""
        if isinstance(kmers, torch.Tensor):
            if kmers.dtype != torch.int64:
                raise TypeError(f"keys must be int64, got {kmers.dtype}")
            kmers = kmers.to(self.device).reshape(-1)
        else:
            kmers = keys_to_device(kmers, self.device)
        if counts is None:
            counts = torch.ones_like(kmers)
        elif isinstance(counts, torch.Tensor):
            counts = counts.to(self.device, torch.int64).reshape(-1)
        else:
            counts = counts_to_device(counts, self.device)
        S = self.n_shards
        per = max(64, -(-kmers.shape[0] // S))
        self.pending.append(self._owned_runs(kmers, counts))
        self.pending_width += min(S * per, _next_pow2(4 * per))
        if self.pending_width >= max(1 << 14, self.local_capacity // 2):
            self.flush()
        return self

    def _owned_runs(self, kmers, counts) -> list:
        """Each shard's aggregated run of the keys it owns, on its
        device."""
        runs = []
        for s, (uk, uc) in enumerate(_by_owner(kmers, counts, self.n_shards)):
            dev = self.shard_device(s)
            uk, uc = uk.to(dev), uc.to(dev)
            if uk.numel():
                uk, uc, nu = _aggregate(uk, uc, packed_count_bits(self.k))
                uk, uc = uk[:nu], uc[:nu]
            runs.append((uk, uc))
        return runs

    def ingest_codes(self, codes) -> "ShardedSortedStore":
        codes = torch.as_tensor(np.asarray(codes, np.uint8), device=self.device)
        kmers = canonical_kmers(codes, self.k)
        return self.insert_kmers(kmers.reshape(-1))

    def merge_from(self, other: "ShardedSortedStore") -> "ShardedSortedStore":
        """Fold another store of the same k and shard count into this one:
        its masters are valid pending runs of this store's shards."""
        if other.k != self.k or other.n_shards != self.n_shards:
            raise ValueError("merge_from requires the same k and shard count")
        other.flush()
        self.pending.append([(mk.to(self.shard_device(s)),
                              mc.to(self.shard_device(s)))
                             for s, (mk, mc) in enumerate(zip(other.kmers,
                                                              other.counts))])
        self.pending_width += other.local_capacity
        return self.flush()

    # -- flush / grow ----------------------------------------------------------

    def flush(self) -> "ShardedSortedStore":
        """Aggregate each shard's master with its pending runs; double
        every master (JAX's grow-and-retry) until the fullest shard's keys
        stay below the capacity."""
        if not self.pending:
            return self
        merged = []
        for s in range(self.n_shards):
            mk, mc, nu = _aggregate(
                torch.cat([self.kmers[s], *(runs[s][0] for runs in self.pending)]),
                torch.cat([self.counts[s], *(runs[s][1] for runs in self.pending)]),
                packed_count_bits(self.k),
            )
            merged.append((mk[:nu], mc[:nu]))
        cap = self.local_capacity
        while max(mk.shape[0] for mk, _ in merged) >= cap:
            cap *= 2
        kmers, counts = [], []
        for mk, mc in merged:
            kmers.append(torch.full((cap,), SENTINEL, dtype=torch.int64,
                                    device=mk.device))
            counts.append(torch.zeros(cap, dtype=torch.int64,
                                      device=mk.device))
            kmers[-1][: mk.shape[0]] = mk
            counts[-1][: mc.shape[0]] = mc
        self.kmers, self.counts = kmers, counts
        self.pending = []
        self.pending_width = 0
        return self

    # -- queries ---------------------------------------------------------------

    def lookup_directional(self, queries) -> np.ndarray:
        """Counts (uint32) of directional k-mers, looked up canonically in
        every shard on its device (a key lives in its owner's only), the
        answers summed on ``device``."""
        s = self.flush()
        q = keys_to_device(queries, s.device)
        if q.shape[0] == 0:
            return np.zeros(0, np.uint32)
        canon = torch.minimum(q, revcomp(q, s.k))
        out = torch.zeros_like(canon)
        for keys, counts in zip(s.kmers, s.counts):
            out += _lookup_part(keys, counts, s.local_capacity,
                                canon.to(keys.device)).to(s.device)
        return counts_to_numpy(out)

    def histogram(self, histo_max: int) -> np.ndarray:
        """A clipped bincount of each device's shards, summed."""
        return histogram_across(self.flush().counts, histo_max)

    def _gather(self, per_shard) -> torch.Tensor:
        """``per_shard(keys, counts)`` of every shard, on ``device``."""
        s = self.flush()
        return torch.stack([per_shard(k, c).to(s.device)
                            for k, c in zip(s.kmers, s.counts)])

    def n_unique(self) -> int:
        with phases.sync("claims.read"):
            return int(self._gather(
                lambda k, c: (k != SENTINEL).sum()).sum())

    def n_total(self) -> int:
        with phases.sync("counts.sum"):
            return int(self._gather(lambda k, c: c.sum()).sum())

    def max_count(self) -> int:
        with phases.sync("counts.max"):
            return int(self._gather(lambda k, c: c.max()).max())

    # -- sPCR support: reach closure and primer range scans ----------------------

    def _spcr_index(self):
        """Per-shard sidecars (``sharded_reach.ShardedSpcrIndex``), rebuilt
        whenever a flush replaces the masters."""
        s = self.flush()
        if s._spcr_cache is not None and s._spcr_cache[0] is s.kmers:
            return s._spcr_cache[1]
        index = ShardedSpcrIndex(s)
        s._spcr_cache = (s.kmers, index)
        return index

    def prepare_spcr(self) -> None:
        """Build the sPCR shard sidecars up front (otherwise the first
        scan or closure does)."""
        self._spcr_index()

    def reach(self, roots, min_count: int, depth: int | None = None,
              pre=None):
        """Depth-capped de Bruijn closure over every shard: one
        owner-routed closure over the index's ``PartTable`` (the single
        store's ``ops/reach.reach``). Returns a ``ReachResult``, or None
        on overflow."""
        s = self.flush()
        return reach_mod.reach(s._spcr_index().table, roots, min_count, s.k,
                               depth=depth or reach_mod.DEPTH, pre=pre)

    def prefix_scan(self, oligos, oligo_len: int, min_count: int,
                    max_out: int = 1 << 12):
        """Table k-mers starting with an oligo on either strand, with
        count >= ``min_count`` (forward precedence, reverse-strand hits
        reported as revcomp), shard by shard."""
        s = self.flush()
        kmers, counts = sharded_range_scan(
            s, s._spcr_index(), np.asarray(oligos, dtype=np.uint64),
            oligo_len, max_out=max_out,
        )
        keep = counts >= np.uint32(max(min_count, 1))
        return kmers[keep], counts[keep]

    def prefix_scan_many(self, requests, max_out: int = 1 << 12):
        """One ``sharded_range_scan`` a request: [(kmers, counts)] with no
        count filter (the JAX package's ``prefix_scan`` filters by
        ``min_count``; its ``prefix_scan_many`` does not)."""
        s = self.flush()
        index = s._spcr_index()
        return [
            sharded_range_scan(s, index, np.asarray(oligos, dtype=np.uint64),
                               olen, max_out=max_out)
            for oligos, olen in requests
        ]

    # -- host export -------------------------------------------------------------

    def to_sorted_arrays(
        self, min_count: int = 1
    ) -> tuple[np.ndarray, np.ndarray]:
        """(sorted unique kmers uint64, counts uint32) over every shard,
        restricted to count >= ``min_count`` when it is above 1."""
        s = self.flush()
        keys, counts = [], []
        for mk, mc in zip(s.kmers, s.counts):
            keep = mk != SENTINEL
            if min_count > 1:
                keep &= mc >= min_count
            keys.append(mk[keep].to(s.device))
            counts.append(mc[keep].to(s.device))
        keys, order = torch.sort(torch.cat(keys))
        return keys_to_numpy(keys), counts_to_numpy(torch.cat(counts)[order])

    def to_dict(self) -> dict[int, int]:
        keys, counts = self.to_sorted_arrays()
        return dict(zip(keys.tolist(), counts.tolist()))


def make_sorted_ingest_step(devices, k: int, histo_max: int, cap: int):
    """The fused sharded ingest step on the sorted backend (the JAX
    ``make_sorted_ingest_step``) on the shards of ``devices`` (the mesh:
    ``device.shard_devices``): encode each shard's slice of the reads on
    its device, copy the whole batch to every device (JAX all-gathers
    it), route each k-mer to its owner shard there (``_by_owner``; JAX
    masks the batch on every shard), aggregate each shard's master run
    with its new k-mers on its device (``_aggregate``, on the
    ``run_starts`` kernel), cut the result at ``cap`` (JAX's
    ``lax.slice``: the largest keys past ``cap`` are dropped), and the
    histogram summed over the shards.

    Returns step(kmers, counts, codes) -> (kmers, counts, histo) where
      kmers/counts: S int64 [cap] tensors each, each sorted with a
        sentinel tail, shard s on ``devices[s * D // S]`` (a
        ``ShardedSortedStore``'s masters);
      codes: uint8 [S, reads_per_shard, width] (numpy or a tensor);
      histo: uint64 [histo_max+2] (numpy).
    """
    devices = device_list(devices)

    def step(kmers, counts, codes):
        codes = np.asarray(codes, np.uint8)
        n_shards = codes.shape[0]
        groups = shard_groups(n_shards, len(devices))
        homes = [devices[s * len(devices) // n_shards]
                 for s in range(n_shards)]
        if len(kmers) != n_shards or any(
                tuple(mk.shape) != (cap,) or mk.device != dev
                for mk, dev in zip(kmers, homes)):
            raise ValueError(f"masters {[tuple(m.shape) for m in kmers]} are "
                             f"not {n_shards} shards of {cap} on {devices}")
        shard_kmers = []
        for s, dev in enumerate(homes):
            km = canonical_kmers(torch.as_tensor(codes[s], device=dev), k)
            shard_kmers.append(km.reshape(-1))
        out_k, out_c = [], []
        for (lo, hi), dev in zip(groups, devices):
            batch = torch.cat([km.to(dev) for km in shard_kmers])
            owned = _by_owner(batch, torch.ones_like(batch), n_shards)
            for s in range(lo, hi):
                mine, ones = owned[s]
                mk, mc, _ = _aggregate(torch.cat([kmers[s], mine]),
                                       torch.cat([counts[s], ones]),
                                       packed_count_bits(k))
                out_k.append(mk[:cap].contiguous())
                out_c.append(mc[:cap].contiguous())
        return out_k, out_c, histogram_across(out_c, histo_max)

    return step
