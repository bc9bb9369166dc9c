"""Sorted-run count store sharded by owner: ``ShardedSortedStore``
(``--backend sorted --n-shards S``).

Torch port of ``sharkmer_tpu.parallel.sorted_sharded``. The keyspace is
split by the high bits of the SplitMix64 hash (``kernels/hash.owner``);
each of the ``S`` shards keeps one sorted master run of the keys it owns
(``kmers``/``counts`` ``[S, local_capacity]``, sentinel tail), all on the
engine's one device:

* **insert**: the batch is grouped by owner (one stable sort of the
  owners, one host read of the group sizes), and each shard aggregates
  its own keys (``ops/sorted_store._aggregate``: sort, the ``run_starts``
  kernel, segmented sums) into a pending run. JAX masks the whole
  batch for every shard and slices the result to a fixed width, with a
  ``RuntimeError`` when one shard's share overflows it: static shapes
  that the port does not need, so its runs have the width of their keys
  and it never raises on skew.
* **flush**: when the pending runs' width reaches ``max(2^14, local //
  2)`` (the JAX trigger, counted on the JAX widths), each shard
  aggregates its master with its pending runs; while a shard holds
  ``local_capacity`` keys or more, every master doubles (the JAX grow).
* **merge_from**: the other store's masters become pending runs of this
  one, shard by shard, then a flush: both stores share the owner route.
* **queries**: lookups sum the shards' binary searches (a key lives in
  one shard), the histogram is one clipped bincount over every shard,
  and the sPCR data plane (``sharded_reach.py``) runs the reach closure
  over the shards as one owner-routed table and the primer scans shard
  by shard.

Bit-identical to the single store by construction: the same aggregation
arithmetic, and ownership only partitions the keyspace. Left out:
``make_sorted_ingest_step`` (the JAX fused ingest step, no CLI caller).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels.hash import owner
from ..ops import reach as reach_mod
from ..ops.encoding import canonical_kmers
from ..ops.histogram import histogram as _histogram
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
from .sharded_reach import ShardedSpcrIndex, sharded_range_scan


@dataclass
class ShardedSortedStore:
    k: int
    kmers: torch.Tensor  # int64 [S, cap], each row sorted, sentinel tail
    counts: torch.Tensor  # int64 [S, cap]
    # one entry a batch or merge: S (keys, counts) runs, sorted, compact
    pending: list = field(default_factory=list)
    pending_width: int = 0  # the JAX widths of the pending runs
    # (masters, ShardedSpcrIndex) for reach and the primer scans
    _spcr_cache: tuple | None = None

    @staticmethod
    def create(k: int, n_shards: int, local_capacity: int = 1 << 14,
               device="cpu") -> "ShardedSortedStore":
        cap = _next_pow2(local_capacity)
        device = torch.device(device)
        return ShardedSortedStore(
            k,
            torch.full((n_shards, cap), SENTINEL, dtype=torch.int64,
                       device=device),
            torch.zeros((n_shards, cap), dtype=torch.int64, device=device),
        )

    @property
    def n_shards(self) -> int:
        return self.kmers.shape[0]

    @property
    def local_capacity(self) -> int:
        return self.kmers.shape[1]

    @property
    def device(self) -> torch.device:
        return self.kmers.device

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
        """Each shard's aggregated run of the keys it owns."""
        S = self.n_shards
        own = torch.where(kmers != SENTINEL, owner(kmers, S), S)
        order = torch.sort(own, stable=True).indices
        sizes = torch.bincount(own, minlength=S + 1)[:S].tolist()
        kmers, counts = kmers[order], counts[order]
        runs, pos = [], 0
        for size in sizes:
            if size:
                uk, uc, nu = _aggregate(kmers[pos : pos + size],
                                        counts[pos : pos + size],
                                        packed_count_bits(self.k))
                uk, uc = uk[:nu], uc[:nu]
            else:
                uk, uc = kmers[:0], counts[:0]
            runs.append((uk, uc))
            pos += size
        return runs

    def ingest_codes(self, codes) -> "ShardedSortedStore":
        codes = torch.as_tensor(np.asarray(codes, np.uint8), device=self.device)
        kmers, _ = canonical_kmers(codes, self.k)
        return self.insert_kmers(kmers.reshape(-1))

    def merge_from(self, other: "ShardedSortedStore") -> "ShardedSortedStore":
        """Fold another store of the same k and shard count into this one:
        its masters are valid pending runs of this store's shards."""
        if other.k != self.k or other.n_shards != self.n_shards:
            raise ValueError("merge_from requires the same k and shard count")
        other.flush()
        self.pending.append(list(zip(other.kmers, other.counts)))
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
        kmers = torch.full((self.n_shards, cap), SENTINEL, dtype=torch.int64,
                           device=self.device)
        counts = torch.zeros((self.n_shards, cap), dtype=torch.int64,
                             device=self.device)
        for s, (mk, mc) in enumerate(merged):
            kmers[s, : mk.shape[0]] = mk
            counts[s, : mc.shape[0]] = mc
        self.kmers, self.counts = kmers, counts
        self.pending = []
        self.pending_width = 0
        return self

    # -- queries ---------------------------------------------------------------

    def lookup_directional(self, queries) -> np.ndarray:
        """Counts (uint32) of directional k-mers, looked up canonically in
        every shard (a key lives in its owner's only)."""
        s = self.flush()
        q = keys_to_device(queries, s.device)
        if q.shape[0] == 0:
            return np.zeros(0, np.uint32)
        canon = torch.minimum(q, revcomp(q, s.k))
        out = torch.zeros_like(canon)
        for keys, counts in zip(s.kmers, s.counts):
            out += _lookup_part(keys, counts, s.local_capacity, canon)
        return counts_to_numpy(out)

    def histogram(self, histo_max: int) -> np.ndarray:
        return _histogram(self.flush().counts.reshape(-1), histo_max)

    def n_unique(self) -> int:
        return int((self.flush().kmers != SENTINEL).sum())

    def n_total(self) -> int:
        return int(self.flush().counts.sum())

    def max_count(self) -> int:
        return int(self.flush().counts.max())

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
        keys, counts = s.kmers.reshape(-1), s.counts.reshape(-1)
        keep = keys != SENTINEL
        if min_count > 1:
            keep &= counts >= min_count
        keys, order = torch.sort(keys[keep])
        return keys_to_numpy(keys), counts_to_numpy(counts[keep][order])

    def to_dict(self) -> dict[int, int]:
        keys, counts = self.to_sorted_arrays()
        return dict(zip(keys.tolist(), counts.tolist()))
