"""Sorted-run k-mer count store (torch port of ``sharkmer_tpu.ops.sorted_store``).

The count path is built from sorts and scans, as in the JAX package:

* **raw buffer**: canonical k-mers are appended, tile by tile, into a
  preallocated device buffer of ``max_agg`` keys. No sort, no sync.
* **drain**: when the buffer fills (or a query needs the counts) it is
  sorted and run-length encoded. The first drain into an empty store
  is *ghosted*: keys stay the full sorted array and each run's total
  sits at its first row, 0 on its duplicates ("ghost rows"), from the
  ``run_ends`` kernel. Every later drain compacts after the
  ``run_starts`` kernel (run totals at run ends). On the card, at the
  JAX package's v2 widths, that is drain v2: a row-wise packed sort of
  ``[R, ROW_W]`` rows, ghost padding of each row to a multiple of
  ``GHOST_Q``, and the ``stitch_rows`` kernel. Elsewhere (the CPU, small
  widths) one packed (or key/count) sort moves the survivors to the
  front (drain v1).
* **staged run and partitioned master**: drained runs merge pairwise
  into a staged run; the staged run folds into the master, a list of
  disjoint key-range partitions, each a sorted sentinel-padded run of
  at most ``max_agg // 2`` keys, which split in half when they
  outgrow it. Merges are concatenate + sort + segmented sum, with
  exact u32 saturation.
* **queries**: histogram, totals, binary-search lookups, primer scans,
  the sPCR ``reach`` closure (``ops/reach.py``, on per-partition bucket
  LUTs and the ``reach_closure`` kernel) and the filtered host export, per
  partition.

Keys and counts are int64 tensors on ``device`` (``ops/keys.py``).
Ghost rows (count 0, duplicating the live row before them) are
invisible to every query: searchsorted-left lands on the live row, the
histogram drops bin 0, scans and exports drop count-0 rows, merges
collapse them, and the sPCR index de-ghosts the partitions before it
builds the LUTs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels.probe import PartTable
from ..kernels.run_scan import run_ends, run_starts
from ..kernels.stitch import stitch_rows
from ..utils import phases
from . import reach as reach_mod
from .encoding import canonical_kmers
from .histogram import histogram as _histogram
from .histogram import revcomp
from .keys import (
    BIAS,
    COUNT_MAX,
    SENTINEL,
    counts_to_device,
    counts_to_numpy,
    keys_to_device,
    keys_to_numpy,
    pack,
    unpack,
)
from .scan import panel_scan, range_scan_part, rc_index

# Raw-buffer append granularity (elements): an append fills whole
# tiles, the tail of the last one with sentinels.
TILE = 1 << 18

# Drain v2 row geometry (the JAX package's): the compaction sorts
# [R, ROW_W] rows, pads each row's survivors with zero-count ghosts of
# its last key to a multiple of GHOST_Q, and stitches the rows. The
# ghosts are invisible to every query and cost at most R * GHOST_Q / 2
# slots; keeping them makes the drain's output equal the JAX v2 drain's
# element for element.
ROW_W = 1 << 16
GHOST_Q = 1024
# Widths the JAX package drains with v2 are multiples of its Pallas
# run-scan tile (256 x 512 elements).
_V2_TILE = 1 << 17


def _default_max_agg(device) -> int:
    """Largest element count one drain or merge sorts. It is also the
    raw-buffer width, so it sets the drain cadence and the peak batch
    memory. ``SHARKMER_MAX_AGG`` overrides it."""
    env = os.environ.get("SHARKMER_MAX_AGG")
    if env:
        return int(env)
    return (1 << 27) if torch.device(device).type == "cuda" else (1 << 22)


def _next_pow2(n: int) -> int:
    """Power-of-two element width, floored at 64."""
    return 1 << max(6, (int(n) - 1).bit_length())


def packed_count_bits(k: int) -> int:
    """Spare low bits of a k-mer key for packed single-key sorts (0 =
    unusable)."""
    bits = 64 - 2 * k
    return bits if bits >= 20 else 0


def _sentinels(n: int, device) -> torch.Tensor:
    return torch.full((n,), SENTINEL, dtype=torch.int64, device=device)


def _first_last(sk: torch.Tensor):
    """Run-first and run-last markers of a sorted key array."""
    n = sk.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=sk.device)
    first[1:] = sk[1:] != sk[:-1]
    last = torch.ones(n, dtype=torch.bool, device=sk.device)
    last[:-1] = sk[:-1] != sk[1:]
    return first, last


def _sort_kv(keys: torch.Tensor, counts: torch.Tensor):
    sk, order = torch.sort(keys)
    return sk, counts[order]


def _compact(sk, totals, keep, count_bits: int):
    """Kept rows' (key, total) to the front in key order, sentinels
    behind: one packed single-key sort when every kept key and total
    fits ``count_bits`` (checked on the data), else a key/count sort."""
    if count_bits >= 20:
        cap = (1 << count_bits) - 1
        key_cap = (1 << (64 - count_bits)) - 1
        zero = torch.zeros_like(sk)
        fits = (torch.where(keep, totals, zero).max() < cap) & (
            torch.where(keep, sk, zero).max() < key_cap)
        with phases.sync("compact.fits"):
            fits = bool(fits)
        if fits:
            words = torch.sort(pack(sk, totals, count_bits, keep)).values
            return unpack(words, count_bits)
    out_k = torch.where(keep, sk, torch.full_like(sk, SENTINEL))
    out_c = torch.where(keep, totals, torch.zeros_like(totals))
    return _sort_kv(out_k, out_c)


def _aggregate(kmers, counts, count_bits: int = 0):
    """Sort (kmers, counts); sum the counts of equal keys (saturating at
    the u32 maximum); compact the unique keys, still sorted, to the
    front with sentinels behind. Returns (keys, totals, n_unique) at
    the input's width (``_aggregate_impl``; each ``lax.cond`` there is
    a host ``if`` here, and its cummax over run-start values the
    one-pass ``run_starts`` kernel, each key's lower bound, plus a
    gather)."""
    occupied = kmers != SENTINEL
    sk = None
    if count_bits >= 20:
        cap = (1 << count_bits) - 1
        key_cap = (1 << (64 - count_bits)) - 1
        fits = (counts.max() < cap) & (
            torch.where(occupied, kmers, torch.zeros_like(kmers)).max()
            < key_cap)
        with phases.sync("aggregate.fits"):
            fits = bool(fits)
        if fits:
            words = torch.sort(pack(kmers, counts, count_bits, occupied)).values
            sk, sc = unpack(words, count_bits)
    if sk is None:
        sk, sc = _sort_kv(kmers, counts)
    _first, last = _first_last(sk)
    incl = torch.cumsum(sc, 0)  # inclusive prefix of counts (no overflow)
    excl = incl - sc
    # prefix total just before each run's start, carried down the run:
    # the JAX package's cummax over run-start values, which is exactly
    # excl at the run start since excl never decreases
    run_base = excl[run_starts(sk).to(torch.int64)]
    run_total = torch.clamp(incl - run_base, max=COUNT_MAX)
    keep = last & (sk != SENTINEL)
    with phases.sync("aggregate.n_unique"):
        n_unique = int(keep.sum())
    out_k, out_c = _compact(sk, run_total, keep, count_bits)
    return out_k, out_c, n_unique


def _aggregate_ingest(kmers, count_bits: int):
    """Compacting drain of a raw k-mer buffer (every count implicitly
    1): sort, run starts from the ``run_starts`` kernel, run totals
    ``pos - run_start + 1`` at run ends, then the compaction sort
    (``_aggregate_ingest_impl`` with ``use_pallas=True``). Returns
    (keys, totals, n_unique)."""
    n = kmers.shape[0]
    sk = torch.sort(kmers).values  # sentinels sort to the end
    _first, last = _first_last(sk)
    pos = torch.arange(n, dtype=torch.int32, device=sk.device)
    run_total = (pos - run_starts(sk) + 1).to(torch.int64)
    keep = last & (sk != SENTINEL)
    with phases.sync("drain.n_unique"):
        n_unique = int(keep.sum())
    out_k, out_c = _compact(sk, run_total, keep, count_bits)
    return out_k, out_c, n_unique


def _aggregate_ingest_v2(kmers, count_bits: int):
    """Drain v2 (``_aggregate_ingest_v2_impl``): the drain of
    ``_aggregate_ingest`` with a row-wise compaction and ghost padding.
    ``kmers``' width is a multiple of ROW_W and ``count_bits >= 20``.

    Returns (keys, counts, n_padded, n_real): the occupied prefix is
    ``n_padded`` rows, live rows followed by their zero-count ghosts,
    of which ``n_real`` carry counts. A run total that does not fit the
    packed count field (one key filling ``2^count_bits`` buffer slots)
    takes the exact key/count compaction instead, without ghosts (the
    JAX ``lax.cond`` is a host ``if`` on one scalar here)."""
    n = kmers.shape[0]
    sk = torch.sort(kmers).values
    _first, last = _first_last(sk)
    pos = torch.arange(n, dtype=torch.int32, device=sk.device)
    run_total = (pos - run_starts(sk) + 1).to(torch.int64)
    keep = last & (sk != SENTINEL)
    cap = (1 << count_bits) - 1
    with phases.sync("drain.max"):
        most = int(torch.where(keep, run_total, 0).max())
    if most >= cap:
        out_k, out_c = _compact(sk, run_total, keep, 0)
        with phases.sync("drain.n_unique"):
            n_unique = int(keep.sum())
        return out_k, out_c, n_unique, n_unique
    # biased packed words sort signed in the unsigned word order; rows
    # not kept are the biased all-ones sentinel (INT64_MAX), last
    words = pack(sk, run_total, count_bits, keep)
    del sk, run_total, keep
    rows = torch.sort(words.view(-1, ROW_W), dim=1).values
    del words
    cnt = (rows != SENTINEL).sum(dim=1, dtype=torch.int32)
    cntq = (cnt + (GHOST_Q - 1)) & ~(GHOST_Q - 1)
    last_live = rows.gather(
        1, torch.clamp(cnt - 1, min=0).to(torch.int64)[:, None])[:, 0]
    # the ghost is the row's last key with count 0: the JAX package's
    # (last_live >> cb) << cb on the unbiased word, biased again
    ghost = (((last_live ^ BIAS) >> count_bits) << count_bits) ^ BIAS
    posw = torch.arange(ROW_W, dtype=torch.int32, device=rows.device)[None, :]
    rows = torch.where((posw >= cnt[:, None]) & (posw < cntq[:, None]),
                       ghost[:, None], rows)
    offs = (torch.cumsum(cntq, 0, dtype=torch.int32) - cntq).contiguous()
    flat = stitch_rows(rows, offs, SENTINEL)
    del rows
    out_k, out_c = unpack(flat, count_bits)
    with phases.sync("drain.sizes"):
        n_padded, n_real = torch.stack([cntq.sum(), cnt.sum()]).tolist()
    return out_k, out_c, n_padded, n_real


def _drain_v2_wanted(width: int, count_bits: int, device) -> bool:
    """The JAX package's drain-v2 rule, on the card only: a width of
    whole run-scan tiles and whole rows, and a packable k."""
    return (torch.device(device).type == "cuda" and width % _V2_TILE == 0
            and count_bits >= 20 and width >= ROW_W and width % ROW_W == 0)


def _aggregate_ingest_ghosted(kmers):
    """Fresh drain into an empty store: a sorted ghosted run, no
    compaction (``_aggregate_ingest_ghosted_impl``). Keys stay the full
    sorted array; each run's total (``run_end - pos + 1``, from the
    ``run_ends`` kernel) sits at its first row, 0 on the rest.

    Returns (keys, counts, n_padded, n_real): occupied rows including
    ghosts, and distinct keys."""
    n = kmers.shape[0]
    sk = torch.sort(kmers).values
    pos = torch.arange(n, dtype=torch.int32, device=sk.device)
    first, _last = _first_last(sk)
    total = (run_ends(sk) - pos + 1).to(torch.int64)
    occupied = sk != SENTINEL
    live = first & occupied
    counts = torch.where(live, total, torch.zeros_like(total))
    with phases.sync("drain.sizes"):
        n_padded, n_real = torch.stack([occupied.sum(), live.sum()]).tolist()
    return sk, counts, n_padded, n_real


def _pad_to(keys, counts, width: int):
    """(keys, counts) cut or sentinel/zero-padded to exactly ``width``."""
    have = keys.shape[0]
    if have >= width:
        return keys[:width], counts[:width]
    return (
        torch.cat([keys, _sentinels(width - have, keys.device)]),
        torch.cat([counts, counts.new_zeros(width - have)]),
    )


def _slice_run(keys, counts, start: int, size: int, out_width: int):
    """Rows [start, start+size) as a new run padded to ``out_width``."""
    out_k = _sentinels(out_width, keys.device)
    out_c = counts.new_zeros(out_width)
    out_k[:size] = keys[start : start + size]
    out_c[:size] = counts[start : start + size]
    return out_k, out_c


def _lookup_part(kmers, counts, n: int, queries):
    """Binary-search lookups against one sorted partition."""
    idx = torch.searchsorted(kmers, queries)
    idx = torch.clamp(idx, max=kmers.shape[0] - 1)
    hit = (kmers[idx] == queries) & (idx < n) & (queries != SENTINEL)
    return torch.where(hit, counts[idx], torch.zeros_like(queries))


def _filter_compact(keys, counts, min_count: int):
    """Rows with count >= ``min_count`` kept in order at the front,
    sentinels behind, same width. Returns (keys, counts, n_kept)."""
    keep = counts >= max(min_count, 1)  # empty and ghost rows count 0
    with phases.sync("filter.mask", calls=2):
        kk, kc = keys[keep], counts[keep]
    n = kk.shape[0]
    out_k, out_c = _slice_run(kk, kc, 0, n, keys.shape[0])
    return out_k, out_c, n


@dataclass
class _Part:
    kmers: torch.Tensor  # sorted, sentinel-padded
    counts: torch.Tensor
    n: int  # occupied slots (may include zero-count ghost rows)
    first_key: int  # lower bound of the partition's key range
    # distinct live keys; -1 = not yet counted (partitions seeded from
    # a ghosted drain hold ghost rows until a merge collapses them)
    n_real: int = -1

    def real(self) -> int:
        if self.n_real < 0:
            with phases.sync("part.real"):
                self.n_real = int((self.counts > 0).sum())
        return self.n_real


@dataclass(frozen=True)
class _SpcrIndex:
    table: PartTable  # reach_mod.PartSidecar per partition, row-id bases
    rc_indexes: list  # (rc_sorted, rc_order) per partition


@dataclass
class SortedKmerStore:
    """Raw-buffered ingest + partitioned sorted master runs on ``device``."""

    k: int
    device: torch.device
    parts: list = field(default_factory=list)  # ascending key ranges
    max_agg: int = 0  # 0 = _default_max_agg(device), resolved lazily
    _buf: torch.Tensor | None = None  # raw k-mer buffer (lazily allocated)
    _buf_cap: int = 0
    _fill: int = 0  # tiles written * tile width (sentinel slack included)
    # staged run: drained runs merge here pairwise and fold into the
    # master only when the stage fills or a query needs the counts.
    # (keys, counts, n_occupied) or None.
    _staged: tuple | None = None
    # (partition identities, _SpcrIndex) for reach and the primer scans
    _spcr_cache: tuple | None = None

    def __post_init__(self):
        self.device = torch.device(self.device)

    @staticmethod
    def from_arrays(k: int, keys_u64, counts_u32, device) -> "SortedKmerStore":
        """A store holding the given (key, count) rows: numpy uint64 keys
        and uint32 counts, as ``to_sorted_arrays`` exports them from
        either package."""
        store = SortedKmerStore(k, device)
        return store.insert_kmers(np.asarray(keys_u64, np.uint64),
                                  np.asarray(counts_u32, np.uint32))

    def _resolved_max_agg(self) -> int:
        if self.max_agg == 0:
            self.max_agg = _default_max_agg(self.device)
        return self.max_agg

    @property
    def part_budget(self) -> int:
        return self._resolved_max_agg() // 2

    def _count_bits(self) -> int:
        return packed_count_bits(self.k)

    def _keys(self, kmers) -> torch.Tensor:
        if isinstance(kmers, torch.Tensor):
            if kmers.dtype != torch.int64:
                raise TypeError(f"keys must be int64, got {kmers.dtype}")
            return kmers.to(self.device).reshape(-1)
        return keys_to_device(kmers, self.device)

    # -- ingest --------------------------------------------------------------

    def insert_kmers(self, kmers, counts=None) -> "SortedKmerStore":
        """Add k-mers: int64 tensors (device form) or numpy uint64.
        Without counts each occurrence counts 1 and goes to the raw
        buffer; explicit counts (merges, ``from_arrays``) aggregate
        directly in sub-batches of ``max_agg`` and fold into the master."""
        kmers = self._keys(kmers)
        if kmers.shape[0] == 0:
            return self
        if counts is None:
            self._append_raw(kmers)
            return self
        if isinstance(counts, torch.Tensor):
            counts = counts.to(self.device, torch.int64).reshape(-1)
        else:
            counts = counts_to_device(counts, self.device)
        step = self._resolved_max_agg()
        for i in range(0, kmers.shape[0], step):
            ksub, csub = kmers[i : i + step], counts[i : i + step]
            ksub, csub = _pad_to(ksub, csub, _next_pow2(ksub.shape[0]))
            uk, uc, nu = _aggregate(ksub, csub, self._count_bits())
            self._merge_run(uk, uc, nu)
        return self

    def ingest_codes(self, codes) -> "SortedKmerStore":
        codes = torch.as_tensor(np.asarray(codes, np.uint8), device=self.device)
        kmers = canonical_kmers(codes, self.k)
        return self.insert_kmers(kmers.reshape(-1))

    def merge_from(self, other: "SortedKmerStore") -> "SortedKmerStore":
        """Fold another store's contents into this one, device to device
        (the chunked engine's consolidation step)."""
        if other.k != self.k:
            raise ValueError("k mismatch in merge_from")
        other._flushed()
        for p in other.parts:
            self.insert_kmers(p.kmers, p.counts)
        return self

    def _append_raw(self, kmers: torch.Tensor) -> None:
        """Tile-append raw k-mers into the device buffer; drain when full."""
        cap = self._ensure_buffer()
        tile = min(TILE, cap)
        n = kmers.shape[0]
        n_tiles = -(-n // tile)
        appended = 0
        while appended < n_tiles:
            space = (cap - self._fill) // tile
            if space == 0:
                self._drain()
                cap = self._ensure_buffer()
                continue
            take = min(space, n_tiles - appended)
            lo = appended * tile
            hi = min(n, (appended + take) * tile)
            # in place: the buffer is updated where it lies; the unused
            # tail of the last tile keeps the buffer's sentinels
            self._buf[self._fill : self._fill + hi - lo].copy_(kmers[lo:hi])
            self._fill += take * tile
            appended += take

    def _ensure_buffer(self) -> int:
        if self._buf is None:
            self._buf_cap = max(self._resolved_max_agg(), 64)
            self._buf = _sentinels(self._buf_cap, self.device)
            self._fill = 0
        return self._buf_cap

    # -- drains / partition management ----------------------------------------

    def _drain(self) -> None:
        if self._buf is None or self._fill == 0:
            return
        # drain only the filled prefix, rounded up to a power of two
        width = min(self._buf_cap, _next_pow2(self._fill))
        buf = self._buf[:width]
        self._buf = None
        self._fill = 0
        count_bits = self._count_bits()
        with phases.span("store.drain"):
            # nu: occupied rows, ghosts included; the run keeps that width
            if not self.parts and self._staged is None:
                # first drain into an empty store: the ghosted run seeds
                # partitions as is (no compaction sort)
                uk, uc, nu, _n_real = _aggregate_ingest_ghosted(buf)
            elif _drain_v2_wanted(width, count_bits, self.device):
                uk, uc, nu, _n_real = _aggregate_ingest_v2(buf, count_bits)
            else:
                uk, uc, nu = _aggregate_ingest(buf, count_bits)
            del buf
            if nu == 0:
                return
            run_w = min(width, _next_pow2(nu))
            if run_w != width:
                uk, uc = uk[:run_w].clone(), uc[:run_w].clone()
        self._stage_run(uk, uc, nu)

    def _stage_run(self, uk, uc, nu: int) -> None:
        """Accumulate a drained run into the staged run: merging two
        runs is one aggregate; when the stage cannot take the new run it
        folds into the master first."""
        if self._staged is None:
            self._staged = (uk, uc, nu)
            return
        sk, sc, sn = self._staged
        cap = self._resolved_max_agg()
        if sn + nu > cap or sk.shape[0] + uk.shape[0] > 2 * cap:
            self._staged = None
            self._merge_run(sk, sc, sn)
            self._staged = (uk, uc, nu)
            return
        with phases.span("store.merge"):
            mk, mc, mn = _aggregate(
                torch.cat([sk, uk]), torch.cat([sc, uc]), self._count_bits()
            )
            # keep the stage at the smallest power-of-two width that holds it
            want = min(mk.shape[0], _next_pow2(mn))
            if want != mk.shape[0]:
                mk, mc = mk[:want].clone(), mc[:want].clone()
        self._staged = (mk, mc, mn)

    def _fold_staged(self) -> None:
        if self._staged is not None:
            sk, sc, sn = self._staged
            self._staged = None
            self._merge_run(sk, sc, sn)

    def _merge_run(self, uk, uc, nu: int) -> None:
        """Fold one sorted run of ``nu`` occupied rows into the master.
        Partition widths are powers of two that grow by doubling up to
        ``part_budget``."""
        if nu == 0:
            return
        with phases.span("store.merge"):
            self._merge_master(uk, uc, nu)

    def _merge_master(self, uk, uc, nu: int) -> None:
        W = self.part_budget
        ghosted = False
        if nu > W:
            with phases.sync("merge.ghosts"):
                ghosted = bool((uc[:nu] == 0).any())
        if ghosted:
            # a ghosted run cut into W-slices can leave a key's live row
            # and its ghosts in two partitions; the ghosts' partition
            # then starts at that key, later inserts of it route there,
            # and the key ends up counted in both. Compact such a run
            # first: every key is then one row. (The JAX package seeds
            # and routes the ghosted run as is.)
            uk, uc, nu = _filter_compact(uk, uc, 1)
            if nu == 0:
                return
        if not self.parts:
            # seed the master directly from consecutive W-slices of the
            # sorted run; part 0's lower bound is never consulted
            pos = 0
            while pos < nu:
                size = min(W, nu - pos)
                sk, sc = _slice_run(uk, uc, pos, size,
                                    min(W, _next_pow2(size)))
                first_key = 0
                if pos:
                    with phases.sync("merge.first_key"):
                        first_key = int(sk[0])
                self.parts.append(_Part(sk, sc, size, first_key))
                pos += size
            return

        # route the run across the partition key ranges with one
        # searchsorted against the boundary keys
        firsts = [p.first_key for p in self.parts[1:]]
        splits = []
        if firsts:
            with phases.sync("merge.bounds"):  # a pageable copy up
                bounds = torch.tensor(firsts, dtype=torch.int64,
                                      device=self.device)
            with phases.sync("merge.splits"):
                splits = torch.clamp(
                    torch.searchsorted(uk, bounds), max=nu).tolist()
        starts = [0, *splits]
        ends = [*splits, nu]
        # snapshot the targets: a merge may split its partition and
        # shift list indices, but each segment's owner object is fixed
        targets = list(self.parts)
        for part, seg_start, seg_end in zip(targets, starts, ends):
            # a wide run can put more than W keys in one partition's
            # range: merge W-slices in ascending order, threading the
            # tail-owning partition through any splits
            target, pos = part, seg_start
            while pos < seg_end:
                size = min(W, seg_end - pos)
                sk, sc = _slice_run(uk, uc, pos, size,
                                    min(W, _next_pow2(size)))
                target = self._merge_into_part(target, sk, sc)
                pos += size

    def _merge_into_part(self, part: _Part, sk, sc) -> _Part:
        """Merge a sorted slice into ``part``; grow or split if overfull.
        Returns the partition now owning the top of part's key range
        (the right half after a split)."""
        W = self.part_budget
        p_idx = next(i for i, p in enumerate(self.parts) if p is part)
        mk, mc, mn = _aggregate(
            torch.cat([part.kmers, sk]), torch.cat([part.counts, sc]),
            self._count_bits(),
        )
        merged_w = mk.shape[0]
        if mn <= W:
            # the smallest power-of-two width that holds it, never shrinking
            width = min(W, max(part.kmers.shape[0], _next_pow2(mn)))
            nk, nc = _pad_to(mk, mc, width)
            if width < merged_w:
                nk, nc = nk.clone(), nc.clone()
            new = _Part(nk, nc, mn, part.first_key, n_real=mn)
            self.parts[p_idx] = new
            return new
        # overfull: split the merged rows in half, each half at the
        # smallest power-of-two width that holds it. Both merge inputs hold
        # <= W uniques, so mn <= 2W and each half fits the budget. (The JAX
        # package keeps W rows on the left and gives the rest a W-wide
        # partition: a full left half splits again at its next merge, and
        # many small merges, as in a chunked consolidation, leave a master
        # of mostly empty W-wide partitions.)
        half = (mn + 1) // 2
        lk, lc = _slice_run(mk, mc, 0, half, _next_pow2(half))
        rk, rc_ = _slice_run(mk, mc, half, mn - half, _next_pow2(mn - half))
        with phases.sync("split.first_key"):
            first_key = int(rk[0])
        right = _Part(rk, rc_, mn - half, first_key, n_real=mn - half)
        self.parts[p_idx] = _Part(lk, lc, half, part.first_key, n_real=half)
        self.parts.insert(p_idx + 1, right)
        return right

    # -- queries --------------------------------------------------------------

    def _flushed(self) -> "SortedKmerStore":
        self._drain()
        self._fold_staged()
        return self

    def lookup(self, queries) -> np.ndarray:
        """Counts (uint32) of canonical query keys; 0 when absent."""
        s = self._flushed()
        q = self._keys(queries)
        out = torch.zeros_like(q)
        for p in s.parts:
            out += _lookup_part(p.kmers, p.counts, p.n, q)
        return counts_to_numpy(out)

    def lookup_directional(self, queries) -> np.ndarray:
        """Counts (uint32) of directional k-mers, looked up canonically."""
        s = self._flushed()
        q = self._keys(queries)
        if q.shape[0] == 0:
            return np.zeros(0, np.uint32)
        canon = torch.minimum(q, revcomp(q, s.k))
        out = torch.zeros_like(q)
        for p in s.parts:
            out += _lookup_part(p.kmers, p.counts, p.n, canon)
        return counts_to_numpy(out)

    def histogram(self, histo_max: int) -> np.ndarray:
        s = self._flushed()
        total = np.zeros(histo_max + 2, np.uint64)
        for p in s.parts:
            total = total + _histogram(p.counts, histo_max)
        return total

    def n_unique(self) -> int:
        return sum(p.real() for p in self._flushed().parts)

    def n_total(self) -> int:
        s = self._flushed()
        total = 0
        for p in s.parts:
            with phases.sync("counts.sum"):
                total += int(p.counts.sum())
        return total

    def max_count(self) -> int:
        s = self._flushed()
        if not s.parts:
            return 0
        with phases.sync("counts.max", calls=len(s.parts)):
            return max(int(p.counts.max()) for p in s.parts)

    # -- sPCR support: reach closure and primer range scans ---------------------

    def _spcr_index(self) -> _SpcrIndex:
        """Per-partition sPCR structures, cached until the partition list
        changes (partitions are replaced, never mutated): the partitioned
        table of ``reach`` (each partition's bucket LUT sidecar and global
        row-id base, and the kernels' descriptors), and the revcomp-sorted
        indexes of the primer scans. Partitions still holding ghost rows
        are de-ghosted first: a ghost run would inflate its bucket far
        past the LUT's 32-row sizing."""
        s = self._flushed()
        token = tuple(id(p) for p in s.parts)
        if self._spcr_cache is not None and self._spcr_cache[0] == token:
            return self._spcr_cache[1]
        for i, p in enumerate(s.parts):
            if p.n > p.real():
                dk, dc, kept = _filter_compact(p.kmers, p.counts, 1)
                s.parts[i] = _Part(dk, dc, kept, p.first_key, n_real=kept)
        bases, off = [], 0
        for p in s.parts:
            bases.append(off)
            off += p.kmers.shape[0]
        index = _SpcrIndex(
            table=PartTable([reach_mod.build_sidecar(p.kmers, p.counts, s.k,
                                                     p.first_key)
                             for p in s.parts], bases),
            rc_indexes=[rc_index(p.kmers, s.k) for p in s.parts],
        )
        # the token is taken after de-ghosting: the partitions changed
        self._spcr_cache = (tuple(id(p) for p in s.parts), index)
        return index

    def prepare_spcr(self) -> None:
        """Build the sPCR index up front (otherwise the first scan or
        closure does)."""
        if self._flushed().parts:
            self._spcr_index()

    def reach(self, roots, min_count: int, depth: int | None = None,
              pre=None):
        """Depth-capped de Bruijn closure of ``roots`` over this table
        (``ops/reach.py``). ``pre``: already-covered interior keys that
        warm-start the visited set (re-prefetching sessions). Returns a
        ``ReachResult``, or None on overflow."""
        s = self._flushed()
        if not s.parts:
            return reach_mod.ReachResult(
                np.zeros(0, np.uint64), np.zeros(0, np.uint32), True, 0)
        return reach_mod.reach(
            self._spcr_index().table, roots, min_count, s.k,
            depth=depth or reach_mod.DEPTH, pre=pre,
        )

    def prefix_scan_many(self, requests, max_out: int = 1 << 14):
        """Every primer scan of a panel in one scan per partition.

        ``requests``: list of (oligos uint64 array, oligo_len). Returns
        [(kmers, counts)] per request at min count 1 (callers filter),
        with the semantics of ``prefix_scan`` per request. ``max_out``
        bounds the total matches per orientation; overflow retries at
        the exact power of two needed.
        """
        s = self._flushed()
        empty = (np.zeros(0, np.uint64), np.zeros(0, np.uint32))
        if not s.parts:
            return [empty for _ in requests]
        rc_indexes = self._spcr_index().rc_indexes

        n_oligos = 0
        for oligos, olen in requests:
            if olen <= 0 or olen >= s.k:
                raise ValueError(
                    f"oligo length {olen} out of range for k={s.k}"
                )
            n_oligos += len(oligos)
        width = max(64, 1 << max(n_oligos - 1, 0).bit_length())
        all_oligos = np.zeros(width, np.int64)
        all_shifts = np.zeros(width, np.int64)
        all_reqs = np.full(width, -1, np.int64)
        pos = 0
        for ri, (oligos, olen) in enumerate(requests):
            n = len(oligos)
            all_oligos[pos : pos + n] = np.sort(np.asarray(oligos, np.uint64))
            all_shifts[pos : pos + n] = 2 * (s.k - olen)
            all_reqs[pos : pos + n] = ri
            pos += n
        with phases.sync("scan.upload", calls=3):
            oj = torch.from_numpy(all_oligos).to(s.device)
            sj = torch.from_numpy(all_shifts).to(s.device)
            rj = torch.from_numpy(all_reqs).to(s.device)

        results = [([empty[0]], [empty[1]]) for _ in requests]
        for p, (rc_sorted, rc_order) in zip(s.parts, rc_indexes):
            mo = max_out
            while True:
                kk, cc, rr, totals = panel_scan(
                    p.kmers, p.counts, rc_sorted, rc_order, p.n, oj, sj, rj,
                    s.k, mo,
                )
                with phases.sync("scan.total"):
                    tot = int(totals.max())
                if tot <= mo:
                    break
                mo = 1 << (tot - 1).bit_length()
            kf = keys_to_numpy(kk)
            cf = counts_to_numpy(cc)
            with phases.sync("scan.read"):
                rf = rr.cpu()
            rf = rf.numpy()
            # count-0 rows are ghost duplicates of a live key: drop them
            # so results honour the min-count-1 contract
            live = (rf >= 0) & (cf > 0)
            kf, cf, rf = kf[live], cf[live], rf[live]
            order = np.argsort(rf, kind="stable")
            kf, cf, rf = kf[order], cf[order], rf[order]
            bounds = np.searchsorted(rf, np.arange(len(requests) + 1))
            for ri in range(len(requests)):
                lo, hi = bounds[ri], bounds[ri + 1]
                if hi > lo:
                    results[ri][0].append(kf[lo:hi])
                    results[ri][1].append(cf[lo:hi])
        return [
            (np.concatenate(ks), np.concatenate(cs))
            for ks, cs in results
        ]

    def prefix_scan(self, oligos, oligo_len: int, min_count: int,
                    max_out: int = 1 << 12):
        """Table k-mers starting with an oligo on either strand, with
        count >= ``min_count`` (forward precedence, reverse-strand hits
        reported as revcomp), as numpy (kmers, counts)."""
        if oligo_len <= 0 or oligo_len >= self.k:
            raise ValueError(
                f"oligo length {oligo_len} out of range for k={self.k}"
            )
        s = self._flushed()
        oligos = np.asarray(oligos, dtype=np.uint64)
        all_k, all_c = [np.zeros(0, np.uint64)], [np.zeros(0, np.uint32)]
        if s.parts:
            for p, (rc_sorted, rc_order) in zip(
                    s.parts, self._spcr_index().rc_indexes):
                kk, cc = range_scan_part(
                    p.kmers, p.counts, rc_sorted, rc_order, p.n,
                    oligos, oligo_len, s.k, max_out=max_out,
                )
                all_k.append(kk)
                all_c.append(cc)
        kmers = np.concatenate(all_k)
        counts = np.concatenate(all_c)
        keep = counts >= np.uint32(max(min_count, 1))
        return kmers[keep], counts[keep]

    # -- host export -----------------------------------------------------------

    def to_sorted_arrays(
        self, min_count: int = 1
    ) -> tuple[np.ndarray, np.ndarray]:
        """Host mirror: (sorted unique kmers uint64, counts uint32) of
        the rows with count >= ``min_count``, filtered on the device."""
        s = self._flushed()
        keys = [np.zeros(0, np.uint64)]
        counts = [np.zeros(0, np.uint32)]
        for p in s.parts:
            keep = p.counts >= max(min_count, 1)  # empty and ghost rows count 0
            with phases.sync("export.mask", calls=2):
                kept = p.kmers[keep], p.counts[keep]
            keys.append(keys_to_numpy(kept[0]))
            counts.append(counts_to_numpy(kept[1]))
        return np.concatenate(keys), np.concatenate(counts)

    def to_dict(self) -> dict[int, int]:
        keys, counts = self.to_sorted_arrays()
        return dict(zip(keys.tolist(), counts.tolist()))
