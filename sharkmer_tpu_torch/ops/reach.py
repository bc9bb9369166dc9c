"""Depth-capped reachability closure for the sPCR prefetch (torch port of
``sharkmer_tpu.ops.reach``: the bucket LUT sidecar and the closure).

The sPCR graph extension is a host BFS that asks for the counts of one
small candidate batch per wave (``pcr/graph.py``). ``reach`` serves
those waves ahead of time: from the wave's candidates it repeatedly
expands every hit k-mer to its 8 de Bruijn neighbours (4 suffix shifts
and 4 prefix shifts, the candidate set the host enumerates), keeps the
hits with count >= the step threshold, and returns the visited rows.
A hit in the result is the exact table count; a miss within ``depth``
waves is below the threshold; once the closure ran to quiescence every
miss is final (``pcr/prefetch.py``). The host mirror of the whole
table is then never built.

Table probe: each partition gets a bucket LUT (``build_sidecar``):
``lut[b]`` is the first row whose key's top ``bits`` bits are >= b, so
a candidate's rows lie in ``[lut[b], lut[b + 1])``. A candidate probes
only the partition whose key range holds it (``first_key``): one exact
probe for every k and every min count, with no probe plane beside the
partition.

Closure: each attempt of a call is one ``reach_closure`` launch
(``kernels/closure.py``), which runs the JAX package's state machine
(a wide phase at ``f_cap`` while the frontier exceeds ``f_narrow``,
then a narrow phase in bodies of 4 levels) on the device, so the
visited set and ``iters`` are the JAX package's. It returns an append
log of first-visit row ids, sorted and gathered once here, and one
packed state array that the host reads once per attempt. A warm start
probes its keys with one ``probe_rows`` launch over every partition.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.closure import reach_closure, unpack_state
from ..kernels.probe import INF32 as _INF32
from ..kernels.probe import PartTable, probe_rows
from ..utils import phases
from .encoding import KMER_SENTINEL
from .keys import SENTINEL, counts_to_numpy, keys_to_device, keys_to_numpy

log = logging.getLogger("sharkmer")

EMPTY = np.uint64(KMER_SENTINEL)  # the host form; SENTINEL on the device

# Closure shape defaults (the JAX package's): f_cap grows on overflow
# along 256 -> 1024 -> 4096 -> ...
F_CAP = 256         # live walkers per wide level
F_GROW = 4          # retry multiplier
DEPTH = 2048        # waves of host walk covered per prefetch
F_NARROW = 16       # live walkers per narrow level
BLOCK = 32          # LUT sizing unit: rows a bucket should hold at most
OUT_W = 1 << 14     # result rows gathered with the closure; more spill
PRE_W = 4096        # warm-start keys kept (closest to the roots)

# Closures run one at a time, though the sPCR gene threads ask for them at
# once: while a closure was a host loop with a sync per level, interleaved
# closures waited on each other's work on the shared stream and took
# several times longer in sum (PERF.md). Whether one launch per
# attempt would now gain from interleaving is untested.
_CLOSURE_LOCK = threading.Lock()


# -- bucket LUT sidecar --------------------------------------------------------


def _lut_bits(n_slots: int, k: int) -> int:
    """Initial bucket-bit guess (~rows/16 per bucket); build_sidecar
    raises it until the max occupancy fits one 2-block probe."""
    b = max(6, n_slots.bit_length() - 5)
    return min(b, 2 * k - 1, 26)


def _lut_bits_cap(k: int) -> int:
    return min(2 * k - 1, 26)


def _build_lut(keys: torch.Tensor, bits: int, shift: int):
    """(lut, max_occ): ``lut[b]`` (int32, b in [0, 2^bits]) is the first
    row whose bucket ``key >> shift`` is >= b, so buckets past the last
    occupied row and the sentinel rows get ``n_real``; ``max_occ`` is
    the largest bucket. The JAX package's ``_build_lut_kernel`` sorts
    the bucket starts and backfills with a reversed cummin; one
    searchsorted of the ``2^bits + 1`` bucket boundaries gives the same
    table without the cummin (torch's int64 cummin is slow on the card)."""
    bounds = torch.arange((1 << bits) + 1, dtype=torch.int64,
                          device=keys.device) << shift
    lut = torch.searchsorted(keys, bounds, out_int32=True)
    max_occ = int((lut[1:] - lut[:-1]).max())
    return lut, max_occ


@dataclass(frozen=True)
class PartSidecar:
    """One partition's probe structures (immutable per flush): its
    sorted key and count arrays (aliased, no copy), its bucket LUT and
    ``first_key``, the lower bound of its key range (the store's routing
    bound; partition 0's is never consulted). ``probe_blocks`` is the
    32-row window that covers the largest bucket; only the plain probe
    reads it."""

    keys1d: torch.Tensor
    counts1d: torch.Tensor
    lut: torch.Tensor   # [2^bits + 1] int32 row offsets
    bits: int
    shift: int
    probe_blocks: int = 2
    first_key: int = 0


def build_sidecar(part_keys, part_counts, k: int,
                  first_key: int = 0) -> PartSidecar:
    """The LUT of one de-ghosted partition: bits raised until every
    bucket holds at most BLOCK rows (or the bits cap), then the window
    of ``probe_blocks`` 32-row blocks that covers the largest bucket
    from any alignment (``32 * w - 31`` rows), as in the JAX package."""
    n_slots = int(part_keys.shape[0])
    bits = _lut_bits(n_slots, k)
    cap = _lut_bits_cap(k)
    while True:
        shift = 2 * k - bits
        lut, max_occ = _build_lut(part_keys, bits, shift)
        if max_occ <= BLOCK or bits >= cap:
            break
        bits += 1
    probe_blocks = 2
    while max_occ > BLOCK * probe_blocks - (BLOCK - 1):
        probe_blocks *= 2
    return PartSidecar(part_keys, part_counts, lut, bits, shift, probe_blocks,
                       first_key)


# -- reachability closure ------------------------------------------------------


def _gather_rows(table: PartTable, ids):
    """(keys, counts) of global row ``ids`` (INF-padded, any order) from
    the partitions' sorted arrays; sentinel/0 where the id is INF."""
    live = ids != _INF32
    ids = ids.to(torch.int64)
    out_keys = torch.full(ids.shape, SENTINEL, dtype=torch.int64,
                          device=ids.device)
    out_counts = torch.zeros(ids.shape, dtype=torch.int64, device=ids.device)
    for sc, base in zip(table.sidecars, table.bases):
        k1d, c1d = sc.keys1d, sc.counts1d
        local = ids - base
        mine = live & (local >= 0) & (local < k1d.shape[0])
        safe = torch.where(mine, local, 0)
        out_keys = torch.where(mine, k1d[safe], out_keys)
        out_counts = torch.where(mine, c1d[safe], out_counts)
    return out_keys, out_counts


def _reach_call(table: PartTable, c0, min_count: int, k: int, depth: int,
                f_cap: int, f_narrow: int, pre_ids=None):
    """One closure over the partitioned table (the JAX package's
    ``_reach_kernel``): one ``reach_closure`` call. Returns (keys, counts
    [OUT_W], boundary, [n_vis, iters, overflow, done], log_sorted): the
    first-visit id log sorted ascending (INF behind) and gathered up to
    OUT_W rows; ``_drive_closure`` re-gathers wider from ``log_sorted`` when
    n_vis > OUT_W."""
    log_ids, boundary, state = reach_closure(
        table, c0, pre_ids, min_count, k, depth, f_cap, f_narrow)
    # compact the log first (global row ids follow partition key order,
    # so ascending ids are ascending keys), then gather a short prefix
    log_sorted = torch.sort(log_ids).values
    out_w = min(OUT_W, log_sorted.shape[0])
    keys, counts = _gather_rows(table, log_sorted[:out_w])
    return keys, counts, boundary, unpack_state(state), log_sorted


@dataclass
class ReachResult:
    keys: np.ndarray      # visited row keys, ascending
    counts: np.ndarray
    complete: bool        # frontier emptied: closure fully explored
    iters: int
    # cutoff-frontier keys when the depth cap was hit (empty when
    # complete): the caller must NOT treat these as closed interior
    # when warm-starting a later closure
    boundary: np.ndarray = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.boundary is None:
            self.boundary = np.zeros(0, np.uint64)


def _pad_pre(pre, roots=None) -> np.ndarray | None:
    """Warm-start keys, deduplicated (the bitmap's scatter-add is an
    exact OR only for unique ids) and padded to PRE_W. When there are
    more, the PRE_W keys nearest the new roots in sorted-key rank are
    kept: the walk re-expands outward from the roots."""
    if pre is None:
        return None
    pre = np.unique(np.asarray(pre, np.uint64).reshape(-1))
    pre = pre[pre != EMPTY]
    if len(pre) == 0:
        return None
    if len(pre) > PRE_W and roots is not None and len(roots):
        ins = np.searchsorted(pre, np.asarray(roots, np.uint64))
        half = max(PRE_W // (2 * len(ins)), 1)
        idx = np.unique(
            np.clip(
                ins[:, None] + np.arange(-half, half)[None, :],
                0, len(pre) - 1,
            )
        )
        while len(idx) < PRE_W and len(idx) < len(pre):
            half *= 2
            idx = np.unique(
                np.clip(
                    ins[:, None] + np.arange(-half, half)[None, :],
                    0, len(pre) - 1,
                )
            )
        pre = pre[idx[:PRE_W]]
    out = np.full(PRE_W, EMPTY, np.uint64)
    out[: min(len(pre), PRE_W)] = pre[:PRE_W]
    return out


def _drive_closure(run_kernel, roots: np.ndarray, depth: int,
                   f_cap: int = F_CAP,
                   max_retries: int = 4,
                   spill_gather=None) -> ReachResult | None:
    """Host driver for closure calls with grow-and-retry.

    ``run_kernel(c0, f_cap, f_narrow) -> (keys, counts, boundary,
    [n_vis, iters, overflow, done][, log_sorted])``, ``c0`` numpy
    uint64, is the backend hook. ``roots``: candidate k-mers of the
    current host wave (directional; canonicalized on the device).
    ``spill_gather(log_sorted, width) -> (keys, counts)`` re-gathers a
    wider result prefix when n_vis exceeds the call's OUT_W rows.
    Returns None when the closure overflowed even at the largest retry
    shapes (the caller falls back to the mirror or per-wave lookups).
    """
    roots = np.unique(np.asarray(roots, dtype=np.uint64).reshape(-1))
    roots = roots[roots != EMPTY]
    if len(roots) == 0:
        return ReachResult(
            np.zeros(0, np.uint64), np.zeros(0, np.uint32), True, 0
        )
    out_k: list[np.ndarray] = []
    out_c: list[np.ndarray] = []
    out_b: list[np.ndarray] = []
    complete = True
    iters = 0
    # start wide enough that the root wave's own hits fit the frontier
    # (iteration 0 can yield up to len(roots) new rows)
    while f_cap < min(len(roots), 4096):
        f_cap *= F_GROW
    c_cap = 8 * f_cap
    for start in range(0, len(roots), c_cap):
        chunk = roots[start : start + c_cap]
        c0 = np.full(c_cap, EMPTY, np.uint64)
        c0[: len(chunk)] = chunk
        cur_f, cur_n = f_cap, F_NARROW
        t_call = time.perf_counter()
        for attempt in range(max_retries + 1):
            out = run_kernel(c0, cur_f, min(cur_n, cur_f))
            keys, counts, boundary, scalars = out[:4]
            log_sorted = out[4] if len(out) > 4 else None
            n_vis, it, overflow, done = (int(v) for v in scalars)
            if not overflow:
                break
            if attempt == max_retries:
                return None
            # an overflow can come from either phase: grow both widths
            cur_f *= F_GROW
            cur_n *= F_GROW
        if n_vis > int(keys.shape[0]):
            if spill_gather is None or log_sorted is None:
                n_vis = int(keys.shape[0])
            else:
                # the visited set exceeds the OUT_W prefix: one wider
                # gather over the sorted id log
                w = 1 << max(n_vis - 1, 0).bit_length()
                w = min(w, int(log_sorted.shape[0]))
                keys, counts = spill_gather(log_sorted, w)
        if n_vis:
            out_k.append(keys_to_numpy(keys[:n_vis]))
            out_c.append(counts_to_numpy(counts[:n_vis]))
        else:
            out_k.append(np.zeros(0, np.uint64))
            out_c.append(np.zeros(0, np.uint32))
        complete = complete and bool(done)
        if not done:
            bh = keys_to_numpy(boundary)
            out_b.append(bh[bh != EMPTY])
        iters += it
        call_wall = time.perf_counter() - t_call
        phases.add("closures", call_wall)
        phases.add("closure_levels", 0.0, calls=it)
        log.debug(
            "reach: %d roots, %d iters, %d visited, f_cap %d, "
            "done=%s, %.3fs",
            len(chunk), it, n_vis, cur_f, bool(done), call_wall,
        )

    keys = np.concatenate(out_k)
    counts = np.concatenate(out_c)
    order = np.argsort(keys)
    keys, counts = keys[order], counts[order]
    if len(out_k) > 1 and len(keys):
        keep = np.concatenate([[True], keys[1:] != keys[:-1]])
        keys, counts = keys[keep], counts[keep]
    bound = (
        np.unique(np.concatenate(out_b)) if out_b
        else np.zeros(0, np.uint64)
    )
    return ReachResult(keys, counts, complete, iters, bound)


def reach(table: PartTable, roots: np.ndarray, min_count: int, k: int,
          depth: int = DEPTH, f_cap: int = F_CAP, max_retries: int = 4,
          pre=None) -> ReachResult | None:
    """Single-device reach over a partitioned table of ``PartSidecar``s
    (built once per flush by the store's ``_spcr_index``)."""
    device = table.device
    mc = max(min_count, 1)
    pre_k = _pad_pre(pre, roots=roots)
    # unique keys -> unique rows; rows below the floor probe to INF
    pre_ids = (probe_rows(table, keys_to_device(pre_k, device), mc)
               if pre_k is not None else None)

    def run_kernel(c0, cur_f, cur_n):
        return _reach_call(table, keys_to_device(c0, device), mc, k, depth,
                           cur_f, cur_n, pre_ids=pre_ids)

    def spill_gather(log_sorted, width):
        return _gather_rows(table, log_sorted[:width])

    with _CLOSURE_LOCK:
        return _drive_closure(run_kernel, roots, depth, f_cap, max_retries,
                              spill_gather=spill_gather)
