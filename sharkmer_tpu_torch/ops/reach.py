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
a candidate's rows lie in ``[lut[b], lut[b + 1])``. The probe is the
``probe_rows`` kernel (``kernels/probe.py``): one exact probe for every
k and every min count, with no probe plane beside the partition.

Visited set: one byte per global row id (the JAX package keeps a bitmap),
and an append log of first-visit row ids in BFS level blocks, sorted
and gathered once after the loop. The state machine (``_closure_run``) mirrors the JAX
package's exactly, so the visited set and ``iters`` are the same: a
wide phase at ``f_cap`` while the frontier exceeds ``f_narrow``, then a
narrow phase in bodies of 4 levels. The JAX ``lax.while_loop`` is a
host loop here; its condition syncs once per wide level and once per
narrow 4-level body.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.probe import probe_rows
from ..utils import phases
from .encoding import KMER_SENTINEL
from .histogram import revcomp
from .keys import SENTINEL, counts_to_numpy, keys_to_device, keys_to_numpy

log = logging.getLogger("sharkmer")

EMPTY = np.uint64(KMER_SENTINEL)  # the host form; SENTINEL on the device
_INF32 = 0x7FFF_FFFF

# Closure shape defaults (the JAX package's): f_cap grows on overflow
# along 256 -> 1024 -> 4096 -> ...
F_CAP = 256         # live walkers per wide level
F_GROW = 4          # retry multiplier
DEPTH = 2048        # waves of host walk covered per prefetch
F_NARROW = 16       # live walkers per narrow level
BLOCK = 32          # LUT sizing unit: rows a bucket should hold at most
OUT_W = 1 << 14     # result rows gathered with the closure; more spill
PRE_W = 4096        # warm-start keys kept (closest to the roots)

# A closure is a host loop of small launches with a device sync per level
# (per 4 levels in the narrow phase). The sPCR gene threads run closures
# at the same time; interleaved, each one's syncs also wait for the
# others' work on the shared stream, and the threads trade the GIL at
# every sync, which made the sum several times slower than running them
# one after another. So closures run one at a time.
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
    sorted key and count arrays (aliased, no copy) and its bucket LUT.
    ``probe_blocks`` is the 32-row window that covers the largest
    bucket; only the plain probe reads it."""

    keys1d: torch.Tensor
    counts1d: torch.Tensor
    lut: torch.Tensor   # [2^bits + 1] int32 row offsets
    bits: int
    shift: int
    probe_blocks: int = 2


def build_sidecar(part_keys, part_counts, k: int) -> PartSidecar:
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
    return PartSidecar(part_keys, part_counts, lut, bits, shift, probe_blocks)


# -- reachability closure ------------------------------------------------------


def closure_log_w(depth: int, f_cap: int) -> int:
    """Log width: one f_cap block per level, depth levels + the root
    block + up to 3 ghost levels from the narrow phase's 4-level body."""
    return (depth + 4) * f_cap


def _closure_run(lookup, c0, k: int, depth: int, f_cap: int,
                 f_narrow: int, n_rows: int, pre=None):
    """The closure state machine of the JAX package's ``_closure_run``.
    ``lookup(cand) -> global row id | INF`` (int32) is the only
    backend-specific piece; ``n_rows`` bounds the row ids.

    ``c0``: the roots' candidate keys, sentinel-padded. ``pre``
    (optional, sentinel-padded unique canonical keys) warm-starts the
    visited set with the closed interior of a session's cache.

    Returns (log [(depth+4)*f_cap] global row ids INF-padded in BFS
    level blocks, boundary: the frontier at loop exit (non-empty only
    when depth or overflow stopped it), n_vis (device scalar), iters
    (int), overflow, done (device bools)). The narrow phase can run up
    to 3 levels past ``depth``.

    Two departures from the JAX formulation cut the torch ops a level
    runs (each is a kernel launch and a host dispatch): the frontier
    carries its keys' reverse complements, from which the neighbours'
    reverse complements follow by shifts (no full ``revcomp`` per
    level), and the visited set is one byte per row instead of a bitmap
    (a gather to test, a store to mark). Neither changes what is visited.
    """
    device = c0.device
    kmask = (1 << (2 * k)) - 1
    top = 2 * (k - 1)
    log_w = closure_log_w(depth, f_cap)
    inf = _INF32
    base = torch.arange(4, dtype=torch.int64, device=device)[None, :]
    comp = 3 - base  # the complement of each appended base
    # visited[row]; the extra last byte stands for INF and is set, so a
    # clamped INF id tests as visited
    visited = torch.zeros(n_rows + 1, dtype=torch.bool, device=device)
    visited[n_rows] = True

    def expand(frontier, frontier_rc):
        """The 8 de Bruijn neighbours of each live frontier key (4 suffix
        shifts, then 4 prefix shifts), canonical, with the reverse
        complements of the canonical keys."""
        f, r = frontier[:, None], frontier_rc[:, None]
        cand = torch.cat([((f << 2) | base) & kmask, (base << top) | (f >> 2)],
                         dim=1)
        cand_rc = torch.cat([(comp << top) | (r >> 2),
                             ((r << 2) | comp) & kmask], dim=1)
        live = (frontier != SENTINEL)[:, None]
        cc = torch.where(live, torch.minimum(cand, cand_rc), SENTINEL)
        return cc.reshape(-1), torch.maximum(cand, cand_rc).reshape(-1)

    def mark(ids):
        visited[torch.clamp(ids, max=n_rows)] = True

    def process(cc, cc_rc, width: int):
        """First-visit hits among the canonical candidates ``cc``: in the
        table, count >= the floor, not yet visited, unique within the
        call. Returns (frontier keys [width] and their reverse
        complements, their ids [width] ascending INF-padded, n_new,
        overflow: more new rows than the frontier carries)."""
        ids = lookup(cc)
        ids = torch.where(visited[torch.clamp(ids, max=n_rows)], inf, ids)
        ids_s, order = torch.sort(ids)
        first = torch.ones_like(ids_s, dtype=torch.bool)
        first[1:] = ids_s[1:] != ids_s[:-1]
        ids_s = torch.where(first, ids_s, inf)
        n_all = (ids_s != inf).sum()
        ids_f, order2 = torch.sort(ids_s)
        ids_f = ids_f[:width]
        pick = order[order2[:width]]  # the candidate behind each slot
        km_f = torch.where(ids_f != inf, cc[pick], SENTINEL)
        rc_f = cc_rc[pick]
        if ids_f.shape[0] < width:
            # the root call can be narrower than the frontier after a
            # grow-retry raised f_cap past c0's width
            pad = width - ids_f.shape[0]
            ids_f = torch.cat([ids_f, ids_f.new_full((pad,), inf)])
            km_f = torch.cat([km_f, km_f.new_full((pad,), SENTINEL)])
            rc_f = torch.cat([rc_f, rc_f.new_full((pad,), SENTINEL)])
        n_new = (ids_f != inf).sum()
        return km_f, rc_f, ids_f, n_new, n_all > n_new

    def body(state, width: int):
        frontier, frontier_rc, log_ids, n_vis, it, overflow, _done = state
        km, rc, ids, n_new, ov = process(*expand(frontier, frontier_rc),
                                         width)
        mark(ids)
        # log blocks are addressed in f_cap strides in both phases (the
        # narrow block's tail stays INF); the start clamps like
        # lax.dynamic_update_slice
        start = min(it * f_cap, log_w - width)
        log_ids[start : start + width] = ids
        return (km, rc, log_ids, n_vis + n_new, it + 1, overflow | ov,
                n_new == 0)

    def running(state) -> bool:
        """The JAX narrow-loop condition; one device sync."""
        it, overflow, done = state[4:]
        return it <= depth and bool(~done & ~overflow)

    if pre is not None:
        # unique keys -> unique rows; rows below the floor probe to INF
        mark(lookup(pre))
    rc0 = revcomp(c0, k)
    cc0 = torch.where(c0 == SENTINEL, c0, torch.minimum(c0, rc0))
    km0, rc0, ids0, n0, ov0 = process(cc0, torch.maximum(c0, rc0), f_cap)
    mark(ids0)
    log0 = torch.full((log_w,), inf, dtype=torch.int32, device=device)
    log0[: ids0.shape[0]] = ids0

    state = (km0, rc0, log0, n0, 1, ov0, n0 == 0)
    if f_narrow < f_cap:
        while True:
            frontier, it, overflow, done = state[0], *state[4:]
            # the wide phase runs while the frontier would overflow the
            # narrow width; iteration 0 (the roots) ran above
            if it > depth:
                break
            n_live = (frontier != SENTINEL).sum()
            if not bool(~done & ~overflow & (n_live > f_narrow)):
                break
            state = body(state, f_cap)
        # the frontier's live walkers are sorted to the front; the tail
        # cut off here is live only when depth or overflow ended the
        # wide phase, and then belongs to the boundary
        wide_tail = state[0][f_narrow:]
        state = (state[0][:f_narrow], state[1][:f_narrow], *state[2:])
        while running(state):
            for _ in range(4):  # a done state passes through unchanged
                state = body(state, f_narrow)
        boundary = torch.cat([state[0], wide_tail])
    else:
        while running(state):
            state = body(state, f_cap)
        boundary = state[0]
    _, _, log_ids, n_vis, it, overflow, done = state
    return log_ids, boundary, n_vis, it, overflow, done


def _gather_rows(keys1d, counts1d, bases, ids):
    """(keys, counts) of global row ``ids`` (INF-padded, any order) from
    the partitions' sorted arrays; sentinel/0 where the id is INF."""
    live = ids != _INF32
    ids = ids.to(torch.int64)
    out_keys = torch.full(ids.shape, SENTINEL, dtype=torch.int64,
                          device=ids.device)
    out_counts = torch.zeros(ids.shape, dtype=torch.int64, device=ids.device)
    for k1d, c1d, base in zip(keys1d, counts1d, bases):
        local = ids - base
        mine = live & (local >= 0) & (local < k1d.shape[0])
        safe = torch.where(mine, local, 0)
        out_keys = torch.where(mine, k1d[safe], out_keys)
        out_counts = torch.where(mine, c1d[safe], out_counts)
    return out_keys, out_counts


def _reach_call(sidecars, bases, c0, min_count: int, k: int, depth: int,
                f_cap: int, f_narrow: int, n_rows: int, pre=None):
    """One closure over the partitioned table (the JAX package's
    ``_reach_kernel``). Returns (keys, counts [OUT_W], boundary,
    [n_vis, iters, overflow, done], log_sorted): the first-visit id log
    sorted ascending (INF behind) and gathered up to OUT_W rows; the
    driver re-gathers wider from ``log_sorted`` when n_vis > OUT_W."""
    probe_w = max(s.probe_blocks for s in sidecars)

    def lookup(cand):
        """(global row id | INF) per candidate key (int32)."""
        ids = _INF32
        for sc, base in zip(sidecars, bases):
            row = probe_rows(sc.keys1d, sc.counts1d, sc.lut, sc.shift, cand,
                             min_count, probe_w)
            ids = torch.where(row >= 0, row + base if base else row, ids)
        return ids

    log_ids, boundary, n_vis, it, overflow, done = _closure_run(
        lookup, c0, k, depth, f_cap, f_narrow, n_rows, pre=pre)
    # compact the log first (global row ids follow partition key order,
    # so ascending ids are ascending keys), then gather a short prefix
    log_sorted = torch.sort(log_ids).values
    out_w = min(OUT_W, log_sorted.shape[0])
    keys, counts = _gather_rows(
        [s.keys1d for s in sidecars], [s.counts1d for s in sidecars], bases,
        log_sorted[:out_w])
    n_vis, overflow, done = torch.stack(
        [n_vis, overflow.to(torch.int64), done.to(torch.int64)]).tolist()
    return keys, counts, boundary, [n_vis, it, overflow, done], log_sorted


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


def reach(sidecars: list[PartSidecar], bases: tuple, roots: np.ndarray,
          min_count: int, k: int, depth: int = DEPTH, f_cap: int = F_CAP,
          max_retries: int = 4, pre=None) -> ReachResult | None:
    """Single-device reach over the partitions' sidecars; ``bases`` are
    the partitions' global row-id offsets."""
    device = sidecars[0].keys1d.device
    pre_k = _pad_pre(pre, roots=roots)
    pre_t = keys_to_device(pre_k, device) if pre_k is not None else None
    n_rows = sum(int(s.keys1d.shape[0]) for s in sidecars)
    mc = max(min_count, 1)

    def run_kernel(c0, cur_f, cur_n):
        return _reach_call(sidecars, bases, keys_to_device(c0, device), mc,
                           k, depth, cur_f, cur_n, n_rows, pre=pre_t)

    def spill_gather(log_sorted, width):
        return _gather_rows([s.keys1d for s in sidecars],
                            [s.counts1d for s in sidecars], bases,
                            log_sorted[:width])

    with _CLOSURE_LOCK:
        return _drive_closure(run_kernel, roots, depth, f_cap, max_retries,
                              spill_gather=spill_gather)
