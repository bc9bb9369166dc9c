"""The sPCR reach closure in one launch: ``reach_closure``.

One call runs one attempt of a depth-capped de Bruijn closure over a
partitioned table (``probe.PartTable``) at one ``(f_cap, f_narrow)``:
from the roots ``c0`` it expands every hit k-mer to its 8 neighbours,
level by level, keeping the rows with a count ``>= min_count`` that
were not visited yet. It returns ``(log, boundary, state)``:

* ``log`` [``closure_log_w(depth, f_cap)``] int32: the first-visit
  global row ids, ``INF32``-padded (only the set matters: the caller
  sorts it);
* ``boundary`` [``f_cap``] int64: the walkers still live when depth or
  overflow stopped the closure, sentinel-padded (empty when done);
* ``state`` int64 [4]: ``n_vis, iters, overflow, done``
  (``unpack_state``).

It is the port's counterpart of the JAX package's closure loop
(``sharkmer_tpu/ops/reach.py`` ``_closure_run``) with its TPU probe
kernel ``probe_rows`` (``sharkmer_tpu/ops/pallas_kernels.py``) inside
every level. On a CPU tensor the wrapper runs the plain version
(``closure_plain``, the CPU path and the test oracle): that state
machine as a host loop of torch ops, each level's probe
``probe_window_plain``'s over every partition at once (``lookup_plain``).
On a CUDA tensor it launches the hand-written kernel in
``csrc/reach_closure.cu`` (the whole call on one thread-block cluster;
see the source) on the current stream, or raises.
``reach_closure.launches`` counts the wrapper's kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..ops.histogram import revcomp
from ..ops.keys import SENTINEL
from . import build
from . import peer
from .probe import BLOCK, INF32, PartTable

_count_lock = threading.Lock()


def closure_log_w(depth: int, f_cap: int) -> int:
    """Log width: one f_cap block per level, depth levels + the root
    block + up to 3 ghost levels from the narrow phase's 4-level body."""
    return (depth + 4) * f_cap


# the most elements of one [P, chunk, window] temporary of lookup_plain
# (64 MiB of int64): candidates are probed in chunks that keep under it
LOOKUP_CHUNK_ELEMS = 1 << 23


def stack_parts(table: PartTable, device) -> tuple:
    """The table's partitions laid end to end on ``device``, for
    ``lookup_plain``: keys, counts and LUTs each one flat tensor, and per
    partition (``[P, 1]``) its row and LUT offsets in them, its last
    bucket, LUT shift, row count and global base; the probe window in
    blocks. One partition on ``device`` is used as it lies (views). Made
    once a table and device (``table.plain_blocks``): the partitions are
    immutable per flush, as the kernels' descriptors assume."""
    device = torch.device(device)
    cached = table.plain_blocks.get(device)
    if cached is not None:
        return cached
    scs = table.sidecars

    def flat(name):
        return torch.cat([getattr(sc, name).to(device) for sc in scs])

    def column(values):
        return torch.tensor(values, dtype=torch.int64, device=device)[:, None]

    def offsets(lengths):
        return column([sum(lengths[:i]) for i in range(len(lengths))])

    rows = [int(sc.keys1d.shape[0]) for sc in scs]
    luts = [int(sc.lut.shape[0]) for sc in scs]
    blocks = (flat("keys1d"), flat("counts1d"), flat("lut"), offsets(rows),
              offsets(luts), column([n - 2 for n in luts]),
              column([sc.shift for sc in scs]), column(rows),
              column(table.bases), max(sc.probe_blocks for sc in scs))
    table.plain_blocks[device] = blocks
    return blocks


def lookup_plain(table: PartTable, cand, min_count: int) -> torch.Tensor:
    """(global row id | INF32) per candidate key (int32). A key-range
    table: every partition probes every candidate, as the JAX package's
    ``lookup`` does, and the last partition that holds it gives its id.
    An owner-routed table: each shard probes the candidates it owns
    (``table.route``), as the kernel does. Each partition's probe is
    ``probe_window_plain``'s, all partitions at once on ``stack_parts``'
    flat copy, in chunks of candidates that keep each temporary within
    ``LOOKUP_CHUNK_ELEMS``."""
    (keys, counts, lut, row_off, lut_off, last, shift, n_rows, base,
     blocks) = stack_parts(table, cand.device)
    n_parts = row_off.shape[0]
    parts = torch.arange(n_parts, dtype=torch.int64, device=cand.device)
    offs = torch.arange(blocks * BLOCK, dtype=torch.int64, device=cand.device)
    route = table.route(cand) if table.n_shards else None
    chunk = max(1, LOOKUP_CHUNK_ELEMS // (n_parts * blocks * BLOCK))
    out = []
    for lo in range(0, cand.shape[0], chunk):
        c = cand[None, lo:lo + chunk].expand(n_parts, -1)
        if route is not None:
            c = torch.where(route[None, lo:lo + chunk] == parts[:, None], c,
                            SENTINEL)
        b = torch.minimum(c >> shift, last) + lut_off
        s = lut[b].to(torch.int64)
        e = lut[b + 1].to(torch.int64)
        live = (c != SENTINEL) & (e > s)
        rows = ((s >> 5) << 5)[..., None] + offs
        safe = torch.minimum(rows, (n_rows - 1)[..., None]) + row_off[..., None]
        hit = ((rows >= s[..., None]) & (rows < e[..., None])
               & live[..., None] & (keys[safe] == c[..., None])
               & (counts[safe] >= min_count))
        row = torch.where(hit, rows, -1).max(dim=2).values
        pick = torch.where(row >= 0, parts[:, None], -1).max(dim=0).values
        ids = (row + base).gather(0, pick.clamp(min=0)[None, :])[0]
        out.append(torch.where(pick >= 0, ids, INF32).to(torch.int32))
    if not out:
        return torch.empty(0, dtype=torch.int32, device=cand.device)
    return torch.cat(out)


def closure_plain(table: PartTable, c0, pre_ids, min_count: int, k: int,
                  depth: int, f_cap: int, f_narrow: int):
    """The closure state machine of the JAX package's ``_closure_run`` as
    a host loop of torch ops; ``reach_closure`` documents the arguments
    and the result. The narrow phase can run up to 3 levels past
    ``depth``.

    Two departures from the JAX formulation cut the torch ops a level
    runs: the frontier carries its keys' reverse complements, from which
    the neighbours' reverse complements follow by shifts (no full
    ``revcomp`` per level), and the visited set is one byte per row
    instead of a bitmap (a gather to test, a store to mark). Neither
    changes what is visited.
    """
    device = c0.device
    n_rows = table.n_rows
    kmask = (1 << (2 * k)) - 1
    top = 2 * (k - 1)
    log_w = closure_log_w(depth, f_cap)
    base = torch.arange(4, dtype=torch.int64, device=device)[None, :]
    comp = 3 - base  # the complement of each appended base
    # visited[row]; the extra last byte stands for INF and is set, so a
    # clamped INF id tests as visited
    visited = torch.zeros(n_rows + 1, dtype=torch.bool, device=device)
    visited[n_rows] = True

    def lookup(cand):
        return lookup_plain(table, cand, min_count)

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
        ids = torch.where(visited[torch.clamp(ids, max=n_rows)], INF32, ids)
        ids_s, order = torch.sort(ids)
        first = torch.ones_like(ids_s, dtype=torch.bool)
        first[1:] = ids_s[1:] != ids_s[:-1]
        ids_s = torch.where(first, ids_s, INF32)
        n_all = (ids_s != INF32).sum()
        ids_f, order2 = torch.sort(ids_s)
        ids_f = ids_f[:width]
        pick = order[order2[:width]]  # the candidate behind each slot
        km_f = torch.where(ids_f != INF32, cc[pick], SENTINEL)
        rc_f = cc_rc[pick]
        if ids_f.shape[0] < width:
            # the root call can be narrower than the frontier after a
            # grow-retry raised f_cap past c0's width
            pad = width - ids_f.shape[0]
            ids_f = torch.cat([ids_f, ids_f.new_full((pad,), INF32)])
            km_f = torch.cat([km_f, km_f.new_full((pad,), SENTINEL)])
            rc_f = torch.cat([rc_f, rc_f.new_full((pad,), SENTINEL)])
        n_new = (ids_f != INF32).sum()
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

    if pre_ids is not None:
        mark(pre_ids)
    rc0 = revcomp(c0, k)
    cc0 = torch.where(c0 == SENTINEL, c0, torch.minimum(c0, rc0))
    km0, rc0, ids0, n0, ov0 = process(cc0, torch.maximum(c0, rc0), f_cap)
    mark(ids0)
    log0 = torch.full((log_w,), INF32, dtype=torch.int32, device=device)
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
    packed = torch.stack([n_vis.to(torch.int64),
                          torch.tensor(it, dtype=torch.int64, device=device),
                          overflow.to(torch.int64), done.to(torch.int64)])
    return log_ids, boundary, packed


def spill_width(n_c0: int, f_cap: int) -> int:
    """The most candidates of one level: the roots, or 8 neighbours of
    each of f_cap walkers."""
    return max(n_c0, 8 * f_cap)


def closure_scratch(n_rows: int, depth: int, f_cap: int, device,
                    n_c0: int | None = None) -> dict:
    """The kernel's scratch and outputs: the visited bitmap (a bit per
    global row id, zeroed), the two global frontiers ((key, reverse
    complement) per walker; the kernel keeps frontiers of up to 4096
    walkers in shared memory instead), the spill of a
    level's claims past its width (``(key, rc)`` pairs, then ids, for
    ``spill_width(n_c0, f_cap)`` candidates; ``n_c0`` defaults to
    ``_drive_closure``'s ``8 * f_cap``), the log (``INF32``-filled), the
    boundary and the state."""
    n_spill = spill_width(8 * f_cap if n_c0 is None else n_c0, f_cap)
    return {
        "spill": torch.empty(3 * n_spill, dtype=torch.int64, device=device),
        "bitmap": torch.zeros((n_rows + 31) // 32, dtype=torch.int32,
                              device=device),
        "front": torch.empty(2 * f_cap * 2, dtype=torch.int64, device=device),
        "log": torch.full((closure_log_w(depth, f_cap),), INF32,
                          dtype=torch.int32, device=device),
        "boundary": torch.empty(f_cap, dtype=torch.int64, device=device),
        "state": torch.empty(4, dtype=torch.int64, device=device),
    }


def unpack_state(state) -> list[int]:
    """``[n_vis, iters, overflow, done]`` from the packed state: the one
    host read of a call."""
    return [int(v) for v in state.tolist()]


def _lib() -> ctypes.CDLL:
    lib = build.load("reach_closure")
    if not getattr(lib, "_shk_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.shk_reach_closure.argtypes = [
            p, i, i, p, i, p, i, ctypes.c_int64, i, i, i, i, p, p, p, p, p,
            p, i, p,
        ]
        lib.shk_reach_closure.restype = ctypes.c_int
        lib._shk_bound = True
    return lib


def _check(c0, pre_ids, k: int, f_cap: int, f_narrow: int) -> None:
    if c0.dtype != torch.int64 or c0.dim() != 1 or not c0.is_contiguous():
        raise ValueError("reach_closure: c0 must be contiguous 1-D int64")
    if pre_ids is not None and (
            pre_ids.dtype != torch.int32 or pre_ids.dim() != 1
            or not pre_ids.is_contiguous() or pre_ids.device != c0.device):
        raise ValueError("reach_closure: pre_ids must be contiguous 1-D "
                         "int32 beside c0")
    if not 1 <= k <= 31:
        raise ValueError(f"reach_closure: k = {k} is outside [1, 31]")
    if f_cap < 1 or f_narrow < 1:
        raise ValueError("reach_closure: frontier widths must be positive")
    if c0.shape[0] >= 1 << 31:
        raise ValueError("reach_closure: more than 2^31 roots")


def reach_closure(table: PartTable, c0, pre_ids, min_count: int, k: int,
                  depth: int, f_cap: int, f_narrow: int):
    """One closure attempt; see the module docstring. ``c0``: the roots'
    keys (directional, sentinel-padded). ``pre_ids``: global row ids
    (``INF32``-padded, unique) that start visited, or None."""
    if c0.device.type == "cpu":
        return closure_plain(table, c0, pre_ids, min_count, k, depth, f_cap,
                             f_narrow)
    if c0.device.type != "cuda":
        raise ValueError(f"reach_closure: unsupported device {c0.device}")
    _check(c0, pre_ids, k, f_cap, f_narrow)
    desc = table.desc
    if desc.device != c0.device:
        raise ValueError(f"reach_closure: roots on {c0.device}, table on "
                         f"{desc.device}")
    lib = _lib()
    # scratch, frontier, log and outputs on the launching card; the
    # partitions wherever the table's descriptors point
    out = closure_scratch(table.n_rows, depth, f_cap, c0.device,
                          c0.shape[0])
    n_pre = 0 if pre_ids is None else pre_ids.shape[0]
    peer.wait_for_peers(c0.device, table.part_devices)
    with torch.cuda.device(c0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shk_reach_closure(
            desc.data_ptr(), desc.shape[0], table.n_shards, c0.data_ptr(),
            c0.shape[0],
            pre_ids.data_ptr() if n_pre else None, n_pre, int(min_count), k,
            depth, f_cap, f_narrow, out["bitmap"].data_ptr(),
            out["front"].data_ptr(), out["log"].data_ptr(),
            out["boundary"].data_ptr(), out["state"].data_ptr(),
            out["spill"].data_ptr(), out["spill"].shape[0] // 3, stream,
        )
    if rc != 0:
        raise RuntimeError(f"reach_closure: CUDA launch failed (cudaError {rc})")
    with _count_lock:
        reach_closure.launches += 1
    return out["log"], out["boundary"], out["state"]


reach_closure.launches = 0
