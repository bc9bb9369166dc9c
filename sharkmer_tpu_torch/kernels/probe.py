"""Bucket probe of the sPCR reach closure: ``probe_rows``.

It replaces the Pallas TPU kernel of the JAX package,
``sharkmer_tpu/ops/pallas_kernels.py`` ``probe_rows``
(``_gather_windows_kernel``), which ``ops/reach`` calls once per
partition in every BFS level of a closure. Here it probes a whole
partitioned table (``PartTable``) in one launch: each candidate key goes
to the partition whose key range holds it (``route_plain``), and the
result is the global row id of that key with a count ``>= min_count``,
or ``INF32``. The candidate's bucket ``b = min(key >> shift, len(lut) -
2)`` bounds the search to rows ``[lut[b], lut[b + 1])`` of the partition
(the LUT of ``ops/reach.build_sidecar``). The reach closure's warm start
takes it; the closure's own levels probe inside ``reach_closure``. A
sharded table routes by owner instead: its partitions are the shards of
``parallel/``, and a candidate goes to the shard that owns it
(``PartTable.route``).

On a CPU tensor the wrapper runs the plain PyTorch version
(``probe_rows_plain``, the CPU path and the test oracle): per partition,
the JAX package's unpacked XLA gather probe (``reach.py`` ``lookup``,
here ``probe_window_plain``), which reads a fixed window of
``probe_blocks`` 32-row blocks from the bucket's first block. On a CUDA
tensor it launches the hand-written kernel in ``csrc/probe_rows.cu`` (the
partition descriptors and the route in shared memory, an 8-lane group
per candidate scanning exactly its bucket rows; see the source) on the
current stream, or raises. The kernel needs no window width.
``probe_rows.launches`` counts the wrapper's kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..ops.keys import SENTINEL
from ..device import indexed
from . import build, peer
from .hash import owner

BLOCK = 32  # rows per block of the plain version's window
INF32 = 0x7FFF_FFFF  # "no row" in global row ids
_count_lock = threading.Lock()  # gene threads probe concurrently


def probe_window_plain(keys, counts, lut, shift: int, cand, min_count: int,
                       probe_blocks: int = 2) -> torch.Tensor:
    """Row (int32) of each candidate's key in one partition with a count
    ``>= min_count``, else -1. Window gather probe: rows ``[32 * (s >>
    5), + 32 * probe_blocks)`` of the partition, restricted to the bucket
    rows ``[s, e)``. Exact when the window covers every bucket, which
    ``build_sidecar``'s ``probe_blocks`` guarantees."""
    n_cand = cand.shape[0]
    if n_cand == 0:
        return torch.empty(0, dtype=torch.int32, device=cand.device)
    b = torch.clamp(cand >> shift, max=lut.shape[0] - 2)
    s = lut[b].to(torch.int64)
    e = lut[b + 1].to(torch.int64)
    live = (cand != SENTINEL) & (e > s)
    offs = torch.arange(probe_blocks * BLOCK, dtype=torch.int64,
                        device=cand.device)
    rows = ((s >> 5) << 5)[:, None] + offs[None, :]
    safe = torch.clamp(rows, max=keys.shape[0] - 1)
    hit = ((rows >= s[:, None]) & (rows < e[:, None]) & live[:, None]
           & (keys[safe] == cand[:, None]) & (counts[safe] >= min_count))
    row = torch.where(hit, rows, torch.full_like(rows, -1)).max(dim=1).values
    return row.to(torch.int32)


def _check_part(sc) -> None:
    """A partition as the kernels read it: contiguous 1-D int64 keys and
    counts of one length and an int32 LUT of at least one bucket, all on
    the partition's device."""
    for name, t, dtype in (("keys", sc.keys1d, torch.int64),
                           ("counts", sc.counts1d, torch.int64),
                           ("lut", sc.lut, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"PartTable: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"PartTable: {name} must be contiguous 1-D")
        if t.device != sc.keys1d.device:
            raise ValueError(f"PartTable: {name} on {t.device}, keys on "
                             f"{sc.keys1d.device}")
    if sc.keys1d.shape != sc.counts1d.shape:
        raise ValueError("PartTable: keys and counts differ in length")
    if sc.lut.shape[0] < 2:
        raise ValueError("PartTable: the LUT needs at least one bucket")


# -- a partitioned table -----------------------------------------------------


class PartTable:
    """A partitioned table as the probes see it: per partition its sidecar
    (``ops/reach.PartSidecar``: sorted int64 keys and counts, bucket LUT
    and shift, ``first_key`` the lower bound of its key range) and its
    global row-id base. Two routes (``route``): by key range, the
    partitions in ascending key ranges (global row ids then follow key
    order); or, with ``by_owner``, by owner shard, partition ``s`` holding
    the keys that ``hash.owner`` gives ``s`` of ``len(sidecars)`` (row
    ids then do not follow key order). ``n_shards`` is the kernels' route
    argument (0 for key ranges). ``desc`` holds the kernels' partition
    descriptors (``csrc/probe_rows.cuh`` ``PartDesc``: six int64 words a
    partition) on the launching device ``device`` (by default the first
    partition's), and ``first_keys`` the partitions' first keys there,
    both made once. The partitions may lie in separate allocations and on
    other cards (the shards of ``parallel/`` on a device list): each must
    be readable from ``device`` (``peer.check_readable``: the same card,
    or a peer with access enabled), and ``part_devices`` are the devices
    whose streams a launch waits on. ``luts`` are the LUTs the
    descriptors point to: each partition's own where it lies on
    ``device``, else a copy made there once (``lut_copy_bytes`` in all),
    so that a probe's LUT load stays on the launching card and only its
    bucket rows cross to a peer."""

    def __init__(self, sidecars, bases, by_owner: bool = False, device=None):
        self.sidecars = list(sidecars)
        self.bases = tuple(int(b) for b in bases)
        self.n_shards = len(self.sidecars) if by_owner else 0
        self.n_rows = sum(int(s.keys1d.shape[0]) for s in self.sidecars)
        if self.n_rows >= 1 << 31:
            raise ValueError("PartTable: global row ids are int32")
        self.device = indexed(self.sidecars[0].keys1d.device
                              if device is None else device)
        self.part_devices = list(dict.fromkeys(
            indexed(sc.keys1d.device) for sc in self.sidecars))
        rows = []
        self.luts = []
        self.lut_copy_bytes = 0
        for sc, base in zip(self.sidecars, self.bases):
            _check_part(sc)
            peer.check_readable(self.device, sc.keys1d.device)
            lut = sc.lut
            if indexed(lut.device) != self.device:
                lut = lut.to(self.device)
                self.lut_copy_bytes += 4 * lut.numel()
            self.luts.append(lut)
            rows.append([sc.keys1d.data_ptr(), sc.counts1d.data_ptr(),
                         lut.data_ptr(), sc.first_key,
                         sc.lut.shape[0] | (sc.shift << 32), base])
        self.desc = torch.tensor(rows, dtype=torch.int64).to(self.device)
        self.first_keys = self.desc[:, 3].contiguous()
        # closure.stack_parts' flat copies for the plain lookup, by device
        self.plain_blocks = {}

    def route(self, cand) -> torch.Tensor:
        """The partition each candidate probes: its owner shard
        (``hash.owner``) or its key range (``route_plain``)."""
        if self.n_shards:
            return owner(cand, self.n_shards)
        return route_plain(self.first_keys, cand)


def route_plain(first_keys, cand) -> torch.Tensor:
    """The partition of each candidate: the last one whose first key is
    ``<=`` it (partition 0 takes every smaller key)."""
    return torch.searchsorted(first_keys[1:], cand, right=True)


def probe_part_plain(sc, cand, min_count: int, probe_blocks: int):
    """``probe_window_plain`` of ``cand`` in one partition, on the
    partition's device; the rows come back on the candidates' device."""
    row = probe_window_plain(sc.keys1d, sc.counts1d, sc.lut, sc.shift,
                             cand.to(sc.keys1d.device), min_count,
                             probe_blocks)
    return row.to(cand.device)


def probe_rows_plain(table: PartTable, cand, min_count: int) -> torch.Tensor:
    """Global row id (int32) of each candidate with a count ``>=
    min_count``, else ``INF32``: each candidate probes only the partition
    that ``table.route`` gives it."""
    part = table.route(cand)
    ids = torch.full(cand.shape, INF32, dtype=torch.int32, device=cand.device)
    for i, (sc, base) in enumerate(zip(table.sidecars, table.bases)):
        mine = torch.where(part == i, cand, SENTINEL)
        row = probe_part_plain(sc, mine, min_count, sc.probe_blocks)
        ids = torch.where(row >= 0, row + base, ids)
    return ids


def _lib() -> ctypes.CDLL:
    lib = build.load("probe_rows")
    if not getattr(lib, "_shk_bound", False):
        lib.shk_probe_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.shk_probe_rows.restype = ctypes.c_int
        lib._shk_bound = True
    return lib


def probe_rows(table: PartTable, cand, min_count: int) -> torch.Tensor:
    """Global row id (int32) of each candidate's key with a count ``>=
    min_count``, else ``INF32``: ``probe_rows_plain`` on a CPU tensor,
    one kernel launch on a CUDA one."""
    if cand.device.type == "cpu":
        return probe_rows_plain(table, cand, min_count)
    if cand.device.type != "cuda":
        raise ValueError(f"probe_rows: unsupported device {cand.device}")
    desc = table.desc
    if cand.dtype != torch.int64 or cand.dim() != 1 or not cand.is_contiguous():
        raise ValueError("probe_rows: candidates must be contiguous 1-D int64")
    if cand.device != desc.device:
        raise ValueError(f"probe_rows: candidates on {cand.device}, "
                         f"table on {desc.device}")
    if cand.shape[0] >= 1 << 31:
        raise ValueError("probe_rows: candidates are counted in int32")
    n_cand = cand.shape[0]
    lib = _lib()
    out = torch.empty(n_cand, dtype=torch.int32, device=cand.device)
    peer.wait_for_peers(cand.device, table.part_devices)
    with torch.cuda.device(cand.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shk_probe_rows(
            desc.data_ptr(), desc.shape[0], table.n_shards, cand.data_ptr(),
            int(min_count), out.data_ptr(), n_cand, stream,
        )
    if rc != 0:
        raise RuntimeError(f"probe_rows: CUDA launch failed (cudaError {rc})")
    if n_cand:  # no candidates launch nothing
        with _count_lock:
            probe_rows.launches += 1
    return out


probe_rows.launches = 0
