"""Bucket probe of the sPCR reach closure: ``probe_rows``.

It replaces the Pallas TPU kernel of the JAX package,
``sharkmer_tpu/ops/pallas_kernels.py`` ``probe_rows``
(``_gather_windows_kernel``), which ``ops/reach`` calls once per
partition in every BFS level of a closure. For each candidate key it
returns the row of one sorted partition that holds that key with a
count ``>= min_count``, or -1. The candidate's bucket ``b = min(key >>
shift, len(lut) - 2)`` bounds the search to rows ``[lut[b],
lut[b + 1])`` (the LUT of ``ops/reach.build_sidecar``).

On a CPU tensor the wrapper runs the plain PyTorch version (the CPU
path and the test oracle): the JAX package's unpacked XLA gather probe
(``reach.py`` ``lookup``), which reads a fixed window of
``probe_blocks`` 32-row blocks from the bucket's first block. On a
CUDA tensor it launches the hand-written kernel in
``csrc/probe_rows.cu`` (a warp per candidate scans exactly its bucket
rows; see the source) on the current stream, or raises. The kernel
needs no window width: ``probe_blocks`` only sizes the plain version's
gather. ``probe_rows.launches`` counts the wrapper's kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..ops.keys import SENTINEL
from . import build

BLOCK = 32  # rows per block of the plain version's window
_count_lock = threading.Lock()  # gene threads probe concurrently


def probe_rows_plain(keys, counts, lut, shift: int, cand, min_count: int,
                     probe_blocks: int = 2) -> torch.Tensor:
    """Window gather probe: rows ``[32 * (s >> 5), + 32 * probe_blocks)``
    of the partition, restricted to the bucket rows ``[s, e)``. Exact
    when the window covers every bucket, which ``build_sidecar``'s
    ``probe_blocks`` guarantees."""
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


def _lib() -> ctypes.CDLL:
    lib = build.load("probe_rows")
    if not getattr(lib, "_shk_bound", False):
        lib.shk_probe_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.shk_probe_rows.restype = ctypes.c_int
        lib._shk_bound = True
    return lib


def _check(keys, counts, lut, cand) -> None:
    for name, t, dtype in (("keys", keys, torch.int64),
                           ("counts", counts, torch.int64),
                           ("lut", lut, torch.int32),
                           ("cand", cand, torch.int64)):
        if t.dtype != dtype:
            raise TypeError(f"probe_rows: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"probe_rows: {name} must be contiguous 1-D")
        if t.device != cand.device:
            raise ValueError(f"probe_rows: {name} on {t.device}, "
                             f"candidates on {cand.device}")
    if keys.shape != counts.shape:
        raise ValueError("probe_rows: keys and counts differ in length")
    if keys.shape[0] >= 1 << 31 or cand.shape[0] >= 1 << 31:
        raise ValueError("probe_rows: rows and candidates are int32")
    if lut.shape[0] < 2:
        raise ValueError("probe_rows: the LUT needs at least one bucket")


def probe_rows(keys, counts, lut, shift: int, cand, min_count: int,
               probe_blocks: int = 2) -> torch.Tensor:
    """Row (int32) of each candidate's key in its bucket with a count
    ``>= min_count``, else -1."""
    if cand.device.type == "cpu":
        return probe_rows_plain(keys, counts, lut, shift, cand, min_count,
                                probe_blocks)
    if cand.device.type != "cuda":
        raise ValueError(f"probe_rows: unsupported device {cand.device}")
    _check(keys, counts, lut, cand)
    n_cand = cand.shape[0]
    lib = _lib()
    out = torch.empty(n_cand, dtype=torch.int32, device=cand.device)
    with torch.cuda.device(cand.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shk_probe_rows(
            keys.data_ptr(), counts.data_ptr(), lut.data_ptr(), lut.shape[0],
            shift, cand.data_ptr(), int(min_count), out.data_ptr(), n_cand,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"probe_rows: CUDA launch failed (cudaError {rc})")
    if n_cand:  # no candidates launch nothing
        with _count_lock:
            probe_rows.launches += 1
    return out


probe_rows.launches = 0
