"""Run-position scans over sorted int64 keys: ``run_ends`` and ``run_starts``.

They replace the Pallas TPU kernels of the JAX package,
``sharkmer_tpu/ops/pallas_kernels.py`` ``run_ends`` (``_run_end_kernel``)
and ``run_starts`` (``_run_start_kernel``). The sorted store's drains
use them to turn a sorted raw-key buffer into run totals: the ghosted
fresh drain takes ``run_end - pos + 1`` at each run's first row, every
later drain ``pos - run_start + 1`` at each run's last row.

Each wrapper takes a contiguous int64 tensor of sorted keys with fewer
than 2^31 elements and returns int32 positions. On a CPU tensor it runs
the plain PyTorch version (the CPU path and the test oracle); on a
CUDA tensor it launches the hand-written kernel in ``csrc/run_scan.cu``
(three passes: tile-local scan, scan of the tile aggregates, carry
fold; see the source for the design) on the current stream, or raises.
The kernels are bound by device memory bandwidth: 8 B read and 4 B
written per element at best. ``<wrapper>.launches`` counts the
wrapper's kernel launches, so that a run can show it went through them.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

INT32_MAX = 0x7FFF_FFFF


def run_ends_plain(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Reverse cummin over run-end positions (the JAX package's XLA
    formulation, ``sorted_store._aggregate_ingest_ghosted_impl``)."""
    n = sorted_keys.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=sorted_keys.device)
    last = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    last[:-1] = sorted_keys[:-1] != sorted_keys[1:]
    marked = torch.where(last, pos, torch.full_like(pos, INT32_MAX))
    return torch.flip(torch.cummin(torch.flip(marked, (0,)), 0).values, (0,))


def run_starts_plain(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Cummax over run-start positions (the JAX package's XLA
    formulation, ``sorted_store._aggregate_ingest_impl``)."""
    n = sorted_keys.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=sorted_keys.device)
    first = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values


def _lib() -> ctypes.CDLL:
    lib = build.load("run_scan")
    if not getattr(lib, "_shk_bound", False):
        for fn in (lib.shk_run_ends, lib.shk_run_starts):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.shk_run_scan_tile.argtypes = []
        lib.shk_run_scan_tile.restype = ctypes.c_int
        lib._shk_bound = True
    return lib


def _launch(entry: str, sorted_keys: torch.Tensor) -> torch.Tensor:
    if sorted_keys.dtype != torch.int64:
        raise TypeError(f"{entry}: keys must be int64, got {sorted_keys.dtype}")
    if sorted_keys.dim() != 1 or not sorted_keys.is_contiguous():
        raise ValueError(f"{entry}: keys must be a contiguous 1-D tensor")
    n = sorted_keys.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"{entry}: {n} elements; positions are int32")
    lib = _lib()
    out = torch.empty(n, dtype=torch.int32, device=sorted_keys.device)
    tile = lib.shk_run_scan_tile()
    scratch = torch.empty(max(1, -(-n // tile)), dtype=torch.int32,
                          device=sorted_keys.device)
    with torch.cuda.device(sorted_keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            sorted_keys.data_ptr(), out.data_ptr(), scratch.data_ptr(), n,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed (cudaError {rc})")
    return out


def run_ends(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Position of each element's equal-key run END (int32)."""
    if sorted_keys.device.type == "cpu":
        return run_ends_plain(sorted_keys)
    if sorted_keys.device.type != "cuda":
        raise ValueError(f"run_ends: unsupported device {sorted_keys.device}")
    out = _launch("shk_run_ends", sorted_keys)
    if out.shape[0]:  # an empty input launches nothing
        run_ends.launches += 1
    return out


def run_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Position of each element's equal-key run START (int32)."""
    if sorted_keys.device.type == "cpu":
        return run_starts_plain(sorted_keys)
    if sorted_keys.device.type != "cuda":
        raise ValueError(f"run_starts: unsupported device {sorted_keys.device}")
    out = _launch("shk_run_starts", sorted_keys)
    if out.shape[0]:  # an empty input launches nothing
        run_starts.launches += 1
    return out


run_ends.launches = 0
run_starts.launches = 0
