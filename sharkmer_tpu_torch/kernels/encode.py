"""Canonical k-mers of a code batch on the card, with its totals:
``encode``.

It replaces no TPU kernel: the JAX package's ``canonical_kmers``
(``sharkmer_tpu/ops/encoding.py:88``) is one jitted XLA function. Its
plain version is ``ops/encoding.canonical_kmers_plain`` (the CPU path
and the test oracle); ``ops/encoding.canonical_kmers`` calls
``encode`` on a CUDA tensor.

``encode(codes, k, totals=None)`` takes contiguous uint8 ``[n, width]``
codes (0-3 bases, 4 N, 5 pad) on the card and returns int64 ``[n,
width - k + 1]`` keys, each the lesser of the window's forward and
reverse-complement k-mer, or ``keys.SENTINEL`` where the window holds a
code of 4 or 5: the values of the plain version. Where ``totals`` (int64
``[2]`` on the same card) is given, the kernel adds the batch's valid
windows into ``totals[0]`` and its codes below 4, over every column,
into ``totals[1]``. A batch narrower than k gives no key and adds its
bases. The launch is one kernel on the current stream (``csrc/encode.cu``,
its design there), or raises; ``encode.launches`` counts them.

``plan(width, k)`` cuts the rows into the kernel's segments (a whole
row up to ``BUDGET`` codes, several to a block; past it, tiles of
``LONG_TILE`` windows that overlap by k - 1 codes, one a block), as the
kernel indexes them; the CPU tests hold it to the plain version through
a numpy model of the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build

BUDGET = 4096  # the codes a block stages
LONG_TILE = BUDGET - 32  # the windows of a tile of a row past BUDGET codes
SMEM_CAP = 32 * 1024  # dynamic shared memory a block, under the 48 KB
# a block may take without opting in (its two static sums beside it)
SLOT_PAD = 3  # words a segment holds past its windows' first word


class Plan(NamedTuple):
    tile: int  # windows a segment (0: the rows are narrower than k)
    n_tiles: int  # segments a row
    seg_per_block: int  # under SMEM_CAP: 8 B of shared memory a slot word
    slot_words: int  # 32-bit words a segment's slot, in each of two arrays


def plan(width: int, k: int) -> Plan:
    """The kernel's segments for rows of ``width`` codes at ``k``."""
    w = width - k + 1
    if width <= BUDGET:
        tile, n_tiles = max(w, 0), 1
    else:
        tile, n_tiles = LONG_TILE, -(-w // LONG_TILE)
    # a window's three words lie in its segment's slot
    slot_words = (max(tile, 1) - 1) // 16 + SLOT_PAD
    seg = 1
    if n_tiles == 1:
        seg = max(1, min(BUDGET // width, SMEM_CAP // (8 * slot_words)))
    return Plan(tile, n_tiles, seg, slot_words)


def _lib() -> ctypes.CDLL:
    lib = build.load("encode")
    if not getattr(lib, "_shk_bound", False):
        lib.shk_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.shk_encode.restype = ctypes.c_int
        lib._shk_bound = True
    return lib


def encode(codes, k: int, totals=None) -> torch.Tensor:
    """The keys of ``codes`` (int64 ``[n, width - k + 1]``); the valid
    windows and bases added into ``totals`` where given."""
    if codes.dtype != torch.uint8:
        raise TypeError(f"encode: codes must be uint8, got {codes.dtype}")
    if codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError("encode: codes must be a contiguous [n, width] "
                         "tensor")
    if not 0 < k < 32:
        raise ValueError(f"encode: k must be between 1 and 31, got {k}")
    if codes.shape[1] >= 1 << 31:
        raise ValueError(f"encode: width {codes.shape[1]} is too large")
    if totals is not None:
        if totals.dtype != torch.int64 or totals.shape != (2,):
            raise TypeError(f"encode: totals must be int64 [2], got "
                            f"{totals.dtype} {tuple(totals.shape)}")
        if not totals.is_contiguous() or totals.device != codes.device:
            raise ValueError("encode: totals must be contiguous, on the "
                             "codes' device")
    if codes.device.type != "cuda":
        raise ValueError(f"encode: codes on {codes.device}, not a CUDA "
                         f"device")
    n, width = codes.shape
    keys = torch.empty((n, max(width - k + 1, 0)), dtype=torch.int64,
                       device=codes.device)
    if n == 0 or width == 0 or (totals is None and width < k):
        return keys  # nothing to read, or nothing to write: no launch
    p = plan(width, k)
    lib = _lib()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shk_encode(codes.data_ptr(), keys.data_ptr(),
                            None if totals is None else totals.data_ptr(),
                            n, width, k, p.tile, p.n_tiles, p.seg_per_block,
                            p.slot_words, stream)
    if rc != 0:
        raise RuntimeError(f"encode: CUDA launch failed (cudaError {rc})")
    encode.launches += 1
    return keys


encode.launches = 0
