"""The key codec between numpy ``uint64`` and torch ``int64``.

PyTorch has no usable unsigned 64-bit integer on the CPU (no shifts,
compares, max or searchsorted), so the port keeps every key in int64
on the device:

* a canonical k-mer is < 2^62 (k <= 31), so its bit pattern is the
  same non-negative int64 and keeps its order;
* ``KMER_SENTINEL`` (all ones, the empty slot) becomes ``SENTINEL`` =
  INT64_MAX on the device, so it still sorts after every key, and maps
  back to all ones at the numpy boundary;
* packed ``(key << (64-2k)) | count`` words use the top bit; they are
  stored XOR ``BIAS`` (1 << 63), so that signed order equals the
  unsigned order of the word, and are unbiased before any shift. The
  all-ones packed sentinel biases to INT64_MAX as well;
* counts are int64 on the device, saturated explicitly at
  ``COUNT_MAX`` (the u32 maximum), and uint32 at the numpy boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import phases
from .encoding import KMER_SENTINEL

SENTINEL = (1 << 63) - 1  # the device form of KMER_SENTINEL
BIAS = -(1 << 63)  # XOR-ing this flips the top bit
COUNT_MAX = 0xFFFF_FFFF


def keys_to_device(keys, device) -> torch.Tensor:
    """numpy uint64 keys (KMER_SENTINEL for empty) -> int64 tensor."""
    arr = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64)).reshape(-1)
    t = torch.from_numpy(arr.view(np.int64).copy())
    t[t == -1] = SENTINEL
    with phases.sync("keys.upload"):
        return t.to(device)


def keys_to_numpy(keys: torch.Tensor) -> np.ndarray:
    """int64 key tensor -> numpy uint64 with KMER_SENTINEL restored."""
    with phases.sync("keys.read"):
        host = keys.detach().cpu()
    arr = host.numpy().astype(np.int64, copy=True)
    arr = arr.view(np.uint64)
    arr[arr == np.uint64(SENTINEL)] = KMER_SENTINEL
    return arr


def counts_to_device(counts, device) -> torch.Tensor:
    arr = np.asarray(counts, dtype=np.uint32).reshape(-1)
    with phases.sync("counts.upload"):
        return torch.from_numpy(arr.astype(np.int64)).to(device)


def counts_to_numpy(counts: torch.Tensor) -> np.ndarray:
    with phases.sync("counts.read"):
        host = counts.detach().cpu()
    return host.numpy().astype(np.uint32)


def pack(keys: torch.Tensor, counts: torch.Tensor, shift: int,
         keep: torch.Tensor) -> torch.Tensor:
    """Biased ``(key << shift) | count`` words; rows not kept become the
    biased all-ones sentinel (INT64_MAX), which sorts last."""
    word = ((keys << shift) | counts) ^ BIAS
    return torch.where(keep, word, torch.full_like(word, SENTINEL))


def unpack(words: torch.Tensor, shift: int):
    """Inverse of ``pack`` on sorted words: (keys, counts) with the
    sentinel rows as (SENTINEL, 0)."""
    sent = words == SENTINEL
    raw = words ^ BIAS
    # arithmetic shift: mask away the sign extension of the top bit
    keys = (raw >> shift) & ((1 << (64 - shift)) - 1)
    counts = raw & ((1 << shift) - 1)
    keys = torch.where(sent, torch.full_like(keys, SENTINEL), keys)
    counts = torch.where(sent, torch.zeros_like(counts), counts)
    return keys, counts
