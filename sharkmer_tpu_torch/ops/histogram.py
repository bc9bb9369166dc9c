"""Count-of-counts histograms and reverse complements on int64 keys.

Counterparts of the JAX package's ``ops/hashtable._histogram_kernel``
and ``_revcomp_kernel``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import phases
from .keys import SENTINEL


def histogram(counts: torch.Tensor, histo_max: int) -> np.ndarray:
    """Clipped count-of-counts of one count array, as numpy uint64.

    Index i = number of rows with count i, index histo_max+1 = number
    with count > histo_max (the folded tail). Index 0 is forced to 0:
    empty slots and the zero-count ghost rows of a fresh drain are not
    k-mers.
    """
    clipped = torch.clamp(counts, max=histo_max + 1)
    # on the card bincount reads its input's min and its max to the host
    with phases.sync("spectrum.bincount", calls=2):
        histo = torch.bincount(clipped, minlength=histo_max + 2)
    with phases.sync("spectrum.zero"):  # a host scalar copied up
        histo[0] = 0
    with phases.sync("spectrum.read"):
        histo = histo.cpu()
    return histo.numpy().astype(np.uint64)


def histogram_across(counts_list, histo_max: int) -> np.ndarray:
    """``histogram`` of count arrays that may lie on several devices: one
    clipped bincount a device (its arrays concatenated), summed on the
    host."""
    on: dict = {}
    for counts in counts_list:
        on.setdefault(counts.device, []).append(counts.reshape(-1))
    return np.sum([histogram(torch.cat(c), histo_max) for c in on.values()],
                  axis=0, dtype=np.uint64)


_M2 = 0x3333_3333_3333_3333  # 2-bit group swap mask
_M4 = 0x0F0F_0F0F_0F0F_0F0F
_M8 = 0x00FF_00FF_00FF_00FF
_M16 = 0x0000_FFFF_0000_FFFF
_M32 = 0x0000_0000_FFFF_FFFF


def revcomp(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of int64 k-mers (< 4^k); the sentinel stays.

    Complement is NOT (3-b == b^3 for 2-bit b); base reversal swaps
    2-bit groups, nibbles, bytes, half-words and words; a shift then
    lands the k bases in the low 2k bits. Each right shift is
    arithmetic on int64, and each swap mask has its top bits clear, so
    the sign bits it drags in are masked away.
    """
    x = ~keys
    x = ((x & _M2) << 2) | ((x >> 2) & _M2)
    x = ((x & _M4) << 4) | ((x >> 4) & _M4)
    x = ((x & _M8) << 8) | ((x >> 8) & _M8)
    x = ((x & _M16) << 16) | ((x >> 16) & _M16)
    x = ((x & _M32) << 32) | ((x >> 32) & _M32)
    x = (x >> (64 - 2 * k)) & ((1 << (2 * k)) - 1)
    return torch.where(keys == SENTINEL, keys, x)
