"""2-bit DNA encoding and canonical k-mer extraction (torch port).

Semantics match the JAX package's ``sharkmer_tpu.ops.encoding``:

* A=00, C=01, G=10, T=11; a k-mer occupies the low 2k bits of a word.
* The canonical form of a k-mer is ``min(kmer, revcomp(kmer))``.
* ``N`` splits the sequence: no window spanning an N emits a k-mer.
* k must be in 1..=31.

The numpy helpers are copied verbatim. ``canonical_kmers_plain`` is
written in torch: each output position is the OR of k shifted slices of
the code array (k elementwise passes over the whole batch, no sequential
scan), then the canonical min and the N/pad validity mask. It is the CPU
path and the oracle of the hand-written kernel
(``kernels/encode.encode``, ``csrc/encode.cu``), which
``canonical_kmers`` launches on a CUDA tensor, with no fallback. Keys
are int64 on the device (``ops/keys.py``); an invalid window holds the
device sentinel.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

BASE_A, BASE_C, BASE_G, BASE_T = 0, 1, 2, 3
CODE_N = 4  # splits windows, counts as invalid
CODE_PAD = 5  # right-padding of fixed-width batches, invalid
KMER_SENTINEL = np.uint64(0xFFFF_FFFF_FFFF_FFFF)  # impossible k-mer (k <= 31)

_ASCII_TO_CODE = np.full(256, 255, dtype=np.uint8)
_ASCII_TO_CODE[ord("A")] = BASE_A
_ASCII_TO_CODE[ord("C")] = BASE_C
_ASCII_TO_CODE[ord("G")] = BASE_G
_ASCII_TO_CODE[ord("T")] = BASE_T
_ASCII_TO_CODE[ord("N")] = CODE_N

_CODE_TO_BASE = "ACGTN"


def _check_k(k: int) -> None:
    if not (0 < k < 32):
        raise ValueError(f"k must be between 1 and 31, got {k}")


def ascii_to_codes(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes (A/C/G/T -> 0..3, N -> 4).

    Raises ValueError on characters outside ACGTN, matching the
    reference's error behaviour (encoding.rs:353-357).
    """
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    codes = _ASCII_TO_CODE[raw]
    if codes.max(initial=0) == 255:
        bad = chr(raw[int(np.argmax(codes == 255))])
        raise ValueError(
            f"Invalid character '{bad}' in sequence. Only ACGTN allowed."
        )
    return codes


def codes_to_batch(seqs: list[np.ndarray], width: int | None = None) -> np.ndarray:
    """Stack variable-length code arrays into a right-padded [n, width] batch."""
    if width is None:
        width = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), width), CODE_PAD, dtype=np.uint8)
    for i, s in enumerate(seqs):
        if len(s) > width:
            raise ValueError(f"sequence of length {len(s)} exceeds batch width {width}")
        out[i, : len(s)] = s
    return out




def canonical_kmers(codes: torch.Tensor, k: int,
                    totals: torch.Tensor | None = None) -> torch.Tensor:
    """Extract canonical k-mers from a fixed-width code batch.

    Args:
      codes: uint8 tensor [n_reads, width] with values 0..3 (bases),
        4 (N) or 5 (pad), on the device the k-mers are wanted on.
      k: k-mer length, 1..31.
      totals: int64 [2] on the codes' device, or None. Where given, the
        batch's valid windows are added into ``totals[0]`` and its codes
        below ``CODE_N`` into ``totals[1]``, on the device.

    Returns:
      int64 [n_reads, width-k+1] canonical k-mers; a window that holds a
      code of 4 or 5 holds ``keys.SENTINEL`` (no k-mer is the sentinel,
      so ``kmers != SENTINEL`` is the valid mask). One kernel launch on a
      CUDA tensor, the plain version on a CPU tensor.
    """
    if codes.device.type == "cpu":
        kmers, valid = canonical_kmers_plain(codes, k)
        if totals is not None:
            totals += torch.stack([valid.sum(), (codes < CODE_N).sum()])
        return kmers
    from ..kernels.encode import encode

    return encode(codes.contiguous(), k, totals)


def canonical_kmers_plain(codes: torch.Tensor, k: int):
    """``canonical_kmers`` in plain torch, on any device: the CPU path and
    the kernel's oracle. Returns ``(kmers, valid)``, as the JAX package's
    ``canonical_kmers`` does: the k-mers and the bool mask of windows that
    hold only real bases, each computed on its own."""
    from .keys import SENTINEL

    _check_k(k)
    n, width = codes.shape
    w = width - k + 1
    if w <= 0:
        return (
            torch.full((n, 0), SENTINEL, dtype=torch.int64, device=codes.device),
            torch.zeros((n, 0), dtype=torch.bool, device=codes.device),
        )
    bases = (codes & 3).to(torch.int64)
    fwd = torch.zeros((n, w), dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    invalid = torch.zeros((n, w), dtype=torch.uint8, device=codes.device)
    for j in range(k):
        invalid |= codes[:, j : j + w] >> 2  # codes 4/5 set a bit, 0..3 don't
        c = bases[:, j : j + w]
        # forward frame: base j at bit 2*(k-1-j); reverse frame: the
        # complemented base j at bit 2*j
        fwd |= c << (2 * (k - 1 - j))
        rev |= (c ^ 3) << (2 * j)
    valid = invalid == 0
    canon = torch.minimum(fwd, rev)
    canon = torch.where(valid, canon, torch.full_like(canon, SENTINEL))
    return canon, valid


# ---------------------------------------------------------------------------
# Pure-python reference + host-side helpers (primer preprocessing, output)
# ---------------------------------------------------------------------------

def kmers_from_ascii_ref(seq: str, k: int) -> list[int]:
    """Rolling-frame reference encoder; mirrors encoding.rs:332-371 exactly.

    Kept permanently for cross-check tests against ``canonical_kmers``.
    """
    _check_k(k)
    mask = (1 << (2 * k)) - 1
    kmers: list[int] = []
    frame = 0
    revframe = 0
    n_valid = 0
    for ch in seq:
        if ch == "N":
            frame = 0
            revframe = 0
            n_valid = 0
            continue
        try:
            base = "ACGT".index(ch)
        except ValueError:
            raise ValueError(
                f"Invalid character '{ch}' in sequence. Only ACGTN allowed."
            ) from None
        frame = ((frame << 2) | base) & ((1 << 64) - 1)
        revframe = (revframe >> 2) | ((3 - base) << (2 * (k - 1)))
        n_valid += 1
        if n_valid >= k:
            kmers.append(min(frame & mask, revframe & mask))
    return kmers


# byte LUT: reverse-complement of the 4 bases packed in one byte
# (matches the reference's REVCOMP_BYTE_LUT, encoding.rs:219-233)
_REVCOMP_BYTE_LUT = np.empty(256, dtype=np.uint8)
for _i in range(256):
    _b0, _b1, _b2, _b3 = _i & 3, (_i >> 2) & 3, (_i >> 4) & 3, (_i >> 6) & 3
    _REVCOMP_BYTE_LUT[_i] = (
        ((3 - _b0) << 6) | ((3 - _b1) << 4) | ((3 - _b2) << 2) | (3 - _b3)
    )


def revcomp_kmers_np_lut(kmers: np.ndarray, k: int) -> np.ndarray:
    """Byte-LUT reverse complement (the reference's REVCOMP_BYTE_LUT
    strategy, encoding.rs:219-233). Kept as the differential oracle for
    the bit-twiddling fast path below."""
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
    b = kmers.view(np.uint8).reshape(-1, 8)
    if sys.byteorder != "little":  # pragma: no cover
        b = b[:, ::-1]
    rc_b = _REVCOMP_BYTE_LUT[b][:, ::-1]
    if sys.byteorder != "little":  # pragma: no cover
        rc_b = rc_b[:, ::-1]
    rc = np.ascontiguousarray(rc_b).view(np.uint64).reshape(kmers.shape)
    return rc >> np.uint64(64 - 2 * k)


_M2 = np.uint64(0x3333_3333_3333_3333)  # 2-bit group swap mask
_M4 = np.uint64(0x0F0F_0F0F_0F0F_0F0F)  # nibble swap mask


def revcomp_kmers_np(kmers: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement of packed k-mers (numpy, host).

    Pure u64 bit arithmetic — ~10x the byte-LUT version, which pays a
    gather per byte: complement is XOR with all-ones (3-b == b^3 for
    2-bit b), base reversal is two swap stages plus a byteswap, then a
    shift lands the k bases in the low 2k bits. The hot callers are the
    sPCR mirror build (tens of millions of keys) and per-wave candidate
    canonicalization.
    """
    x = ~np.ascontiguousarray(kmers, dtype=np.uint64)  # complement bases
    x = ((x & _M2) << np.uint64(2)) | ((x >> np.uint64(2)) & _M2)
    x = ((x & _M4) << np.uint64(4)) | ((x >> np.uint64(4)) & _M4)
    x = x.byteswap()  # reverse bytes -> full 2-bit-group reversal
    return x >> np.uint64(64 - 2 * k)


def revcomp_kmer(kmer: int, k: int) -> int:
    """Reverse complement of a 2-bit packed k-mer (host python int)."""
    out = 0
    for i in range(k):
        base = (kmer >> (2 * i)) & 3
        out = (out << 2) | (3 - base)
    return out & ((1 << (2 * k)) - 1)


def kmer_to_seq(kmer: int, k: int) -> str:
    return "".join(
        _CODE_TO_BASE[(kmer >> (2 * (k - 1 - i))) & 3] for i in range(k)
    )


def seq_to_kmer(seq: str) -> int:
    kmer = 0
    for ch in seq:
        kmer = (kmer << 2) | "ACGT".index(ch)
    return kmer


def kmer_last_base(kmer: int) -> str:
    return _CODE_TO_BASE[kmer & 3]


def count_valid_bases(seq: str) -> int:
    """Number of non-N bases (encoding.rs:374-376)."""
    return sum(1 for c in seq if c != "N")
