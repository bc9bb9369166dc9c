"""Plain reference of the count table and its spectra.

It is handed the same code batches as the program and recounts them
itself with plain ``torch`` operations: canonical k-mers by shifts, then,
in slabs of the key range, a sort and ``unique_consecutive``. Reads go
to chunks as upstream sharkmer assigns them (io.rs:355-361): read ``i``
to chunk ``(i // 1000) % n_chunks``; snapshot ``c`` is the spectrum of
the reads of chunks ``0..c``. A rewrite of the idea of the port's
``chip_smoke.chunk_spectra_reference``; it imports nothing of the port.

``compare`` holds the program's table (sorted keys and their counts) and
each unit's snapshots to this recount. ``table`` gives the recount,
optionally with its counts held in a narrower field (``count_cap``): the
control, which breaks the configuration's guarantee of exact counts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

READS_PER_TURN = 1000  # the reads a chunk takes in turn (io.rs:355-361)
SLABS = 4  # key ranges recounted one at a time (bounds device memory)
CHUNK_BITS = 4  # a chunk index packed below a key (n_chunks <= 16)


def canonical(codes: torch.Tensor, k: int):
    """int64 canonical k-mers of ``[n, width]`` codes and the mask of
    windows whose k bases are all A, C, G or T (codes 0..3)."""
    n, width = codes.shape
    w = width - k + 1
    fwd = torch.zeros((n, w), dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    ok = torch.ones((n, w), dtype=torch.bool, device=codes.device)
    for j in range(k):
        c = codes[:, j : j + w]
        ok &= c < 4
        b = c.to(torch.int64) & 3
        fwd = (fwd << 2) | b
        rev |= (3 - b) << (2 * j)
    return torch.minimum(fwd, rev), ok


def spectrum(counts: torch.Tensor, histo_max: int) -> np.ndarray:
    """Keys by count: index i the keys counted i times, the last index
    those counted more than ``histo_max`` times, index 0 nothing."""
    h = torch.bincount(torch.clamp(counts, max=histo_max + 1),
                       minlength=histo_max + 2)
    h[0] = 0
    return h.cpu().numpy().astype(np.uint64)


def _events(codes: np.ndarray, batch_reads: int, k: int, n_chunks: int,
            device) -> torch.Tensor:
    """Every valid k-mer of the reads on ``device``, the read's chunk
    packed below it where there are several chunks."""
    if 2 * k + CHUNK_BITS > 63 or n_chunks > 1 << CHUNK_BITS:
        raise ValueError(f"k={k} with {n_chunks} chunks does not pack")
    out = []
    for lo in range(0, codes.shape[0], batch_reads):
        batch = torch.from_numpy(codes[lo : lo + batch_reads]).to(device)
        keys, ok = canonical(batch, k)
        if n_chunks > 1:
            reads = torch.arange(lo, lo + batch.shape[0], device=device)
            chunk = (reads // READS_PER_TURN) % n_chunks
            keys = (keys << CHUNK_BITS) | chunk[:, None]
        out.append(keys[ok])
        del batch, keys, ok
    return torch.cat(out)


def _bounds(k: int) -> list[int]:
    """Slab edges of equal expected mass: a canonical key of uniform
    bases is the lesser of two uniform keys, P(key < t) = 1 - (1-t/M)^2."""
    m = 4 ** k
    return ([0] + [int(m * (1 - math.sqrt(1 - s / SLABS)))
                   for s in range(1, SLABS)] + [m])


def slabs(codes, batch_reads: int, k: int, n_chunks: int, histo_max: int,
          device):
    """Per key-range slab: (lo, hi, keys, final counts, one spectrum a
    snapshot). Snapshots: one per chunk; one where ``n_chunks`` is 1;
    none where it is 0."""
    events = _events(codes, batch_reads, k, n_chunks, device)
    shift = CHUNK_BITS if n_chunks > 1 else 0
    b = _bounds(k)
    for lo, hi in zip(b[:-1], b[1:]):
        key = events >> shift
        sel = torch.sort(events[(key >= lo) & (key < hi)]).values
        del key
        spectra = []
        if n_chunks > 1:
            for c in range(n_chunks):
                mine = sel[(sel & ((1 << CHUNK_BITS) - 1)) <= c] >> CHUNK_BITS
                spectra.append(spectrum(
                    torch.unique_consecutive(mine, return_counts=True)[1],
                    histo_max))
                del mine
            sel = sel >> CHUNK_BITS
        keys, counts = torch.unique_consecutive(sel, return_counts=True)
        del sel
        if n_chunks == 1:
            spectra.append(spectrum(counts, histo_max))
        yield lo, hi, keys, counts, spectra
    del events


def table(codes, batch_reads: int, k: int, n_chunks: int, histo_max: int,
          device, count_cap: int | None = None):
    """The recount as (sorted keys, counts) on ``device`` and the
    snapshots' spectra; with ``count_cap`` every count (and every
    snapshot's) held at most ``count_cap``."""
    keys, counts, spectra = [], [], None
    for _lo, _hi, k_, c_, sp in slabs(codes, batch_reads, k, n_chunks,
                                      histo_max, device):
        if count_cap is not None:
            c_ = torch.clamp(c_, max=count_cap)
            sp = [capped(s, count_cap) for s in sp]
        keys.append(k_)
        counts.append(c_)
        spectra = sp if spectra is None else [a + s for a, s in
                                              zip(spectra, sp)]
    return torch.cat(keys), torch.cat(counts), spectra or []


def capped(spectrum_: np.ndarray, cap: int) -> np.ndarray:
    """A spectrum with the keys counted more than ``cap`` times moved to
    ``cap``."""
    out = spectrum_.copy()
    if cap + 1 < len(out):
        out[cap] += out[cap + 1 :].sum()
        out[cap + 1 :] = 0
    return out


def _missing(a_k, a_c, b_k, b_c) -> int:
    """Keys of (a_k, a_c) absent from b_k or, where ``b_c`` is given,
    counted otherwise there."""
    if not a_k.numel():
        return 0
    if not b_k.numel():
        return int(a_k.numel())
    idx = torch.clamp(torch.searchsorted(b_k, a_k), max=b_k.numel() - 1)
    hit = b_k[idx] == a_k
    wrong = (~hit).sum()
    if b_c is not None:
        wrong = wrong + (hit & (b_c[idx] != a_c)).sum()
    return int(wrong)


def compare(codes, batch_reads: int, k: int, n_chunks: int, histo_max: int,
            device, keys: torch.Tensor, counts: torch.Tensor,
            unit_spectra: list) -> dict:
    """The numbers a run is judged by, each exact, from the program's
    table as sorted int64 ``keys`` and their ``counts`` on ``device`` and
    each unit's snapshots:

    * ``keys_wrong``: keys of the program's table or of the recount that
      the other lacks or counts otherwise;
    * ``spectra_bins_wrong``: bins of every unit's snapshots that differ
      from the recount's, over all units (a missing or extra snapshot
      counts all its bins); ``bins_by_unit`` has each unit's.
    """
    wrong = 0
    ref_spectra = None
    for lo, hi, r_k, r_c, sp in slabs(codes, batch_reads, k, n_chunks,
                                      histo_max, device):
        edges = torch.tensor([lo, hi], dtype=torch.int64, device=device)
        a, b = torch.searchsorted(keys, edges).tolist()
        p_k, p_c = keys[a:b], counts[a:b]
        wrong += _missing(r_k, r_c, p_k, p_c) + _missing(p_k, None, r_k, None)
        ref_spectra = sp if ref_spectra is None else [
            x + y for x, y in zip(ref_spectra, sp)]
        del p_k, p_c, r_k, r_c
    ref_spectra = ref_spectra or []
    by_unit = []
    for spectra in unit_spectra:
        spectra = list(spectra or [])
        bins = 0
        for i in range(max(len(spectra), len(ref_spectra))):
            if i >= len(spectra) or i >= len(ref_spectra):
                bins += histo_max + 2
            else:
                bins += int(np.sum(np.asarray(spectra[i], np.uint64)
                                   != ref_spectra[i]))
        by_unit.append(bins)
    return {"keys_wrong": wrong, "spectra_bins_wrong": sum(by_unit),
            "bins_by_unit": by_unit}
