"""Primer scans over one sorted partition: rc index and range queries.

Counterparts of the JAX package's ``ops/reach.py`` ``_rc_index_kernel``,
``_fused_scan_kernel``, ``_panel_scan_kernel`` and ``range_scan_part``
(find_oligos_in_kmers semantics, upstream sharkmer
src/pcr/primers.rs:163-226):

* a forward hit is a table k-mer whose top 2*olen bits equal an oligo:
  the rows ``[searchsorted(lo), searchsorted(hi))`` of the sorted keys,
  with ``lo = oligo << shift`` and ``hi = (oligo + 1) << shift``;
* a reverse-strand hit is a k-mer whose revcomp starts with the oligo:
  the same range query against the partition's revcomp-sorted index,
  mapped back to table rows through the index's row order, and
  reported as revcomp(k-mer);
* a row hit both ways within one request reports the forward form only
  (forward precedence, deduplicated on ``(request << 40) | row``).

All of it is plain PyTorch: searchsorted, cumsum, sort and gathers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import phases
from .encoding import KMER_SENTINEL
from .histogram import revcomp
from .keys import SENTINEL, counts_to_numpy, keys_to_numpy

_BIG = (1 << 63) - 1


def rc_index(keys: torch.Tensor, k: int):
    """(revcomp(key) sorted ascending, original row) for one partition.
    Empty rows keep the sentinel and sort to the end."""
    rc_sorted, rc_order = torch.sort(revcomp(keys, k))
    return rc_sorted, rc_order


def _ranges(sorted_keys, lo, hi, valid, n_keys: int, req_ids, max_out: int):
    """The first ``max_out`` rows of the concatenated ranges
    ``[lo_i, hi_i)`` of ``sorted_keys[:n_keys]``, in oligo order, with
    the request of each (-1 past the end), and the true total."""
    s = torch.clamp(torch.searchsorted(sorted_keys, lo), max=n_keys)
    e = torch.clamp(torch.searchsorted(sorted_keys, hi), max=n_keys)
    e = torch.where(valid, e, s)
    lens = e - s
    offs = torch.cumsum(lens, 0)
    total = offs[-1]
    j = torch.arange(max_out, dtype=torch.int64, device=sorted_keys.device)
    seg = torch.clamp(torch.searchsorted(offs, j, right=True),
                      max=offs.shape[0] - 1)
    base = offs[seg] - lens[seg]
    row = s[seg] + (j - base)
    ok = j < total
    row = torch.where(ok, row, torch.full_like(row, -1))
    req = torch.where(ok, req_ids[seg], torch.full_like(row, -1))
    return row, req, total


def panel_scan(part_keys, part_counts, rc_sorted, rc_order, n_keys: int,
               oligos, shifts, req_ids, k: int, max_out: int):
    """Every primer scan of a panel over one partition.

    ``oligos`` [N] int64: concatenated per-request sorted oligos;
    ``shifts`` [N] int64: 2*(k - olen) per oligo; ``req_ids`` [N] int64:
    the owning request, -1 for padding.

    Returns (kmers [2*max_out] sentinel-padded, counts [2*max_out],
    reqs [2*max_out] with -1 for dead slots, totals [2]: the true
    forward and reverse match totals, for overflow detection).
    """
    valid = req_ids >= 0
    zero = torch.zeros_like(oligos)
    lo = torch.where(valid, oligos << shifts, zero)
    hi = torch.where(valid, (oligos + 1) << shifts, zero)

    fwd_rows, fwd_req, fwd_total = _ranges(
        part_keys, lo, hi, valid, n_keys, req_ids, max_out)
    rc_pos, rc_req, rc_total = _ranges(
        rc_sorted, lo, hi, valid, n_keys, req_ids, max_out)
    none = torch.full_like(rc_pos, -1)
    rc_rows = torch.where(rc_pos >= 0, rc_order[torch.clamp(rc_pos, min=0)],
                          none)
    # forward precedence per request: (req, row) packed into one int64
    fwd_pk = torch.where(fwd_rows >= 0, (fwd_req << 40) | fwd_rows,
                         torch.full_like(fwd_rows, _BIG))
    rc_pk = (rc_req << 40) | torch.clamp(rc_rows, min=0)
    fwd_sorted = torch.sort(fwd_pk).values
    idx = torch.clamp(torch.searchsorted(fwd_sorted, rc_pk), max=max_out - 1)
    dup = (fwd_sorted[idx] == rc_pk) & (rc_rows >= 0)
    rc_rows = torch.where(dup, none, rc_rows)
    rc_req = torch.where(dup, none, rc_req)

    safe_f = torch.clamp(fwd_rows, min=0)
    safe_r = torch.clamp(rc_rows, min=0)
    k_f = part_keys[safe_f]
    k_r = revcomp(part_keys[safe_r], k)
    sent = torch.full_like(k_f, SENTINEL)
    kmers = torch.cat([torch.where(fwd_rows >= 0, k_f, sent),
                       torch.where(rc_rows >= 0, k_r, sent)])
    nil = torch.zeros_like(k_f)
    counts = torch.cat([
        torch.where(fwd_rows >= 0, part_counts[safe_f], nil),
        torch.where(rc_rows >= 0, part_counts[safe_r], nil),
    ])
    reqs = torch.cat([fwd_req, rc_req])
    return kmers, counts, reqs, torch.stack([fwd_total, rc_total])


def range_scan_part(part_keys, part_counts, rc_sorted, rc_order, n: int,
                    oligos: np.ndarray, oligo_len: int, k: int,
                    max_out: int = 1 << 12):
    """One partition's matches for one oligo set, as numpy (kmers u64,
    counts u32) of all matched live rows; count filtering is the
    caller's. The scan is ``panel_scan`` with one request (the JAX
    package's ``_fused_scan_kernel``); ``max_out`` grows to the exact
    power of two needed when the matches overflow it."""
    device = part_keys.device
    width = max(64, 1 << max(len(oligos) - 1, 0).bit_length())
    padded = np.zeros(width, np.int64)
    padded[: len(oligos)] = np.sort(np.asarray(oligos, np.uint64))
    req = np.full(width, -1, np.int64)
    req[: len(oligos)] = 0
    with phases.sync("scan.upload", calls=2):
        oj = torch.from_numpy(padded).to(device)
        rj = torch.from_numpy(req).to(device)
    sj = torch.full((width,), 2 * (k - oligo_len), dtype=torch.int64,
                    device=device)
    while True:
        kmers, counts, _reqs, totals = panel_scan(
            part_keys, part_counts, rc_sorted, rc_order, n, oj, sj, rj, k,
            max_out,
        )
        with phases.sync("scan.total"):
            tot = int(totals.max())
        if tot <= max_out:
            break
        max_out = 1 << (tot - 1).bit_length()
    kh = keys_to_numpy(kmers)
    ch = counts_to_numpy(counts)
    # count-0 rows are ghost duplicates of a live key
    live = (kh != KMER_SENTINEL) & (ch > 0)
    return kh[live], ch[live]
