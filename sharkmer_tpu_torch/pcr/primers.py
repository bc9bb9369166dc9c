"""Primer preprocessing: IUPAC expansion, mismatch permutation, and
discovery of primer-matching k-mers in the count table.

Reference: upstream sharkmer src/pcr/primers.rs. The full-table scan
(find_oligos_in_kmers, primers.rs:163-226) is replaced by the device
``KmerTable.prefix_scan`` — a single sweep over the table keys with
searchsorted set-membership against the (sorted) oligo array, matching
the oligo at the k-mer START in forward orientation or the reverse
complement at the low bits (RC hits are reported revcomp-normalized).
"""

from __future__ import annotations

import itertools
import logging

import numpy as np

from .counts import FilteredTable, SmallCounts
from .params import IUPAC, PCRParams

log = logging.getLogger("sharkmer")

FORWARD, REVERSE = "forward", "reverse"
MAX_RESOLVED_VARIANTS = 10_000


_BASE_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def string_to_oligo(seq: str) -> tuple[int, int]:
    """ACGT string -> (packed u64, length). primers.rs:33-54."""
    if len(seq) > 32:
        raise ValueError(
            f"Oligo sequence length {len(seq)} exceeds maximum of 32 bases"
        )
    kmer = 0
    code = _BASE_CODE
    try:
        for c in seq:
            kmer = (kmer << 2) | code[c]
    except KeyError as e:
        raise ValueError(f"Invalid nucleotide {e.args[0]} in {seq}") from None
    return kmer, len(seq)


def resolve_primer(primer: str) -> set[str]:
    """Expand IUPAC ambiguity codes into all concrete sequences."""
    pools = [IUPAC.get(c, c) for c in primer]
    return {"".join(p) for p in itertools.product(*pools)} if primer else set()


def combinations(n: int, r: int) -> list[list[int]]:
    if r > n:
        return []
    return [list(c) for c in itertools.combinations(range(n), r)]


def permute_sequences(sequences: set[str], r: int) -> set[str]:
    """All sequences within <= r substitutions of any input (includes
    the originals). primers.rs:101-158."""
    out: set[str] = set()
    for seq in sequences:
        for positions in itertools.combinations(range(len(seq)), r):
            chars = list(seq)
            for subs in itertools.product("ATCG", repeat=len(positions)):
                for pos, c in zip(positions, subs):
                    chars[pos] = c
                out.add("".join(chars))
        if r == 0:
            out.add(seq)
    return out


def preprocess_primer_by_mismatch(
    params: PCRParams, direction: str, k: int
) -> list[set[str]]:
    """Variants grouped by mismatch level; level m holds only the NEW
    variants introduced at m mismatches (primers.rs:234-314)."""
    primer = params.reverse_seq if direction == REVERSE else params.forward_seq

    trim = params.trim
    if trim >= k:
        log.warning(
            "[%s] Trim length (%d) must be less than k (%d); adjusting trim "
            "to k-1 = %d",
            params.gene_name, trim, k, k - 1,
        )
        trim = k - 1

    if len(primer) > trim:
        primer = primer[len(primer) - trim :]
        log.info(
            "[%s] Trimming the primer to %s so that it is within the trim "
            "length of %d.",
            params.gene_name, primer, trim,
        )

    base_variants = resolve_primer(primer)
    if len(base_variants) > MAX_RESOLVED_VARIANTS:
        raise ValueError(
            f"Primer {primer} has too many ambiguous bases: "
            f"{len(base_variants)} resolved variants exceeds limit of "
            f"{MAX_RESOLVED_VARIANTS}. Reduce ambiguity or use a more "
            f"specific primer."
        )

    mismatches = min(params.mismatches, len(primer))
    levels: list[set[str]] = [set(base_variants)]
    seen: set[str] = set(base_variants)
    for _ in range(1, mismatches + 1):
        all_up_to = permute_sequences(seen, 1)
        new = all_up_to - seen
        seen |= new
        levels.append(new)
    return levels


def variants_to_oligos(variants: set[str]) -> tuple[np.ndarray, int]:
    """Concrete variant strings -> (sorted unique u64 array, length).
    Shared by the per-gene scan path and warm_panel_scans so the two
    construct byte-identical cache keys."""
    oligos = []
    length = None
    for v in variants:
        kmer, olen = string_to_oligo(v)
        if length is None:
            length = olen
        elif olen != length:
            raise ValueError("primer variants must share a length")
        oligos.append(kmer)
    return np.array(sorted(set(oligos)), np.uint64), length


def warm_panel_scans(counts: FilteredTable, runs: list[PCRParams]) -> None:
    """Pre-fetch every (gene, primer, mismatch level) scan of the panel
    in ONE batched device dispatch (prefix_scan_many) before the gene
    pool starts. Each request keeps its own per-scan semantics — this
    only moves the per-dispatch latency off the per-gene path.
    Backends without prefix_scan_many (hash table) scan lazily."""
    scan_many = getattr(counts.table, "prefix_scan_many", None)
    if scan_many is None:
        return
    requests, keys = [], []
    seen = set()
    for params in runs:
        for direction in (FORWARD, REVERSE):
            try:
                levels = preprocess_primer_by_mismatch(
                    params, direction, counts.k
                )
            except ValueError:
                continue  # the gene's own path reports the error
            for variants in levels:
                if not variants:
                    continue
                try:
                    arr, olen = variants_to_oligos(variants)
                except ValueError:
                    continue
                if olen <= 0 or olen >= counts.k:
                    continue
                key = (olen, arr.tobytes())
                if key in seen:
                    continue
                seen.add(key)
                requests.append((arr, olen))
                keys.append(key)
    if not requests:
        return
    results = scan_many(requests)
    counts._scan_cache.update(dict(zip(keys, results)))


def get_kmers_from_primers(
    variants: set[str], counts: FilteredTable, min_count: int
) -> SmallCounts:
    """K-mers in the table that start with any variant (either strand)."""
    if not variants:
        return SmallCounts(counts.k)
    oligos_arr, length = variants_to_oligos(variants)
    if length <= 0 or length >= counts.k:
        raise ValueError(
            f"oligo length {length} out of range for k={counts.k}"
        )
    kmers, cts = counts.find_primer_matches(
        oligos_arr, length, min_count
    )
    result = SmallCounts(counts.k)
    for km, c in zip(kmers.tolist(), cts.tolist()):
        result.insert(km, c)
    return result


def filter_primer_kmers(matches: SmallCounts, max_primer_kmers: int) -> SmallCounts:
    """Hard cap: count DESC, kmer ASC tiebreak (primers.rs:347-369)."""
    if len(matches) <= max_primer_kmers:
        return matches
    entries = sorted(matches.items(), key=lambda kv: (-kv[1], kv[0]))
    return SmallCounts(matches.k, dict(entries[:max_primer_kmers]))


def discover_primer_kmers_by_round(
    variant_levels: list[set[str]],
    counts: FilteredTable,
    min_count: int,
    max_primer_kmers: int,
    gene_name: str,
) -> SmallCounts:
    """Fill the cap lowest-mismatch-level first; within a level sort by
    count DESC then kmer ASC (primers.rs:375-438)."""
    result = SmallCounts(counts.k)
    for level, variants in enumerate(variant_levels):
        if len(result) >= max_primer_kmers:
            break
        if not variants:
            continue
        round_kmers = get_kmers_from_primers(variants, counts, min_count)
        new_entries = [
            (km, c) for km, c in round_kmers.items() if result.get(km) is None
        ]
        if not new_entries:
            continue
        new_entries.sort(key=lambda kv: (-kv[1], kv[0]))
        remaining = max_primer_kmers - len(result)
        take = min(len(new_entries), remaining)
        for km, c in new_entries[:take]:
            result.insert(km, c)
        log.info(
            "[%s] Mismatch level %d: %d new primer kmers (%d total, cap %d)",
            gene_name, level, take, len(result), max_primer_kmers,
        )
        if len(new_entries) > take:
            log.info(
                "[%s] Mismatch level %d: dropped %d kmers at cap",
                gene_name, level, len(new_entries) - take,
            )
    return result


def get_primer_kmers(
    params: PCRParams, counts: FilteredTable
) -> tuple[SmallCounts, SmallCounts]:
    """Seed k-mer sets for both primers (primers.rs:440-476)."""
    fwd_levels = preprocess_primer_by_mismatch(params, FORWARD, counts.k)
    rev_levels = preprocess_primer_by_mismatch(params, REVERSE, counts.k)

    log.info("[%s] Searching kmers that contain the forward primer variants",
             params.gene_name)
    fwd = discover_primer_kmers_by_round(
        fwd_levels, counts, params.min_count, params.max_primer_kmers,
        params.gene_name,
    )
    log.info("[%s] Searching kmers that contain the reverse primer variants",
             params.gene_name)
    rev = discover_primer_kmers_by_round(
        rev_levels, counts, params.min_count, params.max_primer_kmers,
        params.gene_name,
    )
    return fwd, rev
