"""Path finding, sequence extraction, scoring, and dedup.

Reference: upstream sharkmer src/pcr/paths.rs. Coverage-weighted DFS
from each start node (children explored highest edge count first,
boosted by bubble edge preferences), node-count bounds derived from
min/max product length (N = len - k + 2), per-start caps on paths and
DFS states, per-path node visit cap (cycle tolerance). Sequences are
the start node's (k-1)-mer plus one base per subsequent node, scored
by the composite PathScore model (mod.rs:59-114), then sorted,
greedily deduplicated by bounded Levenshtein distance, and capped at
MAX_NUM_AMPLICONS.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass

from ..ops.encoding import kmer_last_base, kmer_to_seq
from ..utils.levenshtein import bounded_levenshtein
from .counts import FilteredTable
from .graph import DBGraph, compute_mean, compute_median
from .params import PCRParams

log = logging.getLogger("sharkmer")

MAX_NUM_AMPLICONS = 20


@dataclass
class PathScore:
    """Composite path quality score (mod.rs:59-114)."""

    kmer_min_count: int
    kmer_median_count: float
    coverage_cv: float
    max_coverage_ratio: float
    zero_support_edges: int | None = None
    median_unambiguous_support: float | None = None
    edge_support_fraction: float | None = None

    def composite(self) -> float:
        base = self.kmer_median_count
        cv_penalty = 1.0 / self.coverage_cv if self.coverage_cv > 1.0 else 1.0
        repeat_penalty = (
            5.0 / self.max_coverage_ratio if self.max_coverage_ratio > 5.0 else 1.0
        )
        if (
            self.zero_support_edges is not None
            and self.edge_support_fraction is not None
        ):
            zero_penalty = (
                0.5 ** min(self.zero_support_edges, 10)
                if self.zero_support_edges > 0
                else 1.0
            )
            support_bonus = max(self.edge_support_fraction, 0.1)
            read_support_factor = zero_penalty * support_bonus
        else:
            read_support_factor = 1.0
        return base * cv_penalty * repeat_penalty * read_support_factor


@dataclass
class AssemblyRecord:
    rec_id: str
    desc: str
    seq: str
    score: PathScore


# A path step: (node_id, edge_id or None for the start node)
PathStep = tuple[int, int | None]


def _sorted_children(
    graph: DBGraph, node: int, edge_preferences: dict[int, float] | None
) -> list[tuple[int, int, float]]:
    """Outgoing (target, edge_id, score) sorted ascending so pop()
    yields the highest score first (paths.rs:42-64). Children are
    collected in reverse insertion order to mirror petgraph's
    edge-list iteration, so score ties resolve identically."""
    outgoing = []
    for tgt, eid in reversed(list(graph.out_edges[node].items())):
        base_score = float(graph.edges[eid].count)
        pref = 1.0
        if edge_preferences is not None:
            pref = edge_preferences.get(eid, 1.0)
        outgoing.append((tgt, eid, base_score * pref))
    outgoing.sort(key=lambda t: t[2])
    return outgoing


def get_assembly_paths(
    graph: DBGraph,
    counts: FilteredTable,
    params: PCRParams,
    edge_preferences: dict[int, float] | None = None,
) -> list[list[PathStep]]:
    """Stack-based coverage-weighted DFS (paths.rs:78-186)."""
    k = counts.k
    min_path_nodes = 1 if params.min_length <= k else params.min_length - k + 2
    max_path_nodes = 1 if params.max_length <= k else params.max_length - k + 2

    end_nodes = set(graph.end_nodes())
    all_paths: list[list[PathStep]] = []

    for start in graph.start_nodes():
        paths_from_start = 0
        states_explored = 0

        path: list[PathStep] = [(start, None)]
        visit_counts: dict[int, int] = {start: 1}
        child_stack = [_sorted_children(graph, start, edge_preferences)]

        while True:
            if (
                paths_from_start >= params.max_paths_per_pair
                or states_explored >= params.max_dfs_states
            ):
                break
            depth = len(child_stack) - 1
            if child_stack[depth]:
                neighbor, edge_id, _score = child_stack[depth].pop()
                states_explored += 1
                if visit_counts.get(neighbor, 0) >= params.max_node_visits:
                    continue
                path.append((neighbor, edge_id))
                visit_counts[neighbor] = visit_counts.get(neighbor, 0) + 1
                path_len = len(path)

                if neighbor in end_nodes and path_len >= min_path_nodes:
                    all_paths.append(list(path))
                    paths_from_start += 1
                    visit_counts[neighbor] -= 1
                    path.pop()
                    continue
                if path_len >= max_path_nodes:
                    visit_counts[neighbor] -= 1
                    path.pop()
                    continue
                child_stack.append(
                    _sorted_children(graph, neighbor, edge_preferences)
                )
            else:
                child_stack.pop()
                if not child_stack:
                    break
                backtrack_node, _ = path.pop()
                visit_counts[backtrack_node] -= 1

    return all_paths


def generate_sequences_from_paths(
    graph: DBGraph,
    all_paths: list[list[PathStep]],
    counts: FilteredTable,
    sample_name: str,
    params: PCRParams,
    amplicon_index: int,
    threading_annotations=None,
) -> tuple[list[AssemblyRecord], int]:
    """Paths -> FASTA records with stats headers (paths.rs:190-356)."""
    records: list[AssemblyRecord] = []
    k = counts.k

    for path in all_paths:
        seq_parts: list[str] = []
        edge_counts: list[int] = []
        path_edges: list[int] = []
        for node, edge_opt in path:
            sub_kmer = graph.nodes[node].sub_kmer
            if not seq_parts:
                seq_parts.append(kmer_to_seq(sub_kmer, k - 1))
            else:
                seq_parts.append(kmer_last_base(sub_kmer))
                edge_counts.append(graph.edges[edge_opt].count)
                path_edges.append(edge_opt)
        sequence = "".join(seq_parts)

        if len(sequence) < params.min_length:
            log.debug(
                "  Path length is %d bp, shorter than min-length %d. Skipping.",
                len(sequence), params.min_length,
            )
            continue
        if not edge_counts:
            log.debug("  Path has no edges (single node). Skipping.")
            continue

        count_mean = compute_mean(edge_counts)
        count_median = compute_median(edge_counts)
        count_min = min(edge_counts)
        count_max = max(edge_counts)

        if count_mean > 0.0:
            variance = sum((c - count_mean) ** 2 for c in edge_counts) / len(
                edge_counts
            )
            coverage_cv = math.sqrt(variance) / count_mean
        else:
            coverage_cv = 0.0

        max_coverage_ratio = max(
            (graph.edges[eid].coverage_ratio for eid in path_edges), default=0.0
        )

        if threading_annotations is not None:
            total_edges = len(path_edges)
            supported = 0
            zero_count = 0
            unambiguous_counts: list[int] = []
            for eid in path_edges:
                s = threading_annotations.edge_support.get(eid)
                if s is not None and s.read_support_total > 0:
                    supported += 1
                    unambiguous_counts.append(s.read_support_unambiguous)
                else:
                    zero_count += 1
                    unambiguous_counts.append(0)
            frac = supported / total_edges if total_edges else 0.0
            median_unamb = (
                compute_median(unambiguous_counts) if unambiguous_counts else 0.0
            )
            zero_support_edges = zero_count
            median_unambiguous_support = median_unamb
            edge_support_fraction = frac
        else:
            zero_support_edges = None
            median_unambiguous_support = None
            edge_support_fraction = None

        score = PathScore(
            kmer_min_count=count_min,
            kmer_median_count=count_median,
            coverage_cv=coverage_cv,
            max_coverage_ratio=max_coverage_ratio,
            zero_support_edges=zero_support_edges,
            median_unambiguous_support=median_unambiguous_support,
            edge_support_fraction=edge_support_fraction,
        )

        rec_id = f"{sample_name}_{params.gene_name}_{amplicon_index}"
        desc = (
            f"sample={sample_name} gene={params.gene_name} "
            f"product={amplicon_index} length={len(sequence)} "
            f"kmer_count_mean={count_mean:.2f} kmer_count_median={count_median:g} "
            f"kmer_count_min={count_min} kmer_count_max={count_max} "
            f"score={score.composite():.2f}"
        )
        amplicon_index += 1
        records.append(AssemblyRecord(rec_id, desc, sequence, score))

    return records, amplicon_index


def sort_and_deduplicate(
    assembly_records: list[AssemblyRecord], params: PCRParams
) -> list[AssemblyRecord]:
    """Sort by composite desc (sequence-bytes tiebreak), greedy
    Levenshtein dedup, cap at MAX_NUM_AMPLICONS (paths.rs:360-427)."""
    sorted_records = sorted(
        assembly_records, key=lambda r: (-r.score.composite(), r.seq)
    )
    num_all = len(sorted_records)

    kept: list[AssemblyRecord] = []
    for record in sorted_records:
        is_duplicate = any(
            bounded_levenshtein(record.seq, kr.seq, params.dedup_edit_threshold)
            is not None
            for kr in kept
        )
        if not is_duplicate:
            kept.append(record)

    if num_all == len(kept):
        log.info(
            "[%s] %d PCR products were generated and retained.",
            params.gene_name, num_all,
        )
    else:
        log.info(
            "[%s] %d PCR products were generated and %d were retained "
            "(%d removed as near-duplicates within edit distance %d).",
            params.gene_name, num_all, len(kept), num_all - len(kept),
            params.dedup_edit_threshold,
        )

    if len(kept) > MAX_NUM_AMPLICONS:
        log.warning(
            "[%s] There are %d PCR products. This exceeds the maximum of %d. "
            "Retaining only the first %d records.",
            params.gene_name, len(kept), MAX_NUM_AMPLICONS, MAX_NUM_AMPLICONS,
        )
        kept = kept[:MAX_NUM_AMPLICONS]
    return kept
