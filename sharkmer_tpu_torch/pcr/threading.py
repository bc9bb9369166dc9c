"""Read threading: annotate graph edges with read support.

Reference: upstream sharkmer src/pcr/threading.rs. Maps each read's
canonical k-mer stream onto graph edges via a canonical-kmer -> edge
lookup (keeping up to two candidates for inverted-repeat collisions),
finds maximal contiguous runs of adjacent edges, counts per-edge total
and unambiguous support, and records branch-point phasing links.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..io.records import Mate, ReadRecord
from ..ops.encoding import kmers_from_ascii_ref, revcomp_kmer
from .graph import DBGraph


@dataclass
class EdgeReadSupport:
    read_support_total: int = 0
    read_support_unambiguous: int = 0


@dataclass
class ThreadingAnnotations:
    edge_support: dict[int, EdgeReadSupport] = field(default_factory=dict)
    branch_links: dict[tuple[int, int], int] = field(default_factory=dict)
    paired_links: list[tuple[list[int], list[int]]] = field(default_factory=list)


def build_edge_lookup(graph: DBGraph, k: int) -> dict[int, list[int]]:
    """canonical kmer -> up to two candidate edge ids (threading.rs:203-220)."""
    lookup: dict[int, list[int]] = {}
    for eid in graph.edge_ids():
        kmer = graph.edge_kmer(eid)
        canonical = min(kmer, revcomp_kmer(kmer, k))
        lookup.setdefault(canonical, []).append(eid)
    return lookup


def _resolve_candidates(
    candidates: list[int], prev_edge: int | None, graph: DBGraph
) -> int:
    """Prefer the candidate adjacent to the previous edge (threading.rs:233-256)."""
    if len(candidates) == 1:
        return candidates[0]
    if prev_edge is not None:
        prev_target = graph.edges[prev_edge].tgt
        for cand in candidates:
            if graph.edges[cand].src == prev_target:
                return cand
    return candidates[0]


def find_contiguous_runs(
    kmers: list[int], edge_lookup: dict[int, list[int]], graph: DBGraph
) -> list[list[int]]:
    """Maximal runs of adjacent edges (threading.rs:261-315)."""
    runs: list[list[int]] = []
    current: list[int] = []
    for kmer in kmers:
        candidates = edge_lookup.get(kmer)
        if candidates is None:
            if current:
                runs.append(current)
                current = []
            continue
        eid = _resolve_candidates(candidates, current[-1] if current else None, graph)
        if current:
            prev_target = graph.edges[current[-1]].tgt
            if graph.edges[eid].src == prev_target:
                current.append(eid)
            else:
                runs.append(current)
                current = [eid]
        else:
            current.append(eid)
    if current:
        runs.append(current)
    return runs


def _is_run_unambiguous(graph: DBGraph, edges: list[int]) -> bool:
    """Every intermediate node has in/out degree <= 1 (threading.rs:321-337)."""
    if len(edges) < 2:
        return True
    for a in edges[:-1]:
        node = graph.edges[a].tgt
        if graph.in_degree(node) > 1 or graph.out_degree(node) > 1:
            return False
    return True


def _record_branch_links(
    graph: DBGraph, edges: list[int], branch_links: dict[tuple[int, int], int]
) -> None:
    """threading.rs:341-364."""
    for incoming, outgoing in zip(edges[:-1], edges[1:]):
        node = graph.edges[incoming].tgt
        if graph.in_degree(node) > 1 or graph.out_degree(node) > 1:
            key = (incoming, outgoing)
            branch_links[key] = branch_links.get(key, 0) + 1


def _annotate_runs(graph, runs, annotations):
    for run in runs:
        unambiguous = _is_run_unambiguous(graph, run)
        for eid in run:
            support = annotations.edge_support.setdefault(eid, EdgeReadSupport())
            support.read_support_total += 1
            if unambiguous:
                support.read_support_unambiguous += 1
        _record_branch_links(graph, run, annotations.branch_links)


def thread_reads(
    graph: DBGraph, reads: list[ReadRecord], k: int
) -> ThreadingAnnotations:
    """threading.rs:87-123."""
    annotations = ThreadingAnnotations()
    edge_lookup = build_edge_lookup(graph, k)
    for read in reads:
        try:
            kmers = kmers_from_ascii_ref(read.sequence, k)
        except ValueError:
            continue
        runs = find_contiguous_runs(kmers, edge_lookup, graph)
        _annotate_runs(graph, runs, annotations)
    return annotations


def thread_reads_paired(
    graph: DBGraph, reads: list[ReadRecord], k: int
) -> ThreadingAnnotations:
    """threading.rs:128-192 — adds paired-end links when both mates map."""
    annotations = ThreadingAnnotations()
    edge_lookup = build_edge_lookup(graph, k)
    pair_runs: dict[int, tuple[list[int], list[int]]] = {}

    for read in reads:
        try:
            kmers = kmers_from_ascii_ref(read.sequence, k)
        except ValueError:
            continue
        runs = find_contiguous_runs(kmers, edge_lookup, graph)
        all_edges: list[int] = []
        for run in runs:
            all_edges.extend(run)
        _annotate_runs(graph, runs, annotations)
        if all_edges and read.mate != Mate.UNPAIRED:
            pair_idx = read.index // 2
            entry = pair_runs.setdefault(pair_idx, ([], []))
            if read.mate == Mate.R1:
                pair_runs[pair_idx] = (all_edges, entry[1])
            else:
                pair_runs[pair_idx] = (entry[0], all_edges)

    for r1_edges, r2_edges in pair_runs.values():
        if r1_edges and r2_edges:
            annotations.paired_links.append((r1_edges, r2_edges))
    return annotations
