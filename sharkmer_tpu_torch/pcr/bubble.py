"""Read-aware bubble detection and resolution.

Reference: upstream sharkmer src/pcr/bubble.rs. Simple bubbles (diverge
at one node, converge within MAX_BUBBLE_DEPTH along linear branches)
are ranked by read support + branch phasing, producing DFS edge
preferences (best branch 1.0, others support/max). Depth-limited and
cyclic branches are discarded, and support ties break on the
content-derived kmer of the branch's first edge.
"""

from __future__ import annotations

from dataclasses import dataclass

from .graph import DBGraph
from .threading import ThreadingAnnotations

MAX_BUBBLE_DEPTH = 50


@dataclass
class Bubble:
    source: int
    sink: int
    branches: list[list[int]]


def detect_simple_bubbles(graph: DBGraph) -> list[Bubble]:
    """bubble.rs:101-184."""
    bubbles: list[Bubble] = []
    for source in graph.node_ids():
        outgoing = list(graph.out_edges[source].items())  # (tgt, eid)
        if len(outgoing) < 2:
            continue

        branch_endpoints: dict[int, list[list[int]]] = {}
        for tgt, first_edge in outgoing:
            current = tgt
            branch_edges = [first_edge]
            visited = {source}
            depth = 0
            terminated_naturally = False
            while True:
                if depth >= MAX_BUBBLE_DEPTH:
                    break
                depth += 1
                if current in visited:
                    break  # cycle
                visited.add(current)
                nxt = list(graph.out_edges[current].items())
                if len(nxt) == 1:
                    branch_edges.append(nxt[0][1])
                    current = nxt[0][0]
                else:
                    terminated_naturally = True
                    break
            if terminated_naturally:
                branch_endpoints.setdefault(current, []).append(branch_edges)

        for sink, branches in branch_endpoints.items():
            if len(branches) >= 2 and sink != source:
                bubbles.append(Bubble(source, sink, branches))
    return bubbles


def _branch_sort_key(graph: DBGraph, edges: list[int]) -> int:
    """Content-derived deterministic tiebreak (bubble.rs:266-275)."""
    if not edges:
        return 0
    e = graph.edges[edges[0]]
    return (graph.nodes[e.src].sub_kmer << 2) | (graph.nodes[e.tgt].sub_kmer & 3)


def rank_branches(
    graph: DBGraph, bubble: Bubble, annotations: ThreadingAnnotations
) -> list[tuple[list[int], int, int]]:
    """Branches ranked by (read support + phasing) desc (bubble.rs:187-255).
    Returns (edges, total_read_support, phasing_support) tuples."""
    rankings = []
    for branch_edges in bubble.branches:
        total_read_support = sum(
            annotations.edge_support.get(eid, None).read_support_total
            if annotations.edge_support.get(eid) is not None
            else 0
            for eid in branch_edges
        )
        phasing = 0
        if branch_edges:
            first_edge = branch_edges[0]
            for _, incoming in graph.in_edges[bubble.source].items():
                phasing += annotations.branch_links.get((incoming, first_edge), 0)
        rankings.append((branch_edges, total_read_support, phasing))

    rankings.sort(
        key=lambda r: (-(r[1] + r[2]), _branch_sort_key(graph, r[0]))
    )
    return rankings


def resolve_bubbles(
    graph: DBGraph, annotations: ThreadingAnnotations
) -> dict[int, float]:
    """Edge preference map: best branch 1.0, others support/max
    (bubble.rs:52-87)."""
    edge_preferences: dict[int, float] = {}
    for bubble in detect_simple_bubbles(graph):
        rankings = rank_branches(graph, bubble, annotations)
        if len(rankings) >= 2:
            max_support = max((r[1] + r[2] for r in rankings), default=0)
            for edges, total, phasing in rankings:
                support = total + phasing
                preference = support / max_support if max_support > 0 else 1.0
                for eid in edges:
                    edge_preferences[eid] = preference
    return edge_preferences
