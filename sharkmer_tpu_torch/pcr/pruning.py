"""Graph cleanup: low-coverage tip removal and reachability pruning.

Reference: upstream sharkmer src/pcr/pruning.rs. Annotation-only model —
these are the only structural edits made to the extended graph.
"""

from __future__ import annotations

import logging

from .graph import DBGraph, median_f64

log = logging.getLogger("sharkmer")


def remove_low_coverage_tips(
    graph: DBGraph, k: int, tip_coverage_fraction: float
) -> None:
    """Iteratively remove short, low-coverage dead-end tips
    (pruning.rs:19-95). The coverage reference median is frozen from
    the pre-pruning graph."""
    median_count = median_f64(graph.edge_counts())
    if median_count is None:
        median_count = 1.0
    min_tip_count = max(median_count * tip_coverage_fraction, 1.0)

    removed = 1
    while removed > 0:
        removed = 0
        to_remove = []
        for nid in graph.node_ids():
            node = graph.nodes[nid]
            if node.is_end or node.is_start:
                continue
            no_outgoing = graph.out_degree(nid) == 0
            no_incoming = graph.in_degree(nid) == 0
            if not no_outgoing and not no_incoming:
                continue

            if no_outgoing:
                if _tip_length_backward(graph, nid) >= k:
                    continue
                max_in = max(
                    (graph.edges[eid].count for eid in graph.in_edges[nid].values()),
                    default=0,
                )
                if max_in >= min_tip_count:
                    continue
            if no_incoming:
                if _tip_length_forward(graph, nid) >= k:
                    continue
                max_out = max(
                    (graph.edges[eid].count for eid in graph.out_edges[nid].values()),
                    default=0,
                )
                if max_out >= min_tip_count:
                    continue
            to_remove.append(nid)

        for nid in to_remove:
            graph.remove_node(nid)
            removed += 1


def _tip_length_backward(graph: DBGraph, node: int) -> int:
    """Nodes from a forward dead end back to a branch point (pruning.rs:99-124)."""
    length = 0
    current = node
    while True:
        length += 1
        incoming = list(graph.in_neighbors(current))
        if len(incoming) != 1:
            break
        parent = incoming[0]
        if graph.out_degree(parent) > 1:
            break
        if graph.nodes[parent].is_start:
            break
        current = parent
    return length


def _tip_length_forward(graph: DBGraph, node: int) -> int:
    """pruning.rs:128-149."""
    length = 0
    current = node
    while True:
        length += 1
        outgoing = list(graph.out_neighbors(current))
        if len(outgoing) != 1:
            break
        child = outgoing[0]
        if graph.in_degree(child) > 1:
            break
        if graph.nodes[child].is_end:
            break
        current = child
    return length


def reachability_pruning(graph: DBGraph) -> None:
    """Remove nodes not on any start-to-end path: union DFS from all
    starts (forward) intersected with union DFS from all ends
    (backward) (pruning.rs:170-214)."""
    forward_reachable: set[int] = set()
    stack = graph.start_nodes()
    while stack:
        n = stack.pop()
        if n not in forward_reachable:
            forward_reachable.add(n)
            stack.extend(graph.out_neighbors(n))

    backward_reachable: set[int] = set()
    stack = graph.end_nodes()
    while stack:
        n = stack.pop()
        if n not in backward_reachable:
            backward_reachable.add(n)
            stack.extend(graph.in_neighbors(n))

    to_remove = [
        n
        for n in graph.node_ids()
        if n not in forward_reachable or n not in backward_reachable
    ]
    if to_remove:
        log.debug(
            "Reachability pruning: removing %d of %d nodes not on any "
            "start-to-end path",
            len(to_remove),
            graph.node_count(),
        )
    for n in to_remove:
        graph.remove_node(n)
