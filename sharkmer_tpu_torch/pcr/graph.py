"""De Bruijn graph construction and bidirectional frontier extension.

Reference: upstream sharkmer src/pcr/graph.rs. Nodes are (k-1)-mers,
edges are k-mers reconstructed as ``(src.sub_kmer << 2) | (tgt.sub_kmer
& 3)`` (graph.rs:127-134). The graph is host-side (python dicts —
bounded at ~500k nodes by the node budget); the per-node candidate
probes are batched per frontier *wave* into one device lookup.

Wave batching preserves the reference's exact FIFO semantics
(graph.rs:321-528): the reference pops one entry at a time and appends
new nodes to the back of the queue, so the queue drains in BFS levels;
a wave is exactly one such level, and entries within a wave are
processed sequentially on host with the same per-entry logic (median
refresh cadence, budget check, high-coverage skip, meet-in-the-middle
detection). Candidate counts depend only on the immutable count table,
never on graph state, so hoisting the lookups to the start of the wave
cannot change behaviour.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..ops.encoding import revcomp_kmer
from ..utils.progress import get_progress
from .counts import FilteredTable, SmallCounts
from .params import PCRParams

log = logging.getLogger("sharkmer")
_progress = get_progress()

EXTENSION_EVALUATION_FREQUENCY = 1_000
EXTENSION_EVALUATION_DEPTH = 4
DEFAULT_MAX_NUM_NODES = 500_000
MIN_NODE_BUDGET = 100_000
BUDGET_LERP_LOW_BP = 150_000_000
BUDGET_LERP_HIGH_BP = 750_000_000

FWD, REV = 0, 1  # extension directions


def compute_node_budget(n_bases_ingested: int) -> int:
    """Lerp 100K -> 500K nodes over 150M -> 750M ingested bp (graph.rs:40-52)."""
    if n_bases_ingested <= BUDGET_LERP_LOW_BP:
        return MIN_NODE_BUDGET
    if n_bases_ingested >= BUDGET_LERP_HIGH_BP:
        return DEFAULT_MAX_NUM_NODES
    fraction = (n_bases_ingested - BUDGET_LERP_LOW_BP) / (
        BUDGET_LERP_HIGH_BP - BUDGET_LERP_LOW_BP
    )
    return int(MIN_NODE_BUDGET + fraction * (DEFAULT_MAX_NUM_NODES - MIN_NODE_BUDGET))


def get_suffix_mask(k: int) -> int:
    """Mask isolating the last k-1 bases of a k-mer (graph.rs:57-60)."""
    return (1 << (2 * (k - 1))) - 1


def median_f64(values) -> float | None:
    """Median as f64: even length -> (lower_max + upper_min)/2 (graph.rs:82-103)."""
    a = np.asarray(values)
    if a.size == 0:
        return None
    mid = a.size // 2
    if a.size % 2 == 0:
        part = np.partition(a, [mid - 1, mid])
        return (float(part[mid - 1]) + float(part[mid])) / 2.0
    return float(np.partition(a, mid)[mid])


def compute_mean(values) -> float:
    a = np.asarray(values, dtype=np.float64)
    return float(a.mean()) if a.size else 0.0


def compute_median(values) -> float:
    return median_f64(values) or 0.0


@dataclass
class DBNode:
    sub_kmer: int
    is_start: bool
    is_end: bool


@dataclass
class DBEdge:
    src: int
    tgt: int
    count: int
    coverage_ratio: float = 0.0


class DBGraph:
    """Stable directed graph: node/edge ids are never reused, and
    iteration follows insertion order (matching petgraph's
    StableDiGraph index-order iteration)."""

    def __init__(self):
        self.nodes: dict[int, DBNode] = {}
        self.edges: dict[int, DBEdge] = {}
        self.out_edges: dict[int, dict[int, int]] = {}  # src -> {tgt: edge_id}
        self.in_edges: dict[int, dict[int, int]] = {}  # tgt -> {src: edge_id}
        self._next_node = 0
        self._next_edge = 0

    # -- construction --------------------------------------------------------

    def add_node(self, node: DBNode) -> int:
        nid = self._next_node
        self._next_node += 1
        self.nodes[nid] = node
        self.out_edges[nid] = {}
        self.in_edges[nid] = {}
        return nid

    def add_edge(self, src: int, tgt: int, edge: DBEdge) -> int:
        eid = self._next_edge
        self._next_edge += 1
        edge.src, edge.tgt = src, tgt
        self.edges[eid] = edge
        self.out_edges[src][tgt] = eid
        self.in_edges[tgt][src] = eid
        return eid

    def find_edge(self, src: int, tgt: int) -> int | None:
        return self.out_edges.get(src, {}).get(tgt)

    def remove_node(self, nid: int) -> None:
        for tgt, eid in list(self.out_edges[nid].items()):
            del self.in_edges[tgt][nid]
            del self.edges[eid]
        for src, eid in list(self.in_edges[nid].items()):
            del self.out_edges[src][nid]
            del self.edges[eid]
        del self.out_edges[nid]
        del self.in_edges[nid]
        del self.nodes[nid]

    def clone(self) -> "DBGraph":
        g = DBGraph()
        g.nodes = {
            nid: DBNode(n.sub_kmer, n.is_start, n.is_end)
            for nid, n in self.nodes.items()
        }
        g.edges = {
            eid: DBEdge(e.src, e.tgt, e.count, e.coverage_ratio)
            for eid, e in self.edges.items()
        }
        g.out_edges = {nid: dict(d) for nid, d in self.out_edges.items()}
        g.in_edges = {nid: dict(d) for nid, d in self.in_edges.items()}
        g._next_node = self._next_node
        g._next_edge = self._next_edge
        return g

    # -- queries ---------------------------------------------------------------

    def node_count(self) -> int:
        return len(self.nodes)

    def edge_count(self) -> int:
        return len(self.edges)

    def node_ids(self) -> list[int]:
        return list(self.nodes.keys())

    def edge_ids(self) -> list[int]:
        return list(self.edges.keys())

    def out_neighbors(self, nid: int):
        return self.out_edges[nid].keys()

    def in_neighbors(self, nid: int):
        return self.in_edges[nid].keys()

    def out_degree(self, nid: int) -> int:
        return len(self.out_edges[nid])

    def in_degree(self, nid: int) -> int:
        return len(self.in_edges[nid])

    def start_nodes(self) -> list[int]:
        return [n for n, d in self.nodes.items() if d.is_start]

    def end_nodes(self) -> list[int]:
        return [n for n, d in self.nodes.items() if d.is_end]

    def edge_kmer(self, eid: int) -> int:
        """Reconstruct the edge's k-mer (graph.rs:127-134)."""
        e = self.edges[eid]
        return (self.nodes[e.src].sub_kmer << 2) | (self.nodes[e.tgt].sub_kmer & 3)

    def edge_counts(self) -> list[int]:
        return [e.count for e in self.edges.values()]


def descendants(graph: DBGraph, node: int, depth: int) -> set[int]:
    """Nodes within `depth` outgoing steps (graph.rs:151-179)."""
    from collections import deque

    visited = {node}
    result: set[int] = set()
    queue = deque([(node, 0)])
    while queue:
        current, d = queue.popleft()
        if d >= depth:
            continue
        for nb in graph.out_neighbors(current):
            if nb not in visited:
                visited.add(nb)
                result.add(nb)
                queue.append((nb, d + 1))
    return result


def create_seed_graph(
    forward_primer_kmers: SmallCounts,
    reverse_primer_kmers: SmallCounts,
    counts: FilteredTable,
) -> tuple[DBGraph, dict[int, int]]:
    """Seed the graph with strand-normalized primer nodes (graph.rs:196-278).

    Forward seed sub_kmer = kmer prefix (kmer >> 2); reverse seeds are
    revcomp'd to the sense strand and take the suffix
    (revcomp(kmer) & suffix_mask). Seed k-mers are sorted before
    insertion for determinism (graph.rs:233-234, 251-252).
    """
    graph = DBGraph()
    node_lookup: dict[int, int] = {}
    k = counts.k
    suffix_mask = get_suffix_mask(k)

    for kmer in sorted(forward_primer_kmers.kmers()):
        sub_kmer = kmer >> 2
        existing = node_lookup.get(sub_kmer)
        if existing is not None:
            graph.nodes[existing].is_start = True
        else:
            node_lookup[sub_kmer] = graph.add_node(DBNode(sub_kmer, True, False))

    for kmer in sorted(reverse_primer_kmers.kmers()):
        rc = revcomp_kmer(kmer, k)
        sub_kmer = rc & suffix_mask
        existing = node_lookup.get(sub_kmer)
        if existing is not None:
            graph.nodes[existing].is_end = True
        else:
            node_lookup[sub_kmer] = graph.add_node(DBNode(sub_kmer, False, True))

    return graph, node_lookup


def extend_graph(
    graph: DBGraph,
    node_lookup: dict[int, int],
    counts: FilteredTable,
    min_count: int,
    params: PCRParams,
    max_num_nodes: int,
    lookup=None,
) -> tuple[DBGraph, dict[int, int], bool]:
    """Unified bidirectional extension (graph.rs:321-528).

    Returns (graph, node_lookup, found_path). found_path = forward and
    reverse extension frontiers met.

    ``lookup``: optional lookup-provider injection point (tests, and
    callers that want to share a pre-warmed cache). Production do_pcr
    passes None: each threshold step builds its OWN session at the
    step's threshold inside this function — see the NOTE in
    pcr/spcr.py for why sharing one floor-threshold session across
    steps was tried and rejected.
    """
    k = counts.k
    suffix_mask = get_suffix_mask(k)
    prefix_shift = 2 * (k - 1)
    found_path = False

    if lookup is None:
        # per-walk lookup provider: a device-prefetch cache session
        # when the backend supports reachability closures, the plain
        # view otherwise (semantics identical either way — the session
        # only caches, see pcr/prefetch.py)
        lookup = (
            counts.extension_session(min_count)
            if hasattr(counts, "extension_session") else counts
        )

    last_check = 0
    # live edge-count list: extension only ever ADDS edges, so appending
    # at each add_edge keeps this exact while avoiding the O(E) rebuild
    # of graph.edge_counts() at every median-refresh cadence point
    edge_counts_live: list[int] = graph.edge_counts()
    median_edge_count = (
        median_f64(edge_counts_live)
        if edge_counts_live else float(min_count)
    )
    last_median_check = 0

    # wave entries: (node_id, dir); candidates precomputed per entry
    wave: list[tuple[int, int]] = []
    for nid in graph.node_ids():
        if graph.nodes[nid].is_start:
            wave.append((nid, FWD))
        if graph.nodes[nid].is_end:
            wave.append((nid, REV))

    processed_fwd: set[int] = set()
    processed_rev: set[int] = set()
    added_by_fwd: set[int] = set()
    added_by_rev: set[int] = set()
    for nid in graph.node_ids():
        if graph.nodes[nid].is_start:
            added_by_fwd.add(nid)
        if graph.nodes[nid].is_end:
            added_by_rev.add(nid)

    budget_exceeded = False
    bases_u64 = np.arange(4, dtype=np.uint64)
    while wave and not budget_exceeded:
        # --- batched lookup for the whole wave ------------------------------
        # vectorized candidate build + ONE bulk tolist() per wave: the
        # per-entry python shifts and per-element int(np_scalar) reads
        # dominate host time otherwise
        subs = np.fromiter(
            (graph.nodes[nid].sub_kmer for nid, _ in wave),
            dtype=np.uint64, count=len(wave),
        )
        dirs = np.fromiter(
            (d for _, d in wave), dtype=np.uint8, count=len(wave)
        )
        fwd_cand = (subs[:, None] << np.uint64(2)) | bases_u64[None, :]
        rev_cand = (bases_u64[None, :] << np.uint64(prefix_shift)) | subs[:, None]
        cand = np.where(dirs[:, None] == FWD, fwd_cand, rev_cand)
        cand_counts = lookup.get_canonical_many(cand.reshape(-1)).reshape(-1, 4)
        cand_list = cand.tolist()
        counts_list = cand_counts.tolist()

        next_wave: list[tuple[int, int]] = []
        for i, (node, d) in enumerate(wave):
            if d == FWD:
                if node in processed_fwd:
                    continue
                processed_fwd.add(node)
            else:
                if node in processed_rev:
                    continue
                processed_rev.add(node)

            n_nodes = graph.node_count()
            if n_nodes > max_num_nodes:
                log.info(
                    "[%s] There are %d nodes in the graph. This exceeds the "
                    "maximum of %d, abandoning search.",
                    params.gene_name, n_nodes, max_num_nodes,
                )
                budget_exceeded = True
                break

            if (
                n_nodes > last_median_check
                and (n_nodes - last_median_check) > EXTENSION_EVALUATION_FREQUENCY
            ):
                m = median_f64(edge_counts_live)
                median_edge_count = float(min_count) if m is None else m
                last_median_check = n_nodes - (
                    n_nodes % EXTENSION_EVALUATION_FREQUENCY
                )

            if (n_nodes > last_check) and (
                (n_nodes - last_check) > EXTENSION_EVALUATION_FREQUENCY
            ):
                last_check = n_nodes - (n_nodes % EXTENSION_EVALUATION_FREQUENCY)
                log.debug("[%s] extension at %d nodes, %d edges",
                          params.gene_name, n_nodes, graph.edge_count())
                _progress.tick(
                    f"[{params.gene_name}] extending graph: {n_nodes:,} "
                    f"nodes, {graph.edge_count():,} edges"
                )

            sub_kmer = graph.nodes[node].sub_kmer
            row_counts = counts_list[i]
            row_kmers = cand_list[i]
            for b in range(4):
                count = row_counts[b]
                if count < min_count or count == 0:
                    continue
                kmer = row_kmers[b]
                new_sub_kmer = (kmer & suffix_mask) if d == FWD else (kmer >> 2)
                if new_sub_kmer == sub_kmer:
                    continue  # self-loop

                existing = node_lookup.get(new_sub_kmer)
                if existing is not None:
                    if d == FWD:
                        if graph.find_edge(node, existing) is None:
                            graph.add_edge(node, existing, DBEdge(node, existing, count))
                            edge_counts_live.append(count)
                            if existing in added_by_rev:
                                if not found_path:
                                    log.info(
                                        "[%s] Forward and reverse extensions met.",
                                        params.gene_name,
                                    )
                                found_path = True
                    else:
                        if graph.find_edge(existing, node) is None:
                            graph.add_edge(existing, node, DBEdge(existing, node, count))
                            edge_counts_live.append(count)
                            if existing in added_by_fwd:
                                if not found_path:
                                    log.info(
                                        "[%s] Forward and reverse extensions met.",
                                        params.gene_name,
                                    )
                                found_path = True
                else:
                    # skip high-coverage (likely repetitive) edges
                    if count > median_edge_count * params.high_coverage_ratio:
                        continue
                    new_node = graph.add_node(DBNode(new_sub_kmer, False, False))
                    node_lookup[new_sub_kmer] = new_node
                    if d == FWD:
                        added_by_fwd.add(new_node)
                        graph.add_edge(node, new_node, DBEdge(node, new_node, count))
                    else:
                        added_by_rev.add(new_node)
                        graph.add_edge(new_node, node, DBEdge(new_node, node, count))
                    edge_counts_live.append(count)
                    next_wave.append((new_node, d))

        wave = next_wave

    _progress.finish()
    return graph, node_lookup, found_path


def annotate_coverage_ratios(graph: DBGraph) -> None:
    """edge.coverage_ratio = count / global median (graph.rs:533-546)."""
    median = median_f64(graph.edge_counts())
    if median is None or median <= 0.0:
        return
    for e in graph.edges.values():
        e.coverage_ratio = e.count / median
