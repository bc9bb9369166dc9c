"""Per-gene sPCR orchestration (do_pcr).

Reference: upstream sharkmer src/pcr/mod.rs:401-819. Pipeline per gene:
primer k-mer discovery -> seed graph -> coverage-threshold sweep (each
step clones the seed graph fresh and extends at that threshold,
stopping at the first step where the forward/reverse frontiers meet)
-> pruning -> optional read threading + bubble preferences -> DFS
paths -> sequence generation -> score/sort/dedup -> deterministic
product renumbering.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass

from ..format import format_duration
from ..ops.encoding import kmer_to_seq
from ..utils import phases
from . import bubble as bubble_mod
from . import graph as graph_mod
from . import paths as paths_mod
from . import primers as primers_mod
from . import pruning as pruning_mod
from . import threading as threading_mod
from .counts import FilteredTable
from .params import PCRParams
from .read_filter import PrimerReadFilter

log = logging.getLogger("sharkmer")

COVERAGE_MULTIPLIER = 2
COVERAGE_STEPS = 4


@dataclass
class PcrOutcome:
    records: list[paths_mod.AssemblyRecord]
    failure_reason: str | None


def compute_coverage_thresholds(primer_count: int, min_count: int) -> list[int]:
    """High-to-low threshold schedule (mod.rs:403-428)."""
    coverage_high_threshold = primer_count // COVERAGE_MULTIPLIER
    thresholds: list[int] = []
    if coverage_high_threshold <= min_count:
        thresholds.append(min_count)
    else:
        step_size = (coverage_high_threshold - min_count) // (COVERAGE_STEPS - 1)
        for i in range(COVERAGE_STEPS):
            thresholds.append(max(coverage_high_threshold - i * step_size, 0))
        thresholds[-1] = min_count
    # dedup consecutive repeats
    out: list[int] = []
    for t in thresholds:
        if not out or out[-1] != t:
            out.append(t)
    return out


def do_pcr(
    kmer_counts: FilteredTable,
    sample_name: str,
    params: PCRParams,
    dump_graph: bool = False,
    output_directory: str = "./",
    reads=None,
    max_num_nodes: int = graph_mod.DEFAULT_MAX_NUM_NODES,
) -> PcrOutcome:
    gene = params.gene_name
    log.info("[%s] Running PCR", gene)
    log.info("[%s] Preprocessing primers", gene)
    with phases.span("primer_discovery"):
        forward_primer_kmers, reverse_primer_kmers = (
            primers_mod.get_primer_kmers(params, kmer_counts))

    fwd_missing = len(forward_primer_kmers) == 0
    rev_missing = len(reverse_primer_kmers) == 0
    if fwd_missing or rev_missing:
        which = {
            (True, True): "forward and reverse primers",
            (True, False): "forward primer",
            (False, True): "reverse primer",
        }[(fwd_missing, rev_missing)]
        log.info(
            "[%s] Binding sites were not found for the %s. Abandoning PCR.",
            gene, which,
        )
        log.info(
            "[%s] Suggested actions: optimize primer sequence, or increase "
            "the number of reads.", gene,
        )
        return PcrOutcome(records=[], failure_reason=f"{which} not found")

    # Filter reads to those relevant to this gene (Pass 2 only)
    gene_reads = None
    if reads is not None:
        read_filter = PrimerReadFilter.from_primer_kmers(
            forward_primer_kmers, reverse_primer_kmers, kmer_counts.k
        )
        gene_reads = read_filter.filter_reads(reads)
        log.info(
            "[%s] Read threading: %d of %d reads match primer kmers",
            gene, len(gene_reads), len(reads),
        )

    for kmer, count in sorted(forward_primer_kmers.items()):
        log.info(
            "[%s] Forward primer kmer %s (count %d)",
            gene, kmer_to_seq(kmer, kmer_counts.k), count,
        )
    for kmer, count in sorted(reverse_primer_kmers.items()):
        log.info(
            "[%s] Reverse primer kmer %s (count %d)",
            gene, kmer_to_seq(kmer, kmer_counts.k), count,
        )

    log.info(
        "[%s] Creating graph, seeding with %d forward and %d reverse primer "
        "kmer nodes...", gene, len(forward_primer_kmers), len(reverse_primer_kmers),
    )
    seed_graph, _node_lookup = graph_mod.create_seed_graph(
        forward_primer_kmers, reverse_primer_kmers, kmer_counts
    )

    max_forward_count = forward_primer_kmers.get_max_count()
    max_reverse_count = reverse_primer_kmers.get_max_count()
    max_primer_count = min(max_forward_count, max_reverse_count)
    median_primer_count = min(
        forward_primer_kmers.get_median_count(),
        reverse_primer_kmers.get_median_count(),
    )
    log.info(
        "[%s] Observed primer coverage: median %d, max fwd %d, max rev %d. "
        "User specified min-count is %d",
        gene, median_primer_count, max_forward_count, max_reverse_count,
        params.min_count,
    )

    coverage_thresholds = compute_coverage_thresholds(
        max_primer_count, params.min_count
    )

    failure_reason: str | None = "no path found"
    log.info(
        "[%s] Extending graph with thresholds %s (global budget %d)",
        gene, coverage_thresholds, max_num_nodes,
    )

    extend_start = time.monotonic()
    found_path_signal = False
    current_graph = seed_graph.clone()

    # NOTE: each step gets its OWN lookup session at the step's
    # threshold (created inside extend_graph). Sharing one session at
    # the schedule's lowest threshold is semantically valid (the floor
    # closure is a superset) but disastrous in practice: at the floor
    # the closure explores the whole above-floor background component
    # (never quiescing, overflowing the frontier ladder), while a
    # step-threshold closure stays confined to the amplicon's
    # high-coverage neighbourhood and quiesces in ~len/2 levels.
    # the span's self time is the host graph replay: the reach calls of
    # its prefetch sessions are spans of their own
    with phases.span("spcr.extend"):
        for step_idx, min_count in enumerate(coverage_thresholds):
            log.info(
                "[%s] Threshold step %d/%d (min_count=%d)",
                gene, step_idx + 1, len(coverage_thresholds), min_count,
            )
            fresh_graph = seed_graph.clone()
            fresh_lookup = {fresh_graph.nodes[n].sub_kmer: n
                            for n in fresh_graph.node_ids()}
            final_graph, _final_lookup, found = graph_mod.extend_graph(
                fresh_graph, fresh_lookup, kmer_counts, min_count, params,
                max_num_nodes,
            )
            current_graph = final_graph
            if found:
                found_path_signal = True
                break

    if current_graph.node_count() >= max_num_nodes:
        failure_reason = "node budget exceeded"

    log.info(
        "[%s] Done. Time to extend graph: %s",
        gene, format_duration(time.monotonic() - extend_start),
    )

    assembly_records_all: list[paths_mod.AssemblyRecord] = []
    amplicon_index = 0
    with phases.span("spcr.assembly"):
        if found_path_signal:
            pruned_graph = current_graph.clone()
            prune_start = time.monotonic()
            log.info("[%s] Pruning the assembly graph...", gene)
            pruning_mod.remove_low_coverage_tips(
                pruned_graph, kmer_counts.k, params.tip_coverage_fraction
            )
            pruning_mod.reachability_pruning(pruned_graph)
            graph_mod.annotate_coverage_ratios(pruned_graph)
            log.info(
                "[%s] Done. Time to prune graph: %s",
                gene, format_duration(time.monotonic() - prune_start),
            )

            if dump_graph:
                dot_string = write_annotated_dot(pruned_graph, kmer_counts)
                file_name = os.path.join(
                    output_directory,
                    f"{sample_name}_{gene}_{params.min_count}.dot",
                )
                with open(file_name, "w") as f:
                    f.write(dot_string)

            threading_annotations = None
            if gene_reads:
                start = time.monotonic()
                log.info("[%s] Threading reads through assembly graph...", gene)
                from ..io.records import Mate

                has_paired = any(r.mate != Mate.UNPAIRED for r in gene_reads)
                if has_paired:
                    ann = threading_mod.thread_reads_paired(
                        pruned_graph, gene_reads, kmer_counts.k
                    )
                else:
                    ann = threading_mod.thread_reads(
                        pruned_graph, gene_reads, kmer_counts.k
                    )
                supported = sum(
                    1 for s in ann.edge_support.values() if s.read_support_total > 0
                )
                log.info(
                    "[%s] Threading: %d/%d edges have read support, %d branch "
                    "links, %d paired links. Time: %s",
                    gene, supported, pruned_graph.edge_count(),
                    len(ann.branch_links), len(ann.paired_links),
                    format_duration(time.monotonic() - start),
                )
                threading_annotations = ann

            path_start = time.monotonic()
            log.info(
                "[%s] Traversing the assembly graph to find paths from forward "
                "to reverse primers...", gene,
            )
            edge_preferences = None
            if threading_annotations is not None:
                edge_preferences = bubble_mod.resolve_bubbles(
                    pruned_graph, threading_annotations
                )
            all_paths = paths_mod.get_assembly_paths(
                pruned_graph, kmer_counts, params, edge_preferences
            )
            log.info(
                "[%s] Found %d paths. Time: %s",
                gene, len(all_paths), format_duration(time.monotonic() - path_start),
            )

            if all_paths:
                records, _ = paths_mod.generate_sequences_from_paths(
                    pruned_graph, all_paths, kmer_counts, sample_name, params,
                    amplicon_index, threading_annotations,
                )
                if records:
                    log.info("[%s] Obtained %d PCR product(s).", gene, len(records))
                    assembly_records_all.extend(records)
                    failure_reason = None

    if (max_forward_count < 5) or (max_reverse_count < 5):
        log.info(
            "[%s] Primer kmer counts are low, in this case less than 5. "
            "Consider increasing the number of reads.", gene,
        )
    log.info("[%s] Done.", gene)

    if not assembly_records_all:
        log.info(
            "[%s] No path was found from a forward primer binding site to a "
            "reverse primer binding site. Abandoning PCR.", gene,
        )
        return PcrOutcome(records=[], failure_reason=failure_reason)

    records = paths_mod.sort_and_deduplicate(assembly_records_all, params)

    # Deterministic renumbering after dedup (mod.rs:789-813)
    renumbered = []
    for i, record in enumerate(records):
        rec_id = f"{sample_name}_{gene}_{i}"
        desc = " ".join(
            f"product={i}" if f.startswith("product=") else f
            for f in record.desc.split()
        )
        renumbered.append(
            paths_mod.AssemblyRecord(rec_id, desc, record.seq, record.score)
        )

    return PcrOutcome(records=renumbered, failure_reason=None)


def write_annotated_dot(graph: graph_mod.DBGraph, kmer_counts: FilteredTable) -> str:
    """Annotated Graphviz DOT for --dump-graph (mod.rs:825-875)."""
    k = kmer_counts.k
    sub_k = k - 1
    lines = ["digraph {", "  rankdir=LR;"]
    for nid in graph.node_ids():
        node = graph.nodes[nid]
        seq = kmer_to_seq(node.sub_kmer, sub_k)
        attrs = [f'label="{seq}"']
        if node.is_start and node.is_end:
            attrs.append("shape=diamond")
        elif node.is_start:
            attrs.append("shape=doublecircle")
        elif node.is_end:
            attrs.append("shape=box")
        lines.append(f"  {nid} [{', '.join(attrs)}];")
    for eid in graph.edge_ids():
        e = graph.edges[eid]
        seq = kmer_to_seq(graph.edge_kmer(eid), k)
        lines.append(f'  {e.src} -> {e.tgt} [label="{seq} ({e.count})"];')
    lines.append("}")
    return "\n".join(lines) + "\n"
