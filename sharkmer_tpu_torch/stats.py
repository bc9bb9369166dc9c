"""Run statistics, the gene-parallel PCR runner, and the final summary.

Reference: upstream sharkmer src/stats.rs. Genes run in parallel on a
host thread pool (the reference's rayon par_iter, stats.rs:84-98) —
device lookups dispatch concurrently and serialize on the accelerator
queue — while FASTA outputs are written sequentially in primer order
for determinism (stats.rs:101-145).
"""

from __future__ import annotations

import logging
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import yaml

from . import __version__
from .format import format_bytes, format_count, format_duration
from .io.writers import warn_if_exists, write_fasta_record
from .pcr import PCRParams, do_pcr
from .pcr.counts import FilteredTable

log = logging.getLogger("sharkmer")


@dataclass
class PcrGeneResult:
    gene_name: str
    status: str
    n_products: int
    product_lengths: list[int] = field(default_factory=list)
    output_file: str | None = None
    failure_reason: str | None = None


@dataclass
class RunStats:
    sharkmer_version: str
    command: str
    sample: str
    kmer_length: int
    chunks: int
    n_reads_read: int
    n_bases_read: int
    n_subreads_ingested: int
    n_bases_ingested: int
    n_kmers: int
    n_multi_kmers: int | None
    n_singleton_kmers: int | None
    peak_memory_bytes: int
    pcr_results: list[PcrGeneResult]

    def to_yaml_dict(self) -> dict:
        d = {
            "sharkmer_version": self.sharkmer_version,
            "command": self.command,
            "sample": self.sample,
            "kmer_length": self.kmer_length,
            "chunks": self.chunks,
            "n_reads_read": self.n_reads_read,
            "n_bases_read": self.n_bases_read,
            "n_subreads_ingested": self.n_subreads_ingested,
            "n_bases_ingested": self.n_bases_ingested,
            "n_kmers": self.n_kmers,
        }
        if self.n_multi_kmers is not None:
            d["n_multi_kmers"] = self.n_multi_kmers
        if self.n_singleton_kmers is not None:
            d["n_singleton_kmers"] = self.n_singleton_kmers
        d["peak_memory_bytes"] = self.peak_memory_bytes
        if self.pcr_results:
            d["pcr_results"] = [
                _gene_result_dict(r) for r in self.pcr_results
            ]
        return d


def _gene_result_dict(r: PcrGeneResult) -> dict:
    d = {
        "gene_name": r.gene_name,
        "status": r.status,
        "n_products": r.n_products,
    }
    if r.product_lengths:
        d["product_lengths"] = r.product_lengths
    if r.output_file is not None:
        d["output_file"] = r.output_file
    if r.failure_reason is not None:
        d["failure_reason"] = r.failure_reason
    return d


def run_pcr(
    filtered: FilteredTable,
    pcr_runs: list[PCRParams],
    sample: str,
    directory: str,
    dump_graph: bool = False,
    reads=None,
    max_nodes: int = 500_000,
    threads: int = 1,
) -> list[PcrGeneResult]:
    """Run sPCR for all primer pairs; write FASTA files; return results."""
    pcr_results: list[PcrGeneResult] = []
    if not pcr_runs:
        return pcr_results

    log.info("Running in silico PCR...")
    log.info("Filtering kmers with count < %d before PCR", filtered.min_count)
    from .pcr.primers import warm_panel_scans
    from .utils import phases

    phases.reset()  # the sPCR phases start here
    # one mirror/rc-index build, not one per worker (its warm-up reach
    # calls are left out of the "closures" phase)
    with phases.span(phases.WARM_UP):
        filtered.warm_caches()
    # pre-fetch every gene's primer scans in one batched dispatch
    with phases.span("panel_scans"):
        warm_panel_scans(filtered, pcr_runs)

    def one(params: PCRParams):
        with phases.span("spcr.gene", tag=f"{params.gene_name}@"
                         f"{threading.current_thread().name}"):
            return do_pcr(filtered, sample, params, dump_graph, directory,
                          reads, max_nodes)

    if threads > 1:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            outcomes = list(pool.map(one, pcr_runs))
    else:
        outcomes = [one(p) for p in pcr_runs]

    # sequential writes in primer order for determinism
    for params, outcome in zip(pcr_runs, outcomes):
        if outcome.records:
            fasta_path = f"{directory}{sample}_{params.gene_name}.fasta"
            warn_if_exists(fasta_path)
            product_lengths = [len(r.seq) for r in outcome.records]
            with open(fasta_path, "w") as f:
                for record in outcome.records:
                    write_fasta_record(f, record.rec_id, record.desc, record.seq)
            pcr_results.append(
                PcrGeneResult(
                    gene_name=params.gene_name,
                    status="success",
                    n_products=len(product_lengths),
                    product_lengths=product_lengths,
                )
            )
        else:
            failure_reason = outcome.failure_reason or (
                "unknown (no reason reported by PCR pipeline)"
            )
            pcr_results.append(
                PcrGeneResult(
                    gene_name=params.gene_name,
                    status="fail",
                    n_products=0,
                    failure_reason=failure_reason,
                )
            )

    show_progress = sys.stderr.isatty()
    sym_pass, sym_fail = ("✔", "✘") if show_progress else ("+", "-")
    for result in pcr_results:
        if result.status == "success":
            lengths = ", ".join(str(l) for l in result.product_lengths)
            plural = "" if result.n_products == 1 else "s"
            log.warning(
                "  %s %s (%d product%s, %s bp)",
                sym_pass, result.gene_name, result.n_products, plural, lengths,
            )
        else:
            log.warning(
                "  %s %s (no products, %s)",
                sym_fail, result.gene_name, result.failure_reason,
            )

    # permanent phase split (task: every bench stderr tail carries it);
    # warning level so default bench/CLI logging shows the line
    log.warning("  sPCR phases: %s", phases.report())
    log.info("Done running in silico PCR")
    return pcr_results


def write_stats(run_stats: RunStats, directory: str, sample: str) -> None:
    log.info("Writing stats to file...")
    stats_path = f"{directory}{sample}.stats.yaml"
    warn_if_exists(stats_path)
    with open(stats_path, "w") as f:
        yaml.safe_dump(run_stats.to_yaml_dict(), f, sort_keys=False)


def print_summary(run_stats: RunStats, elapsed: float) -> None:
    """One-line completion summary to stderr (stats.rs:196-254)."""
    elapsed_str = format_duration(elapsed)
    reads_str = format_count(run_stats.n_reads_read)
    mem = format_bytes(run_stats.peak_memory_bytes)

    if run_stats.pcr_results:
        successes = [r for r in run_stats.pcr_results if r.status == "success"]
        names = [r.gene_name for r in successes]
        if not names:
            detail = ""
        elif len(names) <= 10:
            detail = f" ({', '.join(names)})"
        else:
            detail = f" ({', '.join(names[:10])}, +{len(names) - 10} more)"
        log.warning(
            "sharkmer complete: %s reads, %d/%d genes amplified%s, "
            "peak mem %s, %s",
            reads_str, len(successes), len(run_stats.pcr_results), detail,
            mem, elapsed_str,
        )
    elif run_stats.chunks > 0:
        log.warning(
            "sharkmer complete: %s reads, %s kmers, %d chunks, peak mem %s, %s",
            reads_str, format_count(run_stats.n_kmers), run_stats.chunks,
            mem, elapsed_str,
        )
    else:
        log.warning(
            "sharkmer complete: %s reads, %s kmers, peak mem %s, %s",
            reads_str, format_count(run_stats.n_kmers), mem, elapsed_str,
        )


def peak_memory_bytes() -> int:
    """Peak RSS of this process (the reference uses a peak allocator;
    ru_maxrss is the host-side equivalent — device HBM not included)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
