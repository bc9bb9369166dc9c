"""CLI pipeline: parse -> primers -> ingest -> consolidate -> sPCR -> stats.

Torch port of ``sharkmer_tpu.main``: the same pipeline around the port's
``CountingEngine``, on the device ``SHARKMER_TORCH_DEVICE`` names
(``device.py``). Reference: upstream sharkmer src/main.rs. The linear
stage order and every early-exit / validation hook are preserved.
``--load-table`` replaces ingest and consolidation with a checkpoint
load (``io/checkpoint.py``); its load time is logged as the ingest wall.
"""

from __future__ import annotations

import logging
import os
import shlex
import sys
import time

from . import __version__
from .cli import (
    apply_tuning_overrides,
    build_parser,
    collect_pcr_params,
    handle_dry_run,
    handle_early_exits,
    handle_validate_panels,
    init_logging,
    resolve_sample_name,
    validate_args,
)
from .device import default_device, device_peak_bytes, synchronize
from .engine import COUNT_SPANS, CountingEngine
from .io import fastq as fastq_mod
from .io.cache import CacheConfig
from .io.records import Mate, ReadRecord
from .io.writers import write_final_histo, write_incremental_histo
from .pcr import compute_node_budget
from .pcr.counts import FilteredTable
from .stats import RunStats, peak_memory_bytes, print_summary, run_pcr, write_stats
from .utils import phases

log = logging.getLogger("sharkmer")


def main(argv: list[str] | None = None) -> int:
    start_run = time.monotonic()
    parser = build_parser()
    args = parser.parse_args(argv)
    init_logging(args.verbose, args.quiet, args.color)

    try:
        return _run(args, argv, start_run)
    except (ValueError, OSError, AssertionError) as e:
        log.error("%s", e)
        return 1


def _run(args, argv, start_run) -> int:
    handle_early_exits(args)

    pcr_runs = collect_pcr_params(args)
    apply_tuning_overrides(args, pcr_runs)

    if args.validate_panels:
        handle_validate_panels(pcr_runs)

    sample, cached_ena = resolve_sample_name(args)

    log.info("sharkmer-tpu %s", __version__)

    directory = args.outdir if args.outdir.endswith("/") else args.outdir + "/"
    k = args.k

    validate_args(args, pcr_runs)

    if args.dry_run:
        handle_dry_run(args, sample, directory, pcr_runs)

    os.makedirs(directory, exist_ok=True)

    cache_config = None
    if not args.no_cache and args.ena:
        cache_config = CacheConfig.new(args.cache_dir)
        log.info("Read cache: %s", cache_config.cache_dir)

    # ---- Pass 1: ingest + count (or load a checkpoint) ----------------------
    capacity = args.table_capacity or (1 << 22)
    engine = CountingEngine(
        k=k, device=default_device(), n_chunks=args.chunks,
        histo_max=args.histo_max, initial_capacity=capacity,
        n_shards=args.n_shards, backend=args.backend,
    )
    if args.n_shards > 1:
        log.info("Count table sharded over %d devices (%d shards on %s)",
                 len(set(engine.devices)), args.n_shards,
                 ", ".join(map(str, engine.devices)))

    if args.load_table:
        from .io.checkpoint import load_table

        load_start = time.monotonic()
        table, saved_stats = load_table(args.load_table, engine.device,
                                        args.n_shards, backend=args.backend,
                                        devices=engine.devices)
        synchronize(*engine.devices)
        walls = {"ingest": time.monotonic() - load_start, "consolidate": 0.0}
        if table.k != k:
            log.info(
                "Checkpoint was built with k=%d; using it (CLI -k %d ignored)",
                table.k, k,
            )
            k = table.k
        engine.table = table
        engine.k = k
        if saved_stats:
            for field_name, value in saved_stats.items():
                setattr(engine.stats, field_name, value)
        return _run_post_count(args, argv, start_run, engine, sample,
                               directory, k, pcr_runs, None, walls)

    max_reads = args.max_reads or 0
    ingest_start = time.monotonic()
    log.info("Ingesting reads...")
    read_plan = _ingest_all(args, engine, max_reads, cache_config, cached_ena)
    synchronize(*engine.devices)
    walls = {"ingest": time.monotonic() - ingest_start}
    from .utils.progress import get_progress

    get_progress().finish()
    log.info(
        "Read %s reads, %s bases",
        f"{engine.stats.n_reads_read:,}", f"{engine.stats.n_bases_read:,}",
    )

    has_pcr = bool(pcr_runs)
    if has_pcr and engine.stats.n_reads_read < 10_000:
        log.warning(
            "Only %d reads ingested. sPCR typically needs many more reads "
            "to produce results.", engine.stats.n_reads_read,
        )

    # ---- consolidate + histograms -----------------------------------------
    spinner_msg = (
        "Consolidating kmer counts..." if args.chunks > 0 else "Merging kmer counts..."
    )
    log.info("%s", spinner_msg)
    consolidate_start = time.monotonic()
    histo_vecs = engine.consolidate()
    synchronize(*engine.devices)
    walls["consolidate"] = time.monotonic() - consolidate_start
    if engine.stats.n_reads_ingested == 0:
        raise ValueError(
            "No reads were ingested. Check that input files contain valid "
            "FASTQ records."
        )
    log.info(
        "Time to ingest reads: %.1fs", time.monotonic() - ingest_start
    )
    log.info(
        "%s unique kmers with a total count of %s were found",
        f"{engine.table.n_unique():,}", f"{engine.table.n_total():,}",
    )

    n_singleton_kmers = None
    if histo_vecs is not None:
        log.info("Writing histograms to file...")
        write_incremental_histo(
            f"{directory}{sample}.histo", histo_vecs, args.histo_max, k,
            args.chunks,
        )
        log.info("Writing final histogram to file...")
        write_final_histo(
            f"{directory}{sample}.final.histo", histo_vecs[-1],
            args.histo_max, k, args.chunks,
        )
        n_singleton_kmers = engine.n_singletons(histo_vecs)
        n_unique = int(sum(histo_vecs[-1][1:]))
        if n_unique > 0:
            singleton_rate = n_singleton_kmers / n_unique
            if singleton_rate > 0.95:
                log.warning(
                    "Very high singleton rate (%.1f%%). This may indicate "
                    "very low coverage or contamination. sPCR results may "
                    "be unreliable.", singleton_rate * 100.0,
                )

    # ---- checkpoint ----------------------------------------------------------
    if args.save_table:
        from .io.checkpoint import save_table

        save_table(args.save_table, engine.table, engine.stats)

    # ---- Pass 2 reread (read threading, opt-in) ----------------------------
    threading_reads = None
    if args.read_threading and pcr_runs:
        threading_reads = _reread_sequences(read_plan)

    return _run_post_count(args, argv, start_run, engine, sample, directory,
                           k, pcr_runs, histo_vecs, walls, threading_reads)


def _run_post_count(args, argv, start_run, engine, sample, directory, k,
                    pcr_runs, histo_vecs, walls, threading_reads=None) -> int:
    n_singleton_kmers = engine.n_singletons(histo_vecs)

    # ---- node budget -------------------------------------------------------
    if args.node_budget_global is not None:
        node_budget = args.node_budget_global
        log.info(
            "Global node budget: %d (pinned via --node-budget-global)",
            node_budget,
        )
    else:
        node_budget = compute_node_budget(engine.stats.n_bases_ingested)
        log.info(
            "Global node budget: %d (auto, based on %d bp ingested; ~%dM "
            "reads at 150bp). Pin with --node-budget-global.",
            node_budget, engine.stats.n_bases_ingested,
            engine.stats.n_bases_ingested // 150_000_000,
        )

    # ---- sPCR --------------------------------------------------------------
    mirror_mode = getattr(args, "mirror", "auto")
    if getattr(args, "no_mirror", False):  # legacy alias
        mirror_mode = "device"
    filtered = FilteredTable(
        engine.table, args.min_kmer_count, mode=mirror_mode,
    )
    spcr_start = time.monotonic()
    pcr_results = run_pcr(
        filtered, pcr_runs, sample, directory,
        dump_graph=args.dump_graph, reads=threading_reads,
        max_nodes=node_budget, threads=args.threads,
    )
    synchronize(*engine.devices)
    walls["spcr"] = time.monotonic() - spcr_start
    # one line per run: stage walls and each device's peak allocation
    peaks = []
    for device in dict.fromkeys(engine.devices):
        peak = device_peak_bytes(device)
        peaks.append(f"device {device}, peak allocated "
                     + ("not measured" if peak is None else f"{peak} bytes"))
    log.warning(
        "  stage walls: ingest %.3f s, consolidate %.3f s, sPCR %.3f s; %s",
        walls["ingest"], walls["consolidate"], walls["spcr"],
        "; ".join(peaks),
    )
    # and its count stage's spans and host syncs (utils/phases)
    log.warning("  count trace: %s",
                phases.current().describe(*COUNT_SPANS))

    # ---- stats -------------------------------------------------------------
    command = " ".join(
        shlex.quote(a) for a in (["sharkmer"] + (argv if argv is not None else sys.argv[1:]))
    )
    run_stats = RunStats(
        sharkmer_version=__version__,
        command=command,
        sample=sample,
        kmer_length=k,
        chunks=args.chunks,
        n_reads_read=engine.stats.n_reads_read,
        n_bases_read=engine.stats.n_bases_read,
        n_subreads_ingested=engine.stats.n_reads_ingested,
        n_bases_ingested=engine.stats.n_bases_ingested,
        n_kmers=engine.stats.n_kmers_ingested,
        n_multi_kmers=(
            engine.stats.n_kmers_ingested - n_singleton_kmers
            if n_singleton_kmers is not None
            else None
        ),
        n_singleton_kmers=n_singleton_kmers,
        peak_memory_bytes=peak_memory_bytes(),
        pcr_results=pcr_results,
    )
    write_stats(run_stats, directory, sample)
    print_summary(run_stats, time.monotonic() - start_run)
    return 0


class ReadPlan:
    """How to re-acquire reads for Pass 2 (io.rs:18-34)."""

    def __init__(self, source_kind: str, paths_or_urls: list, paired: bool,
                 max_reads: int):
        self.source_kind = source_kind  # local | cached | uncached | unavailable
        self.paths_or_urls = paths_or_urls
        self.paired = paired
        self.max_reads = max_reads


def _with_progress(seqs, engine: CountingEngine):
    """Tick the tty progress line every 4096 reads (io.rs:392-410)."""
    from .utils.progress import get_progress

    progress = get_progress()
    for i, s in enumerate(seqs):
        if (i & 0xFFF) == 0:
            progress.tick(
                f"Ingesting reads... {engine.stats.n_reads_read:,} reads "
                f"({engine.stats.n_bases_read / 1e6:,.1f} Mbp)"
            )
        yield s


def _ingest_all(args, engine: CountingEngine, max_reads: int,
                cache_config, cached_ena) -> ReadPlan:
    """Feed all input sources into the engine (io.rs:366-537)."""
    plan = ReadPlan("unavailable", [], args.paired, max_reads)

    if args.ena:
        from .io.ena import get_ena_fastq_urls

        ena_result = cached_ena or get_ena_fastq_urls(args.ena)
        cached_paths = []
        for url in ena_result.urls:
            if cache_config is not None:
                local = cache_config.lookup(url, max_reads)
                if local is not None:
                    log.info("Cache hit for %s", url)
                else:
                    log.info("Cache miss for %s, downloading...", url)
                    local = cache_config.download_to_cache(url, max_reads)
                cached_paths.append(local)
                stream = fastq_mod.open_fastq(local)
                name = str(local)
            else:
                import gzip
                import urllib.request

                log.info("Streaming from %s (no cache)...", url)
                resp = urllib.request.urlopen(url, timeout=60)
                stream = gzip.GzipFile(fileobj=resp) if url.endswith(".gz") else resp
                name = url
            try:
                reached = engine.ingest(
                    _with_progress(
                        fastq_mod.read_fastq_records(
                            stream, args.validate_every, name
                        ),
                        engine,
                    ),
                    max_reads,
                )
            except (ConnectionError, TimeoutError, EOFError, OSError) as e:
                # mid-stream drop classifier (io.rs:213-265): distinguish
                # transient network failures from corrupt files and point
                # at the cache as the remediation
                if name.startswith(("http://", "https://", "ftp://")):
                    raise OSError(
                        f"Stream from {name} dropped while reading record "
                        f"{engine.stats.n_reads_read + 1} ({e}).\n"
                        f"This is usually a transient network interruption, "
                        f"not a bad FASTQ file.\nRetry the run. If it "
                        f"repeats, use the read cache (the default for "
                        f"--ena); cached downloads are verified by SHA-256 "
                        f"and do not suffer mid-stream drops."
                    ) from e
                raise OSError(
                    f"Local read stream ended unexpectedly while reading "
                    f"record {engine.stats.n_reads_read + 1} in {name} "
                    f"({e}). The file may be truncated or corrupted."
                ) from e
            if reached:
                break
        if cache_config is not None:
            plan = ReadPlan("cached", cached_paths, False, max_reads)
        else:
            log.warning(
                "Read threading will require re-downloading reads from ENA "
                "(no cache)"
            )
            plan = ReadPlan("uncached", list(ena_result.urls), False, max_reads)
    elif args.input:
        if args.paired:
            # round max_reads up to even for balanced pairs (io.rs:483-495)
            if max_reads > 0 and max_reads % 2 != 0:
                max_reads += 1
                plan.max_reads = max_reads
            s1 = fastq_mod.open_fastq(args.input[0])
            s2 = fastq_mod.open_fastq(args.input[1])
            engine.ingest(
                _with_progress(
                    fastq_mod.read_fastq_paired(
                        s1, s2, args.validate_every,
                        str(args.input[0]), str(args.input[1]),
                    ),
                    engine,
                ),
                max_reads,
            )
        else:
            from .io import native as native_mod

            use_native = native_mod.available()
            if use_native:
                log.info("Using native FASTQ loader")
            for path in args.input:
                if use_native:
                    from .utils.progress import get_progress

                    progress = get_progress()
                    reached = False
                    with native_mod.NativeFastqReader(
                        str(path), args.validate_every
                    ) as reader:
                        # producer thread overlaps gzip decode with this
                        # loop's device uploads; large batches amortize
                        # the per-upload cost
                        with native_mod.PrefetchingBatches(
                            reader, batch_reads=1 << 17, depth=3
                        ) as batches:
                            for batch in batches:
                                if engine.ingest_code_batch(*batch, max_reads):
                                    reached = True
                                    break
                                progress.tick(
                                    f"Ingesting reads... "
                                    f"{engine.stats.n_reads_read:,} reads "
                                    f"({engine.stats.n_bases_read / 1e6:,.1f} Mbp)"
                                )
                else:
                    stream = fastq_mod.open_fastq(path)
                    reached = engine.ingest(
                        _with_progress(
                            fastq_mod.read_fastq_records(
                                stream, args.validate_every, str(path),
                                start_record=engine.stats.n_reads_read,
                            ),
                            engine,
                        ),
                        max_reads,
                    )
                if reached:
                    break
        plan = ReadPlan("local", list(args.input), args.paired, max_reads)
    else:
        if sys.stdin.isatty():
            raise ValueError(
                "No input files specified and stdin is a terminal.\n"
                "Provide FASTQ files as arguments, use --ena, or pipe data "
                "via stdin.\n"
                "Example: sharkmer -s sample -k 21 reads.fastq\n"
                "Example: sharkmer -s sample --ena SRR5324768\n"
                "Example: zcat reads.fastq.gz | sharkmer -s sample -k 21"
            )
        engine.ingest(
            _with_progress(
                fastq_mod.read_fastq_records(
                    sys.stdin.buffer, args.validate_every, "stdin"
                ),
                engine,
            ),
            max_reads,
        )
    return plan


def _reread_sequences(plan: ReadPlan) -> list[ReadRecord] | None:
    """Pass 2: re-read sequences for threading (io.rs:769-941)."""
    if plan.source_kind == "unavailable":
        log.info(
            "Read threading unavailable (stdin input); using kmer-only scoring"
        )
        return None

    log.info("Pass 2: re-reading sequences for read threading...")
    files = list(plan.paths_or_urls)
    tempfiles = []
    if plan.source_kind == "uncached":
        import tempfile
        import urllib.request

        log.warning(
            "Re-downloading reads for Pass 2 (use --cache-dir to avoid this)"
        )
        paths = []
        for url in files:
            log.info("Downloading %s for Pass 2...", url)
            tmp = tempfile.NamedTemporaryFile(
                prefix="sharkmer_pass2_", suffix=".fastq.gz", delete=False
            )
            with urllib.request.urlopen(url, timeout=60) as resp:
                import shutil

                shutil.copyfileobj(resp, tmp)
            tmp.close()
            paths.append(tmp.name)
            tempfiles.append(tmp.name)
        files = paths

    records: list[ReadRecord] = []
    index = 0
    try:
        if plan.paired and len(files) == 2:
            s1 = fastq_mod.open_fastq(files[0])
            s2 = fastq_mod.open_fastq(files[1])
            for i, seq in enumerate(
                fastq_mod.read_fastq_paired(s1, s2, 0, str(files[0]), str(files[1]))
            ):
                mate = Mate.R1 if i % 2 == 0 else Mate.R2
                records.append(ReadRecord(seq.decode(), index, mate))
                index += 1
                if plan.max_reads > 0 and index >= plan.max_reads:
                    break
        else:
            for path in files:
                stream = fastq_mod.open_fastq(path)
                for seq in fastq_mod.read_fastq_records(stream, 0, str(path)):
                    records.append(ReadRecord(seq.decode(), index, Mate.UNPAIRED))
                    index += 1
                    if plan.max_reads > 0 and index >= plan.max_reads:
                        break
                if plan.max_reads > 0 and index >= plan.max_reads:
                    break
    finally:
        for t in tempfiles:
            try:
                os.unlink(t)
            except OSError:
                pass
    log.info("Pass 2: collected %d reads for threading", index)
    return records


if __name__ == "__main__":
    sys.exit(main())
