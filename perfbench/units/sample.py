"""A sample: a user's run after its FASTQ decode. The CLI's arguments are
parsed as ``main._run`` parses them, the engine counts as a count pass
does, and ``main._run_post_count`` does the rest: the sPCR lookup table
(``FilteredTable``), ``stats.run_pcr`` over the panel, the FASTA files
and ``stats.yaml``, written to a directory of the unit's own. The
traffic gives ``n_chunks``, ``min_kmer_count`` and ``mirror``.

Its own checks hold each pair's FASTA products to the product the
generator's amplicon implies (``reference/outputs``), and the run totals
of ``stats.yaml`` to the sample's.
"""

from __future__ import annotations

import os
import time

from .. import note
from ..reference import outputs as ref_outputs
from . import Done
from . import Unit as Base

SAMPLE_NAME = "bench"
# Each number compared, with its limit (PERF.md gives the readings).
LIMITS = {"amplicon_subst": 0, "products_wrong": 0, "stats_wrong": 0}


class Unit(Base):
    def __init__(self, *args):
        super().__init__(*args)
        self._time_spcr()
        self.genes = None

    def argv(self, outdir: str) -> list[str]:
        cfg, traffic = self.cfg, self.traffic
        return ["-s", SAMPLE_NAME, "-k", str(cfg["k"]),
                "-t", str(cfg["threads"]), "-o", outdir,
                "--pcr-panel-file", cfg["panel_file"],
                "--backend", cfg["backend"],
                "--table-capacity", str(cfg["initial_capacity"]),
                "--chunks", str(traffic["n_chunks"]),
                "--min-kmer-count", str(traffic["min_kmer_count"]),
                "--mirror", traffic["mirror"]]

    def run(self) -> Done:
        from sharkmer_tpu_torch import cli
        from sharkmer_tpu_torch import main as cli_main
        from sharkmer_tpu_torch.engine import CountingEngine
        from sharkmer_tpu_torch.utils import phases

        self.n += 1
        outdir = os.path.join(self.workdir, f"unit{self.n}") + "/"
        argv = self.argv(outdir)
        start = time.monotonic()
        args = cli.build_parser().parse_args(argv)
        cli.handle_early_exits(args)
        pcr_runs = cli.collect_pcr_params(args)
        cli.apply_tuning_overrides(args, pcr_runs)
        cli.validate_args(args, pcr_runs)
        if self.genes is None:
            self.genes = [p.gene_name for p in pcr_runs]
        os.makedirs(outdir)
        engine = CountingEngine(
            k=args.k, device=self.device, n_chunks=args.chunks,
            histo_max=args.histo_max, initial_capacity=args.table_capacity,
            n_shards=args.n_shards, backend=args.backend)
        with self.spans("count"):
            t0 = time.monotonic()
            self.ingest(engine)
            walls = {"ingest": time.monotonic() - t0}
            t0 = time.monotonic()
            spectra = engine.consolidate()
            self.sync()
            walls["consolidate"] = time.monotonic() - t0
        with self.spans("post_count"):
            rc = cli_main._run_post_count(args, argv, start, engine,
                                          SAMPLE_NAME, outdir, args.k,
                                          pcr_runs, spectra, walls)
        if rc != 0:
            raise RuntimeError(f"the sample's post-count stages gave {rc}")
        return Done(engine, spectra, self.sample.n_events, outdir,
                    phases.snapshot())

    def _time_spcr(self) -> None:
        """A span around each ``run_pcr`` call of ``main``."""
        from sharkmer_tpu_torch import main as cli_main

        run_pcr = getattr(cli_main.run_pcr, "__wrapped__", cli_main.run_pcr)

        def timed(*args, **kwargs):
            with self.spans("spcr"):
                return run_pcr(*args, **kwargs)

        timed.__wrapped__ = run_pcr  # a later Unit wraps the original
        cli_main.run_pcr = timed

    def checks(self, kept: list[Done]) -> tuple[dict, list[bool]]:
        """``amplicon_subst``: over the units and pairs, the most
        substitutions between a pair's best product and its expected one
        (a length difference counts each base; a pair with no product
        counts the expected length); ``products_wrong``: the products,
        over the units, that are not their pair's expected product, or
        repeat it; ``stats_wrong``: run totals of ``stats.yaml`` that
        differ from the sample's."""
        expected = ref_outputs.expected_products(
            self.cfg["panel_file"], self.sample.amplicons, self.cfg["k"])
        if self.genes is None or len(self.genes) != len(expected):
            raise RuntimeError(f"the panel gave {self.genes}, the "
                               f"generator {len(expected)} amplicons")
        found = dict.fromkeys(LIMITS, 0)
        wrong = []
        for i, done in enumerate(kept):
            subst = extra = 0
            for gene, want in zip(self.genes, expected):
                products = ref_outputs.fasta_seqs(os.path.join(
                    done.outdir, f"{SAMPLE_NAME}_{gene}.fasta"))
                d = [ref_outputs.product_subst(p, want) for p in products]
                if i == len(kept) - 1:
                    note(f"unit {i + 1} pair {gene}: expected "
                         f"{len(want)} bp; products "
                         + (", ".join(f"{len(p)} bp ({x} subst)"
                                      for p, x in zip(products, d))
                            or "none"))
                subst = max(subst, min(d, default=len(want)))
                extra += len(d) - (1 if 0 in d else 0)
            stats = ref_outputs.stats_wrong(
                os.path.join(done.outdir, f"{SAMPLE_NAME}.stats.yaml"),
                self.sample.n_reads, self.sample.n_bases,
                self.sample.n_events)
            found["amplicon_subst"] = max(found["amplicon_subst"], subst)
            found["products_wrong"] += extra
            found["stats_wrong"] += stats
            wrong.append(subst > 0 or extra > 0 or stats > 0)
        return ({name: {"value": int(found[name]), "limit": LIMITS[name]}
                 for name in LIMITS}, wrong)
