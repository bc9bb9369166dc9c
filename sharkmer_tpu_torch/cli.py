"""Command-line interface.

Flag surface mirrors the reference CLI (upstream sharkmer src/cli.rs):
inputs (files / --ena / stdin), PCR sources (--pcr-panel,
--pcr-panel-file, --pcr-primers), early exits (--list-panels,
--export-panel, --help-pcr, --cite, --completions, --clear-cache,
--validate-panels, --dry-run), counting knobs (-k, --chunks,
--histo-max), general knobs, hidden tuning flags, and cache controls.
"""

from __future__ import annotations

import argparse
import logging
import sys

from . import __version__
from .io.ena import EnaResult, get_ena_fastq_urls
from .pcr import panels as panels_mod
from .pcr.params import (
    DEFAULT_DEDUP_EDIT_THRESHOLD,
    DEFAULT_HIGH_COVERAGE_RATIO,
    DEFAULT_MAX_DFS_STATES,
    DEFAULT_MAX_NODE_VISITS,
    DEFAULT_MAX_NUM_PRIMER_KMERS,
    DEFAULT_MAX_PATHS_PER_PAIR,
    DEFAULT_TIP_COVERAGE_FRACTION,
    PCRParams,
    validate_pcr_params,
)

log = logging.getLogger("sharkmer")

EPILOG = """\
Example:
  Extract cnidarian genes from ENA reads (downloads automatically):
  sharkmer --ena SRR23143286 --pcr-panel cnidaria -m 1000000 -o output

Output files:
  {outdir}/{sample}.stats.yaml             Run statistics (always produced)

  PCR:
  {outdir}/{sample}_{gene}.fasta           sPCR products per gene

  Incremental counting (--chunks > 0):
  {outdir}/{sample}.histo                  All incremental histograms
  {outdir}/{sample}.final.histo            Final histogram"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sharkmer",
        description="A TPU-native tool for kmer counting and in silico PCR (sPCR)",
        epilog=EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--version", action="version", version=f"sharkmer-tpu {__version__}")
    p.add_argument("input", nargs="*", default=None,
                   help="FASTQ input files (.fastq or .fastq.gz). Reads from "
                        "stdin if omitted")
    p.add_argument("--ena", metavar="ACCESSION",
                   help="Stream reads directly from ENA by accession "
                        "(e.g. SRR5324768)")
    p.add_argument("-s", "--sample",
                   help="Sample name (output file prefix; required unless "
                        "--ena derives it)")
    p.add_argument("-o", "--outdir", default="./", help="Output directory")
    p.add_argument("--pcr-panel", action="append", default=[],
                   help="Use a preconfigured primer panel (repeatable)")
    p.add_argument("--pcr-panel-file", action="append", default=[],
                   help="Load a primer panel from a YAML file or URL (repeatable)")
    p.add_argument("--pcr-primers", action="append", default=[],
                   help="Specify a primer pair inline (repeatable, see --help-pcr)")
    p.add_argument("--list-panels", action="store_true",
                   help="List available primer panels and exit")
    p.add_argument("--export-panel", metavar="NAME",
                   help="Export a built-in panel as YAML to stdout and exit")
    p.add_argument("--help-pcr", action="store_true",
                   help="Show detailed help for --pcr-primers format")
    p.add_argument("-k", type=int, default=19, help="Kmer length")
    p.add_argument("--chunks", type=int, default=0,
                   help="Number of incremental chunks (0 = skip histograms)")
    p.add_argument("--histo-max", type=int, default=10000,
                   help="Maximum histogram count value")
    p.add_argument("-t", "--threads", type=int, default=1, help="Number of threads")
    p.add_argument("-m", "--max-reads", type=int, default=None,
                   help="Maximum number of reads to process (default: all)")
    p.add_argument("--min-kmer-count", type=int, default=2,
                   help="Minimum kmer count for sPCR (filters low-count kmers "
                        "before PCR)")
    p.add_argument("--validate-every", type=int, default=0,
                   help="Validate FASTQ format every N records (0 = first "
                        "record only)")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="Increase verbosity (-v info, -vv debug, -vvv trace)")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="Suppress all output except errors")
    p.add_argument("--color", choices=["auto", "always", "never"], default="auto",
                   help="Color output")
    p.add_argument("--cite", action="store_true",
                   help="Print citation information and exit")
    p.add_argument("--completions", metavar="SHELL",
                   choices=["bash", "zsh", "fish"],
                   help="Print shell tab-completion script and exit")
    p.add_argument("--dump-graph", action="store_true",
                   help="Write assembly graphs as annotated DOT (Graphviz) files")
    p.add_argument("--validate-panels", action="store_true",
                   help="Validate primer panels/primers and exit")
    p.add_argument("--dry-run", action="store_true",
                   help="Validate inputs and print what would happen, then exit")
    # hidden tuning flags
    p.add_argument("--node-budget-global", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--max-dfs-states", type=int, default=DEFAULT_MAX_DFS_STATES,
                   help=argparse.SUPPRESS)
    p.add_argument("--max-paths-per-pair", type=int,
                   default=DEFAULT_MAX_PATHS_PER_PAIR, help=argparse.SUPPRESS)
    p.add_argument("--max-node-visits", type=int, default=DEFAULT_MAX_NODE_VISITS,
                   help=argparse.SUPPRESS)
    p.add_argument("--max-primer-kmers", type=int,
                   default=DEFAULT_MAX_NUM_PRIMER_KMERS, help=argparse.SUPPRESS)
    p.add_argument("--high-coverage-ratio", type=float,
                   default=DEFAULT_HIGH_COVERAGE_RATIO, help=argparse.SUPPRESS)
    p.add_argument("--tip-coverage-fraction", type=float,
                   default=DEFAULT_TIP_COVERAGE_FRACTION, help=argparse.SUPPRESS)
    p.add_argument("--read-threading", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--paired", action="store_true", help=argparse.SUPPRESS)
    # device/sharding knobs (TPU build additions)
    p.add_argument("--table-capacity", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--n-shards", type=int, default=1,
                   help="Shard the count table over N devices (1 = single chip)")
    p.add_argument("--backend", choices=["sorted", "hash"], default="sorted",
                   help="Count-table backend: sorted runs (TPU-fast) or "
                        "open-addressed hash table")
    # hidden: sPCR lookup strategy. auto = device reach-prefetch on the
    # sorted backend (table stays on device; only the walk's own
    # neighbourhood crosses the link); full = one-time full host
    # mirror; device = per-wave device lookups. --no-mirror is the
    # legacy alias for --mirror device.
    p.add_argument("--mirror", choices=["auto", "full", "device"],
                   default="auto", help=argparse.SUPPRESS)
    p.add_argument("--no-mirror", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--save-table", metavar="PATH",
                   help="Checkpoint the consolidated count table to PATH "
                        "(.npz) after Pass 1")
    p.add_argument("--load-table", metavar="PATH",
                   help="Skip ingestion; load a count-table checkpoint and "
                        "run sPCR directly")
    p.add_argument("--cache-dir", help="Override cache directory for remote reads")
    p.add_argument("--no-cache", action="store_true",
                   help="Disable read caching (stream directly)")
    p.add_argument("--clear-cache", action="store_true",
                   help="Delete the read cache directory and exit")
    return p


def parse_pcr_primers_string(pcr_string: str) -> PCRParams:
    """Inline key=value,... primer spec (cli.rs:12-140)."""
    if not pcr_string:
        raise ValueError("Invalid empty primer specification")
    fields = {
        "name": "", "forward": "", "reverse": "", "max-length": 10000,
        "min-length": 0, "min-count": 2, "mismatches": 2, "trim": 15,
        "citation": "", "notes": "",
        "dedup-edit-threshold": DEFAULT_DEDUP_EDIT_THRESHOLD,
    }
    int_keys = {"max-length", "min-length", "min-count", "mismatches", "trim",
                "dedup-edit-threshold"}
    seen: set[str] = set()
    for item in pcr_string.split(","):
        if "=" not in item:
            raise ValueError(
                f"Invalid parameter (should be key=value): '{item}'\n"
                f"Commas are not allowed in field values. Use "
                f"--pcr-panel-file with a YAML panel for complex metadata."
            )
        raw_key, value = item.split("=", 1)
        key = raw_key.lower()
        if key in seen:
            raise ValueError(
                f"Duplicate parameter '{key}' in primer specification "
                f"'{pcr_string}'. Each key may appear at most once."
            )
        seen.add(key)
        if key not in fields:
            raise ValueError(f"Unexpected parameter: {key}")
        if key in int_keys:
            try:
                fields[key] = int(value)
            except ValueError:
                raise ValueError(f"Invalid value for {key}: {value}") from None
        elif key in ("forward", "reverse"):
            fields[key] = value.upper()
        else:
            fields[key] = value

    return PCRParams(
        forward_seq=fields["forward"],
        reverse_seq=fields["reverse"],
        gene_name=fields["name"],
        min_length=fields["min-length"],
        max_length=fields["max-length"],
        min_count=fields["min-count"],
        mismatches=fields["mismatches"],
        trim=fields["trim"],
        citation=fields["citation"],
        notes=fields["notes"],
        dedup_edit_threshold=fields["dedup-edit-threshold"],
        source=f'--pcr-primers "{pcr_string}"',
    )


def init_logging(verbose: int, quiet: bool, color: str = "auto") -> None:
    """-v info, -vv debug, -vvv trace; default warn (cli.rs:331-384)."""
    if quiet:
        level = logging.ERROR
    elif verbose == 0:
        level = logging.WARNING
    elif verbose == 1:
        level = logging.INFO
    else:
        level = logging.DEBUG

    use_color = (color == "always") or (color == "auto" and sys.stderr.isatty())

    class _Formatter(logging.Formatter):
        COLORS = {
            logging.ERROR: "\x1b[1;31m",
            logging.INFO: "\x1b[1;36m",
            logging.DEBUG: "\x1b[2m",
        }
        LABELS = {
            logging.ERROR: "error",
            logging.INFO: "info",
            logging.DEBUG: "debug",
        }

        def format(self, record):
            msg = record.getMessage()
            if record.levelno == logging.WARNING:
                return msg  # warn-level: bare message (status output)
            label = self.LABELS.get(record.levelno, record.levelname.lower())
            if use_color:
                c = self.COLORS.get(record.levelno, "")
                return f"{c}{label}\x1b[0m {msg}"
            return f"{label} {msg}"

    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_Formatter())
    logger = logging.getLogger("sharkmer")
    logger.handlers.clear()
    logger.addHandler(handler)
    logger.setLevel(level)
    # root has no handlers of its own, so propagation costs nothing and
    # keeps pytest's caplog (attached at root) working
    logger.propagate = True


CITATION = f"""sharkmer-tpu {__version__}

If you use sharkmer in published work, please cite:

For in silico PCR:

  Dunn and Church (2026) Sharkmer: repurposing PCR primers for
  targeted genome assembly using in silico PCR.
  Bioinformatics, btag163.
  doi: 10.1093/bioinformatics/btag163

For incremental kmer counting:

  Ahuja et al. (2024) Giants among Cnidaria: Large Nuclear Genomes and
  Rearranged Mitochondrial Genomes in Siphonophores.
  Genome Biology and Evolution, 16(3).
  doi: 10.1093/gbe/evae048
"""

HELP_PCR = """Inline primer specification format for --pcr-primers:

  --pcr-primers "key1=value1,key2=value2,..."

Example:
  --pcr-primers "forward=GRCTGTTTACCAAAAACATA,reverse=AATTCAACATMGAGG,max-length=700,name=16s,min-length=500"

Required keys:
  forward       Forward primer sequence (5' to 3')
  reverse       Reverse primer sequence (5' to 3' on opposite strand)
  name          Unique name for the primer pair or gene region

Optional keys:
  min-length              Minimum product length including primers [0]
  max-length              Maximum product length including primers [10000]
  min-count               Minimum kmer count for graph extension [2]
  mismatches              Maximum primer-kmer mismatches [2]
  trim                    Bases to keep at 3' end of each primer [15]
  dedup-edit-threshold    Levenshtein distance for deduplication [10]

Primer sequences support IUPAC ambiguity codes:
  R (A/G)  Y (C/T)  S (G/C)  W (A/T)  K (G/T)  M (A/C)
  B (C/G/T)  D (A/G/T)  H (A/C/T)  V (A/C/G)  N (A/C/G/T)

Multiple primer pairs can be specified by repeating the flag:
  --pcr-primers "..." --pcr-primers "..."

Note: when using --pcr-panel or --pcr-panel-file, gene names in output
files are prefixed with the panel name (e.g., cnidaria_18S).
Inline --pcr-primers gene names are used as-is.
"""

_ALL_OPTS = (
    "--ena --sample --outdir --pcr-panel --pcr-panel-file --pcr-primers "
    "--list-panels --export-panel --help-pcr -k --chunks --histo-max "
    "--threads --max-reads --min-kmer-count --validate-every --verbose "
    "--quiet --color --cite --completions --dump-graph --validate-panels "
    "--dry-run --n-shards --backend --no-mirror --save-table --load-table "
    "--cache-dir --no-cache --clear-cache --version"
)

_COMPLETIONS = {
    "bash": f"""\
_sharkmer() {{
    local cur="${{COMP_WORDS[COMP_CWORD]}}"
    COMPREPLY=( $(compgen -W "{_ALL_OPTS}" -- "$cur") )
}}
complete -o default -F _sharkmer sharkmer
""",
    "zsh": f"""\
#compdef sharkmer
_sharkmer() {{
    _arguments '*: :_files'
    _values 'options' {" ".join(o for o in _ALL_OPTS.split())}
}}
compdef _sharkmer sharkmer
""",
    "fish": "\n".join(
        f"complete -c sharkmer -l {o.lstrip('-')}"
        for o in _ALL_OPTS.split()
        if o.startswith("--")
    )
    + "\n",
}


def handle_early_exits(args) -> None:
    """Flags that print and exit (cli.rs:388-488)."""
    if args.clear_cache:
        from .io.cache import CacheConfig

        CacheConfig.clear(args.cache_dir)
        print("Cache cleared.")
        sys.exit(0)
    if args.completions:
        print(_COMPLETIONS[args.completions])
        sys.exit(0)
    if args.cite:
        print(CITATION)
        sys.exit(0)
    if args.list_panels:
        panels_mod.print_pcr_panels()
        sys.exit(0)
    if args.export_panel:
        print(panels_mod.export_panel_yaml(args.export_panel), end="")
        sys.exit(0)
    if args.help_pcr:
        print(HELP_PCR)
        sys.exit(0)


def collect_pcr_params(args) -> list[PCRParams]:
    """Collect + validate primers from all sources (cli.rs:492-583)."""
    pcr_runs: list[PCRParams] = []
    for panel_name in args.pcr_panel:
        params = panels_mod.get_panel(panel_name)
        for p in params:
            p.source = f"built-in panel '{panel_name}'"
        pcr_runs.extend(params)
    for panel_source in args.pcr_panel_file:
        params = panels_mod.load_panel_source(panel_source)
        kind = "URL" if panels_mod.is_url(panel_source) else "file"
        for p in params:
            p.source = f"panel {kind} '{panel_source}'"
        pcr_runs.extend(params)
    for pcr_string in args.pcr_primers:
        pcr_runs.append(parse_pcr_primers_string(pcr_string))

    # validate all primers, collecting all errors
    total_errors = 0
    report_lines = []
    for p in pcr_runs:
        errors = validate_pcr_params(p)
        if errors:
            total_errors += len(errors)
            report_lines.append(f"\n  {p.gene_name} ({p.source}):")
            for err, suggestion in errors:
                report_lines.append(f"    - {err}\n      Suggestion: {suggestion}")
    if total_errors:
        s = "" if total_errors == 1 else "s"
        raise ValueError(
            f"Primer validation failed ({total_errors} error{s}):"
            + "\n".join(report_lines)
        )

    # clamp min_count up to --min-kmer-count with a warning
    for p in pcr_runs:
        if p.min_count < args.min_kmer_count:
            log.warning(
                "%s: min-count (%d) is less than --min-kmer-count (%d). "
                "Kmers below %d have already been filtered. Using %d as "
                "effective min-count.",
                p.gene_name, p.min_count, args.min_kmer_count,
                args.min_kmer_count, args.min_kmer_count,
            )
            p.min_count = args.min_kmer_count

    # no duplicate gene names
    seen: set[str] = set()
    for p in pcr_runs:
        if p.gene_name in seen:
            raise ValueError(
                f"Duplicate gene name '{p.gene_name}' (from {p.source})"
            )
        seen.add(p.gene_name)
    return pcr_runs


def apply_tuning_overrides(args, pcr_runs: list[PCRParams]) -> None:
    """CLI tuning flags clobber panel values globally (main.rs:49-56)."""
    for p in pcr_runs:
        p.max_dfs_states = args.max_dfs_states
        p.max_paths_per_pair = args.max_paths_per_pair
        p.max_node_visits = args.max_node_visits
        p.max_primer_kmers = args.max_primer_kmers
        p.high_coverage_ratio = args.high_coverage_ratio
        p.tip_coverage_fraction = args.tip_coverage_fraction


def handle_validate_panels(pcr_runs: list[PCRParams]) -> None:
    """cli.rs:587-615."""
    if not pcr_runs:
        raise ValueError(
            "--validate-panels requires at least one of --pcr-panel, "
            "--pcr-panel-file, or --pcr-primers"
        )
    print(f"Validated {len(pcr_runs)} primer pairs:\n")
    for p in pcr_runs:
        print(f"  {p.gene_name}")
        print(f"    forward:  {p.forward_seq} ({len(p.forward_seq)} bp)")
        print(f"    reverse:  {p.reverse_seq} ({len(p.reverse_seq)} bp)")
        print(f"    length:   {p.min_length}-{p.max_length} bp")
        print(f"    min-count: >= {p.min_count}")
        print(
            f"    mismatches: {p.mismatches}, trim: {p.trim}, "
            f"dedup-edit-threshold: {p.dedup_edit_threshold}"
        )
    print("\nAll primers valid.")
    sys.exit(0)


def resolve_sample_name(args) -> tuple[str, EnaResult | None]:
    """--sample, or derived from ENA metadata (cli.rs:619-655)."""
    cached_ena: EnaResult | None = None
    if args.sample:
        sample = args.sample
    elif args.ena:
        ena_result = get_ena_fastq_urls(args.ena)
        if ena_result.scientific_name:
            genus_species = ena_result.scientific_name.replace(" ", "_")
            sample = f"{genus_species}_{args.ena}"
        else:
            sample = args.ena
        log.warning(
            "No --sample provided, using '%s' derived from ENA metadata", sample
        )
        cached_ena = ena_result
    else:
        raise ValueError(
            "--sample is required. Provide a sample name as output file "
            "prefix.\nWhen using --ena, the sample name can be derived "
            "automatically from ENA metadata."
        )

    if not all(c.isalnum() or c in "_-." for c in sample):
        raise ValueError(
            f"Sample name '{sample}' contains characters that are unsafe "
            f"for filenames. Use only alphanumeric characters, hyphens, "
            f"underscores, and periods."
        )
    return sample, cached_ena


def validate_args(args, pcr_runs: list[PCRParams]) -> None:
    """cli.rs:659-749."""
    import os

    k = args.k
    if k >= 32:
        raise ValueError(
            "k must be less than 32 due to use of 64 bit integers to encode kmers"
        )
    if k <= 0:
        raise ValueError("k must be greater than 0")
    if k % 2 == 0:
        raise ValueError("k must be odd")
    if args.histo_max <= 0:
        raise ValueError("histo_max must be greater than 0")
    if args.histo_max > 1_000_000:
        raise ValueError(
            f"histo_max must not exceed 1000000, got {args.histo_max}"
        )
    if args.min_kmer_count < 1:
        raise ValueError("min-kmer-count must be at least 1")

    if args.ena and args.input:
        raise ValueError(
            "--ena cannot be combined with input files. Use one or the other."
        )
    if args.paired:
        if args.ena:
            raise ValueError(
                "--paired cannot be combined with --ena. Provide exactly 2 "
                "local input files."
            )
        if not args.input:
            raise ValueError(
                "--paired requires exactly 2 input files (R1, R2). Cannot "
                "use stdin."
            )
        if len(args.input) != 2:
            raise ValueError(
                f"--paired requires exactly 2 input files (R1, R2), got "
                f"{len(args.input)}"
            )
    if args.input:
        canonical = set()
        for f in args.input:
            if not os.path.exists(f):
                raise ValueError(f"Input file does not exist: {f}")
            if not os.path.isfile(f):
                raise ValueError(f"Input path is not a file: {f}")
            real = os.path.realpath(f)
            if real in canonical:
                log.warning(
                    "Duplicate input file: %s (same as previous entry after "
                    "path resolution)", f,
                )
            canonical.add(real)
    for panel_source in args.pcr_panel_file:
        if not panels_mod.is_url(panel_source):
            if not os.path.exists(panel_source):
                raise ValueError(
                    f"PCR panel file does not exist: {panel_source}"
                )
    if args.chunks == 0 and not pcr_runs:
        log.warning(
            "No --pcr-panel/--pcr-panel-file/--pcr-primers and --chunks is "
            "0: only a stats file will be produced"
        )


def handle_dry_run(args, sample: str, directory: str, pcr_runs) -> None:
    """cli.rs:753-821."""
    print(f"sharkmer-tpu {__version__} (dry run)", file=sys.stderr)
    print(file=sys.stderr)
    print("Input:", file=sys.stderr)
    if args.ena:
        print(f"  ENA accession: {args.ena}", file=sys.stderr)
    elif args.input:
        for f in args.input:
            print(f"  {f}", file=sys.stderr)
    else:
        print("  stdin", file=sys.stderr)
    print(file=sys.stderr)
    print("Configuration:", file=sys.stderr)
    print(f"  Sample:         {sample}", file=sys.stderr)
    print(f"  Output dir:     {directory}", file=sys.stderr)
    print(f"  Kmer length:    {args.k}", file=sys.stderr)
    print(f"  Chunks:         {args.chunks}", file=sys.stderr)
    print(f"  Threads:        {args.threads}", file=sys.stderr)
    print(f"  Min kmer count: {args.min_kmer_count}", file=sys.stderr)
    if args.max_reads:
        print(f"  Max reads:      {args.max_reads}", file=sys.stderr)
    print(file=sys.stderr)
    print("Output files:", file=sys.stderr)
    print(f"  {directory}{sample}.stats.yaml", file=sys.stderr)
    if args.chunks > 0:
        print(f"  {directory}{sample}.histo", file=sys.stderr)
        print(f"  {directory}{sample}.final.histo", file=sys.stderr)
    for p in pcr_runs:
        print(f"  {directory}{sample}_{p.gene_name}.fasta", file=sys.stderr)
    if pcr_runs:
        print(file=sys.stderr)
        s = "" if len(pcr_runs) == 1 else "s"
        print(f"PCR primers ({len(pcr_runs)} gene{s}):", file=sys.stderr)
        for p in pcr_runs:
            fs, rs = p.forward_seq, p.reverse_seq
            print(
                f"  {p.gene_name} (fwd: {fs[:8]}...{fs[-4:]}, "
                f"rev: {rs[:8]}...{rs[-4:]}, len: "
                f"{p.min_length}-{p.max_length})",
                file=sys.stderr,
            )
    sys.exit(0)
