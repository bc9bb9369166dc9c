"""Run the port's CLI and parse its outputs.

The counterpart of ``scripts/sharkmer_validate/runner.py``: the same
names and the same run record, but it drives ``python -m
sharkmer_tpu_torch`` as a subprocess, with the port's panels, and the
record also keeps the CLI's ``stage walls:`` line (logged at WARNING on
stderr at the end of every run): ``stage_walls`` (ingest, consolidate
and sPCR, in seconds) and ``device_peak_bytes`` (each device's peak
allocation; None where the device has no allocator to read, the CPU).
The CLI runs on ``cuda`` unless ``SHARKMER_TORCH_DEVICE=cpu`` is set in
the environment the subprocess inherits.
"""

from __future__ import annotations

import glob
import os
import platform
import re
import subprocess
import sys
import time
from pathlib import Path

import yaml

REPO_ROOT = Path(__file__).resolve().parents[3]
PANELS_DIR = REPO_ROOT / "sharkmer_tpu_torch" / "panels"
DATA_DIR = REPO_ROOT / "benchmarks" / "data"
CACHE_DIR = DATA_DIR / "cache"

K = 19
THREADS = 8
DEFAULT_MAX_READS = [1_000_000]


def sharkmer_cmd() -> list[str]:
    return [sys.executable, "-m", "sharkmer_tpu_torch"]


def get_sharkmer_version() -> str:
    result = subprocess.run(
        sharkmer_cmd() + ["--version"], capture_output=True, text=True,
        cwd=REPO_ROOT,
    )
    out = result.stdout.strip()
    parts = out.split()
    return parts[-1] if parts else out


def get_git_commit() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=REPO_ROOT,
        ).stdout.strip()
    except OSError:
        return "unknown"


def get_machine_info() -> dict:
    return {
        "platform": platform.platform(),
        "machine": platform.machine(),
        "processor": platform.processor() or platform.machine(),
        "cpu_count": os.cpu_count(),
        "python": platform.python_version(),
    }


def get_panel_version(panel_data: dict) -> str:
    return str(panel_data.get("panel_version", "unversioned"))


def derive_gene_name(primer: dict) -> str:
    gene = primer.get("gene", "")
    region = primer.get("region")
    index = primer.get("index")
    name = gene
    if region is not None:
        name = f"{gene}-{region}"
    if index is not None:
        name = f"{name}_{index}"
    return name


def load_panel(panel_path: Path) -> dict:
    with open(panel_path) as f:
        return yaml.safe_load(f)


_WALLS = re.compile(r"stage walls: ingest ([0-9.]+) s, consolidate ([0-9.]+) "
                    r"s, sPCR ([0-9.]+) s; (.*)$")
_PEAK = re.compile(r"device (\S+), peak allocated (?:(\d+) bytes|not measured)")


def parse_stage_walls(stderr: str) -> tuple[dict, dict] | None:
    """The last ``stage walls:`` line of a run's log as (stage walls in
    s, each device's peak allocated bytes or None), or None."""
    found = None
    for line in stderr.splitlines():
        match = _WALLS.search(line)
        if match:
            found = match
    if found is None:
        return None
    walls = {"ingest": float(found.group(1)),
             "consolidate": float(found.group(2)),
             "spcr": float(found.group(3))}
    peaks = {device: int(peak) if peak else None
             for device, peak in _PEAK.findall(found.group(4))}
    return walls, peaks


def read_fasta_sequences(path: str) -> list[str]:
    seqs: list[str] = []
    current: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if current:
                    seqs.append("".join(current))
                    current = []
            else:
                current.append(line)
    if current:
        seqs.append("".join(current))
    return seqs


def run_sharkmer(
    panel_path: Path,
    accession: str,
    max_reads: int,
    outdir: Path,
    k: int = K,
    threads: int = THREADS,
    extra_args: list[str] | None = None,
    timeout: int = 3600,
    fastq_path: Path | None = None,
) -> dict:
    """Run one pipeline invocation; returns a run record dict.

    ``fastq_path`` switches from ENA streaming to a local FASTQ (the
    offline synthetic benchmark grid); the record keeps ``accession``
    as its sample label either way."""
    outdir.mkdir(parents=True, exist_ok=True)
    sample = f"{accession}_{max_reads}"
    cmd = sharkmer_cmd() + [
        "-s", sample,
        "-k", str(k),
        "-t", str(threads),
        "-m", str(max_reads),
        "-o", str(outdir),
        "--pcr-panel-file", str(panel_path),
    ]
    if fastq_path is not None:
        cmd.append(str(fastq_path))
    else:
        cmd += ["--ena", accession, "--cache-dir", str(CACHE_DIR)]
    if extra_args:
        cmd.extend(extra_args)

    start = time.time()
    proc = subprocess.run(
        cmd, capture_output=True, text=True, cwd=REPO_ROOT, timeout=timeout
    )
    wall = time.time() - start

    run: dict = {
        "accession": accession,
        "max_reads": max_reads,
        "wall_time_seconds": round(wall, 1),
        "success": proc.returncode == 0,
        "returncode": proc.returncode,
        "genes": [],
    }
    if proc.returncode != 0:
        run["stderr_tail"] = proc.stderr[-2000:]
        return run
    walls = parse_stage_walls(proc.stderr)
    if walls is not None:
        run["stage_walls"], run["device_peak_bytes"] = walls

    stats_path = outdir / f"{sample}.stats.yaml"
    if stats_path.exists():
        with open(stats_path) as f:
            stats = yaml.safe_load(f)
        run["stats"] = {
            key: stats.get(key)
            for key in (
                "n_reads_read", "n_bases_read", "n_kmers",
                "n_singleton_kmers", "peak_memory_bytes",
            )
        }
        for gene_result in stats.get("pcr_results", []):
            gene_entry = {
                "gene": gene_result["gene_name"],
                "status": gene_result["status"],
                "n_products": gene_result.get("n_products", 0),
                "product_lengths": gene_result.get("product_lengths", []),
                "sequences": [],
            }
            if gene_result["status"] == "success":
                pattern = str(outdir / f"{sample}_{gene_result['gene_name']}.fasta")
                for fasta in glob.glob(pattern):
                    gene_entry["sequences"] = read_fasta_sequences(fasta)
            run["genes"].append(gene_entry)
    return run
