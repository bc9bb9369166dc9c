"""Result YAML model: panel -> samples -> depths -> genes.

Validation and benchmarks share this format, mirroring the reference's
results module so downstream tooling (sweep_summary, report) can
consume either.
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path

import yaml

from . import runner

RESULTS_DIR = runner.REPO_ROOT / "panels" / "validation_results"


def build_result(
    panel_path: Path,
    panel_data: dict,
    sample_results: list,
    sharkmer_version: str,
    blast_mode: str = "none",
    machine_info: dict | None = None,
    extra_args: list | None = None,
    sweep_label: str | None = None,
) -> dict:
    """sample_results: list of (sample_block, runs) tuples, each run a
    dict from runner.run_sharkmer()."""
    parameters: dict = {"k": runner.K, "threads": runner.THREADS}
    if extra_args:
        parameters["extra_args"] = list(extra_args)

    result = {
        "panel": panel_data.get("name", "unknown"),
        "panel_version": runner.get_panel_version(panel_data),
        "sharkmer_version": sharkmer_version,
        "git_commit": runner.get_git_commit(),
        "date": datetime.now().strftime("%Y-%m-%d"),
        "parameters": parameters,
        "blast_mode": blast_mode,
        "backend": "jax-tpu",
    }
    if sweep_label:
        result["sweep_label"] = sweep_label
    if machine_info:
        result["machine"] = machine_info

    samples = []
    for sample_block, runs in sample_results:
        entry = {
            "accession": sample_block.get("accession"),
            "taxon": sample_block.get("taxon"),
            "depths": [],
        }
        for run in runs:
            depth = {
                "max_reads": run["max_reads"],
                "success": run["success"],
                "wall_time_seconds": run.get("wall_time_seconds"),
            }
            if "stats" in run:
                depth["stats"] = run["stats"]
            depth["genes"] = [
                {
                    key: g[key]
                    for key in ("gene", "status", "n_products",
                                "product_lengths")
                }
                | ({"blast": g["blast"]} if "blast" in g else {})
                for g in run.get("genes", [])
            ]
            entry["depths"].append(depth)
        samples.append(entry)
    result["samples"] = samples
    return result


def result_filename(panel_name: str, panel_version: str,
                    sharkmer_version: str) -> str:
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    return f"{panel_name}_{panel_version}_{sharkmer_version}_{stamp}.yaml"


def write_result(result: dict, out_dir: Path | None = None) -> Path:
    out_dir = out_dir or RESULTS_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / result_filename(
        result["panel"], result["panel_version"], result["sharkmer_version"]
    )
    with open(path, "w") as f:
        yaml.safe_dump(result, f, sort_keys=False)
    return path


def load_result(path: Path) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)
