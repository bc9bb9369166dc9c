#!/usr/bin/env python3
"""The offline benchmark grid on the port: panel x sample x depth.

The counterpart of ``benchmarks/run_benchmark.py``, with the same flags
(``--config``, ``--panel``, ``--accession``, ``--max-reads``,
``--out-dir``). It runs ``python -m sharkmer_tpu_torch`` on each cell
(``tools/validate/runner.py``) and writes a result YAML and a markdown
report per panel, and a combined summary, as the JAX runner does.

It differs from the JAX runner in these places:

* The default config is ``benchmarks/benchmark_offline.yaml`` (synthetic
  reads), not ``benchmark.yaml``, whose ENA accessions need the network.
* Cell outputs go to ``--work-dir`` (``build/grid/work/<panel>/<sample>/
  <N>/``) and results to ``--out-dir`` (``build/grid/results/``). Nothing
  is written into ``benchmarks/work/<panel>/``: those directories hold
  the JAX package's committed outputs, and each cell is held to its own
  there (``--oracle-dir``): every FASTA byte-identical and ``stats.yaml``
  equal but for ``command`` and ``peak_memory_bytes``.
* One synthetic FASTQ per (panel, sample) in ``--synth-dir``
  (``benchmarks/work/synth/``, as the JAX runner's), made by
  ``tools/synth.py`` at the deepest depth; shallower cells read its
  first N reads (``-m``). A deeper file of the same (panel, sample)
  that is already there is read instead: ``synth.py`` writes 250k-read
  slabs, so the first N reads are the same in every file of a seed.
* Each depth of the result YAML also keeps the CLI's stage walls and
  each device's peak (``stage_walls``, ``device_peak_bytes``), and the
  result names the card (``nvidia-smi``) and the torch device.

The CLI runs on ``cuda`` unless ``SHARKMER_TORCH_DEVICE=cpu`` is set. A
cell that fails or differs from its committed outputs makes the exit
code 1.

Usage:
  python -m sharkmer_tpu_torch.tools.run_grid               # all 9 cells
  python -m sharkmer_tpu_torch.tools.run_grid --panel metazoa \\
      --max-reads 1000000
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import sys
from datetime import datetime
from pathlib import Path

import yaml

from sharkmer_tpu_torch.tools.bench import card
from sharkmer_tpu_torch.tools.validate import report, results, runner

ROOT = runner.REPO_ROOT
BENCH_DIR = ROOT / "benchmarks"
GRID_DIR = ROOT / "build" / "grid"
VARYING_STATS = ("command", "peak_memory_bytes")


def fastq_for(synth_dir: Path, panel: str, accession: str,
              depth: int) -> Path | None:
    """The shallowest synthetic FASTQ of (panel, accession) in
    ``synth_dir`` that holds at least ``depth`` reads, or None."""
    found = []
    for path in synth_dir.glob(f"{panel}_{accession}_*.fastq.gz"):
        match = re.fullmatch(rf"{re.escape(panel)}_{re.escape(accession)}"
                             r"_(\d+)\.fastq\.gz", path.name)
        if match and int(match.group(1)) >= depth:
            found.append((int(match.group(1)), path))
    return min(found)[1] if found else None


def compare_cell(outdir: Path, oracle: Path, sample: str) -> list[str]:
    """What differs between a cell's outputs and the committed ones: the
    file names, any FASTA byte, ``stats.yaml`` but for VARYING_STATS.
    Empty when they agree."""
    want, got = sorted(os.listdir(oracle)), sorted(os.listdir(outdir))
    if want != got:
        return [f"files {got} != {want}"]
    stats_name = f"{sample}.stats.yaml"
    diffs = []
    for name in want:
        a, b = (oracle / name).read_bytes(), (outdir / name).read_bytes()
        if name == stats_name:
            a, b = yaml.safe_load(a), yaml.safe_load(b)
            for key in VARYING_STATS:
                a.pop(key, None), b.pop(key, None)
        if a != b:
            diffs.append(name)
    return diffs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--config", type=Path,
                        default=BENCH_DIR / "benchmark_offline.yaml")
    parser.add_argument("--panel", action="append",
                        help="panel filter (repeatable)")
    parser.add_argument("--accession", action="append")
    parser.add_argument("--max-reads", type=int, action="append")
    parser.add_argument("--out-dir", type=Path, default=GRID_DIR / "results")
    parser.add_argument("--work-dir", type=Path, default=GRID_DIR / "work",
                        help="cell outputs: <work-dir>/<panel>/<sample>/<N>")
    parser.add_argument("--synth-dir", type=Path,
                        default=BENCH_DIR / "work" / "synth",
                        help="synthetic FASTQ files")
    parser.add_argument("--oracle-dir", type=Path,
                        default=BENCH_DIR / "work",
                        help="the JAX package's committed cells")
    args = parser.parse_args(argv)

    with open(args.config) as f:
        config = yaml.safe_load(f)
    defaults = config.get("defaults", {})
    depth_default = defaults.get("max_reads", runner.DEFAULT_MAX_READS)

    version = runner.get_sharkmer_version()
    machine = runner.get_machine_info()
    gpu = card()
    if gpu:
        machine["gpu"] = gpu
    device = os.environ.get("SHARKMER_TORCH_DEVICE") or "cuda"
    summaries = []
    failed = []

    for bench in config.get("benchmarks", []):
        panel_name = bench["panel"]
        if args.panel and panel_name not in args.panel:
            continue
        panel_path = runner.PANELS_DIR / f"{panel_name}.yaml"
        panel_data = runner.load_panel(panel_path)

        sample_results = []
        for sample in bench.get("samples", []):
            accession = sample["accession"]
            if args.accession and accession not in args.accession:
                continue
            depths = args.max_reads or depth_default
            fastq = None
            synth = sample.get("synthetic")
            if synth:
                fastq = fastq_for(args.synth_dir, panel_name, accession,
                                  max(depths))
                if fastq is None:
                    from sharkmer_tpu_torch.tools.synth import (
                        synthesize_panel_fastq,
                    )

                    fastq = args.synth_dir / (
                        f"{panel_name}_{accession}_{max(depths)}.fastq.gz")
                    print(f"== synthesizing {fastq.name}", flush=True)
                    synthesize_panel_fastq(
                        panel_path, fastq, max(depths),
                        read_len=synth.get("read_len", 150),
                        genome_mbp=synth.get("genome_mbp", 20.0),
                        error_rate=synth.get("error_rate", 0.01),
                        seed=synth.get("seed", 0),
                    )
                print(f"== reads from {fastq}", flush=True)
            runs = []
            for max_reads in depths:
                outdir = args.work_dir / panel_name / accession / str(max_reads)
                shutil.rmtree(outdir, ignore_errors=True)
                cell = f"{panel_name} {accession} @ {max_reads:,}"
                print(f"== {cell}", flush=True)
                run = runner.run_sharkmer(panel_path, accession, max_reads,
                                          outdir, fastq_path=fastq)
                oracle = args.oracle_dir / panel_name / accession / str(max_reads)
                if run["success"] and oracle.is_dir():
                    diffs = compare_cell(outdir, oracle,
                                         f"{accession}_{max_reads}")
                    run["oracle"] = diffs or "identical"
                    if diffs:
                        failed.append(f"{cell}: differs from {oracle}: "
                                      f"{diffs}")
                elif not run["success"]:
                    failed.append(f"{cell}: exit {run['returncode']}: "
                                  f"{run.get('stderr_tail', '')[-500:]}")
                genes = sum(g["status"] == "success" for g in run["genes"])
                print(f"   wall {run['wall_time_seconds']} s, stage walls "
                      f"{run.get('stage_walls')}, peaks "
                      f"{run.get('device_peak_bytes')}, genes "
                      f"{genes}/{len(run['genes'])}, committed outputs: "
                      f"{run.get('oracle', 'none')}", flush=True)
                runs.append(run)
            sample_results.append((sample, runs))

        if not sample_results:
            continue
        result = results.build_result(
            panel_path, panel_data, sample_results, version,
            machine_info=machine,
        )
        result["backend"] = f"torch-{device}"
        # the port's record keys that build_result does not carry over
        for entry, (_, runs) in zip(result["samples"], sample_results):
            for depth, run in zip(entry["depths"], runs):
                for key in ("stage_walls", "device_peak_bytes", "oracle"):
                    if key in run:
                        depth[key] = run[key]
        path = results.write_result(result, args.out_dir)
        report.write_report(result, panel_data, path.with_suffix(".md"))
        summaries.append((panel_name, result))
        print(f"-> {path}")

    if summaries:
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        combined = args.out_dir / f"benchmark_{version}_{stamp}.summary.md"
        with open(combined, "w") as f:
            f.write(f"# sharkmer-tpu-torch benchmark {version}\n\n")
            for panel_name, result in summaries:
                panel_path = runner.PANELS_DIR / f"{panel_name}.yaml"
                f.write(report.generate_report(
                    result, runner.load_panel(panel_path)))
                f.write("\n")
        print(f"-> {combined}")
    for line in failed:
        print(f"FAILED {line}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
