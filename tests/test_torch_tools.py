"""The port's benchmark and grid tools against the JAX package's.

* ``tools/bench.py``'s read generator gives ``bench.py``'s reads, and its
  count pass gives the JAX bench's spectrum on them (the JAX store on
  the CPU, the port's under ``SHARKMER_TORCH_DEVICE=cpu``).
* ``tools/validate/runner.run_sharkmer`` and the JAX package's
  ``scripts/sharkmer_validate/runner.run_sharkmer`` give the same run
  record and byte-identical FASTA on one synthetic FASTQ.
* ``tools/run_grid.py`` writes its cells, results and reads only under
  the directories it is given, never under ``benchmarks/``, and holds
  each cell to the committed outputs of the same name.
"""

import argparse
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import yaml

import bench as jax_bench
from sharkmer_tpu_torch.tools import bench, run_grid
from sharkmer_tpu_torch.tools.synth import synthesize_panel_fastq
from sharkmer_tpu_torch.tools.validate import runner

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

from sharkmer_validate import runner as jax_runner  # noqa: E402

PANELS = ("cnidaria", "hydrozoa", "metazoa")
N_READS, GENOME_MBP = 2000, 0.5


@pytest.mark.parametrize("panel", PANELS)
def test_make_reads_codes_matches_bench(panel):
    want = jax_bench.make_reads_codes(N_READS, 150, GENOME_MBP, seed=3,
                                      panel=panel)
    got = bench.make_reads_codes(N_READS, 150, GENOME_MBP, seed=3,
                                 panel=panel)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    # the amplicons are in the genome: the generator is not the plain one
    assert not np.array_equal(
        bench.make_genome_codes(GENOME_MBP, 3, panel),
        bench.make_genome_codes(GENOME_MBP, 3))


@pytest.mark.parametrize("backend", ["sorted", "hash"])
def test_count_pass_matches_bench(monkeypatch, backend):
    """The port's count pass and the JAX bench's ``_one_pass`` on the
    same batches (the last one padded): the same spectrum and distinct
    count, also with every batch freed as it lands."""
    import torch

    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    args = argparse.Namespace(
        reads=N_READS, read_len=150, k=21, genome_mbp=GENOME_MBP,
        batch=768, capacity=1 << 14, backend=backend, panel="metazoa",
        error_rate=0.01)
    jax_batches, n_jax = jax_bench._build_batches(args, N_READS)
    jax_store, jax_unique = jax_bench._one_pass(
        jax_bench._make_store_factory(args), jax_batches)
    batches, n = bench.build_batches(args, N_READS, torch.device("cpu"))
    assert n == n_jax == 3 and batches[-1].shape == (768, 150)
    store, unique = bench.count_pass(
        bench.make_store_factory(args, torch.device("cpu")), batches,
        consume=True)
    assert batches == [None] * n
    assert unique == jax_unique > 0
    assert np.array_equal(store.histogram(10_000),
                          jax_store.histogram(10_000))


@pytest.fixture(scope="module")
def tiny_fastq(tmp_path_factory):
    """1500 reads over a 0.15 Mbp genome that holds the hydrozoa
    amplicons: every gene is recovered, in a few seconds."""
    return synthesize_panel_fastq(
        ROOT / "sharkmer_tpu_torch" / "panels" / "hydrozoa.yaml",
        tmp_path_factory.mktemp("synth") / "tiny.fastq.gz", n_reads=1500,
        genome_mbp=0.15, seed=1)


def test_runner_matches_jax_runner(tmp_path, monkeypatch, tiny_fastq):
    """Both runners, side by side, on one FASTQ: equal records but for
    the wall and the peak, and byte-identical outputs; the port's record
    adds its stage walls and device peak."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    calls = {
        "jax": (jax_runner, jax_runner.PANELS_DIR / "hydrozoa.yaml"),
        "torch": (runner, runner.PANELS_DIR / "hydrozoa.yaml"),
    }
    with ThreadPoolExecutor(2) as pool:
        futures = {name: pool.submit(mod.run_sharkmer, panel, "tiny", 1500,
                                     tmp_path / name, fastq_path=tiny_fastq)
                   for name, (mod, panel) in calls.items()}
        records = {name: f.result() for name, f in futures.items()}
    jax_run, torch_run = records["jax"], records["torch"]
    assert torch_run["success"], torch_run.get("stderr_tail")
    assert jax_run["success"], jax_run.get("stderr_tail")
    assert set(torch_run["stage_walls"]) == {"ingest", "consolidate", "spcr"}
    assert torch_run["device_peak_bytes"] == {"cpu": None}
    for run in records.values():
        run.pop("wall_time_seconds")
        run["stats"].pop("peak_memory_bytes")
    torch_run.pop("stage_walls"), torch_run.pop("device_peak_bytes")
    assert torch_run == jax_run
    assert [g["status"] for g in jax_run["genes"]] == ["success"] * 4
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    for name in names:
        if name.endswith(".fasta"):
            assert ((tmp_path / "jax" / name).read_bytes()
                    == (tmp_path / "torch" / name).read_bytes()), name


def _tree(path: Path) -> dict:
    return {str(p): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in path.rglob("*")}


def test_run_grid_writes_only_where_it_is_told(tmp_path, monkeypatch):
    """A one-panel, two-depth grid: cells under ``--work-dir``, results
    under ``--out-dir``, reads under ``--synth-dir``, nothing under
    ``benchmarks/``. The 200-read cell has committed outputs that differ
    (exit 1, the difference in the result); the cell against a copy of
    its own outputs is identical, and not once ``stats.yaml`` counts one
    read more."""
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    config = tmp_path / "grid.yaml"
    config.write_text(yaml.safe_dump({
        "defaults": {"k": 19, "threads": 8, "max_reads": [200, 400]},
        "benchmarks": [{"panel": "hydrozoa", "samples": [{
            "accession": "tiny-seed1", "taxon": "tiny",
            "synthetic": {"seed": 1, "genome_mbp": 0.15}}]}],
    }))
    dirs = {name: tmp_path / name
            for name in ("results", "work", "synth", "oracle")}
    wrong = dirs["oracle"] / "hydrozoa" / "tiny-seed1" / "200"
    wrong.mkdir(parents=True)
    (wrong / "tiny-seed1_200.stats.yaml").write_text("n_reads_read: 0\n")
    before = _tree(ROOT / "benchmarks")
    assert run_grid.main([
        "--config", str(config), "--out-dir", str(dirs["results"]),
        "--work-dir", str(dirs["work"]), "--synth-dir", str(dirs["synth"]),
        "--oracle-dir", str(dirs["oracle"])]) == 1
    assert _tree(ROOT / "benchmarks") == before
    assert [p.name for p in dirs["synth"].iterdir()] == [
        "hydrozoa_tiny-seed1_400.fastq.gz"]
    cells = dirs["work"] / "hydrozoa" / "tiny-seed1"
    assert sorted(p.name for p in cells.iterdir()) == ["200", "400"]
    outputs = sorted(p.name for p in dirs["results"].iterdir())
    assert len(outputs) == 3 and outputs[0].startswith("benchmark_")
    assert outputs[1].endswith(".md") and outputs[2].endswith(".yaml")
    result = yaml.safe_load((dirs["results"] / outputs[2]).read_text())
    assert result["backend"] == "torch-cpu"
    depths = result["samples"][0]["depths"]
    assert [d["max_reads"] for d in depths] == [200, 400]
    assert all(d["success"] and set(d["stage_walls"]) == {
        "ingest", "consolidate", "spcr"} for d in depths)
    assert depths[0]["oracle"] == ["tiny-seed1_200.stats.yaml"]
    assert "oracle" not in depths[1]

    oracle = tmp_path / "copy"
    shutil.copytree(cells / "200", oracle)
    assert run_grid.compare_cell(cells / "200", oracle,
                                 "tiny-seed1_200") == []
    stats = oracle / "tiny-seed1_200.stats.yaml"
    data = yaml.safe_load(stats.read_text())
    data["command"] = "another command"
    stats.write_text(yaml.safe_dump(data))
    assert run_grid.compare_cell(cells / "200", oracle,
                                 "tiny-seed1_200") == []
    data["n_reads_read"] += 1
    stats.write_text(yaml.safe_dump(data))
    assert run_grid.compare_cell(cells / "200", oracle, "tiny-seed1_200") == [
        "tiny-seed1_200.stats.yaml"]
