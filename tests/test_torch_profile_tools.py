"""The port's profilers, ``tools/ingest_phase.py`` and
``tools/cold_start.py``, on the CPU at small sizes.

* ``ingest_phase``'s keys are ``scripts/profile_count.py``'s (its numpy
  lines are copied here: the script imports jax), every drain stage runs
  on the CPU, and its full pass gives the JAX ``SortedKmerStore``'s
  histogram on the same keys.
* ``--fastq`` counts the reads, bases, valid bases and k-mers that the
  port's CLI counts for the same file.
* ``cold_start`` prints its stages in order, and its histogram's total
  is ``tools/bench.count_pass``'s distinct count on the same reads;
  ``--cli`` splits a CLI child's wall into parts that add up to it.
"""

import gzip
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sharkmer_tpu.ops.sorted_store import SortedKmerStore as JaxStore
from sharkmer_tpu_torch.main import main as cli_main
from sharkmer_tpu_torch.ops.keys import keys_to_numpy
from sharkmer_tpu_torch.ops.sorted_store import (
    _aggregate_ingest_ghosted,
    _aggregate_ingest_v2,
)
from sharkmer_tpu_torch.tools import bench, cold_start, ingest_phase

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
WIDTH, K = 12, 21
# cold_start's reads: bench's generator, small
COLD_ARGS = ["--reads", "3000", "--batch", "1024", "--genome-mbp", "1.0"]


def profile_count_keys(width: int, k: int) -> np.ndarray:
    """``scripts/profile_count.py``'s keys, its numpy lines as they are."""
    n = 1 << width
    rng = np.random.default_rng(0)
    mask = np.uint64((1 << (2 * k)) - 1)
    uniq = rng.integers(0, 1 << (2 * k), size=n // 5, dtype=np.uint64)
    raw = uniq[rng.integers(0, len(uniq), size=n)] & mask
    return raw


@pytest.mark.parametrize("width,k", [(WIDTH, K), (WIDTH, 19), (10, 31)])
def test_keys_match_profile_count(width, k):
    got = keys_to_numpy(ingest_phase.make_keys(width, k, CPU))
    want = profile_count_keys(width, k)
    assert got.dtype == np.uint64 and np.array_equal(got, want)


def test_drain_stages_run_on_the_cpu():
    record = ingest_phase.drain_stages(WIDTH, K, 1, CPU)
    stages = [label for label in record if "ms" in record[label]]
    assert [s.split(" (")[0] for s in stages] == [
        "flat sort", "run_starts", "flip + run_starts", "ghosted drain",
        "v2 drain", "histogram(10000) on seeded store",
        "full insert+flush+histogram"]
    for label in stages:
        assert record[label]["ms"] > 0
        # the plain versions run on the CPU: no kernel launches
        assert set(record[label]["launches"].values()) == {0}
    distinct = np.unique(profile_count_keys(WIDTH, K)).size
    assert record["ghosted rows"] == {"n_padded": 1 << WIDTH,
                                      "n_real": distinct}
    assert record["full insert+flush+histogram"]["distinct"] == distinct
    # drain v2 on the sentinel-padded row: the same distinct keys
    buf = ingest_phase.make_keys(WIDTH, K, CPU)
    *_, n_real = _aggregate_ingest_v2(ingest_phase.v2_input(buf), 64 - 2 * K)
    assert n_real == distinct == _aggregate_ingest_ghosted(buf.clone())[3]


def test_full_pass_histogram_matches_jax():
    raw = profile_count_keys(WIDTH, K)
    jax_store = JaxStore.create(K)
    jax_store.insert_kmers(jnp.asarray(raw))
    jax_store.flush()
    want = np.asarray(jax_store.histogram(10_000))
    got = ingest_phase.full_pass(ingest_phase.make_keys(WIDTH, K, CPU),
                                 K).histogram(10_000)
    assert np.array_equal(got, want) and int(want.sum()) > 0


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """2500 reads of 100-170 bases (past the reader's first 160-column
    width), some with N bases."""
    rng = np.random.default_rng(11)
    path = tmp_path_factory.mktemp("fastq") / "reads.fastq.gz"
    with gzip.open(path, "wt") as f:
        for i in range(2500):
            seq = rng.choice(list("ACGT"), size=rng.integers(100, 171))
            seq[rng.random(seq.size) < 0.01] = "N"
            f.write(f"@r{i}\n{''.join(seq)}\n+\n{'I' * seq.size}\n")
    return path


@pytest.mark.parametrize("max_reads", [0, 1700])
def test_fastq_stages_count_what_the_cli_counts(tmp_path, monkeypatch, fastq,
                                                max_reads):
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    got = ingest_phase.fastq_stages(str(fastq), max_reads, K, CPU)
    argv = ["-s", "s", "-k", str(K), "-o", str(tmp_path / "out"), str(fastq)]
    assert cli_main(argv + (["-m", str(max_reads)] if max_reads else [])) == 0
    with open(tmp_path / "out" / "s.stats.yaml") as f:
        stats = yaml.safe_load(f)
    assert (got["reads"], got["bases"], got["valid_bases"], got["kmers"]) == (
        stats["n_reads_read"], stats["n_bases_read"],
        stats["n_bases_ingested"], stats["n_kmers"])
    assert got["reads"] == (max_reads or 2500)
    assert got["pinned_upload_s"] is None  # no card
    assert got["consumer_s"] == pytest.approx(
        got["valid_count_s"] + got["pageable_upload_s"]
        + got["device_count_s"])


@pytest.mark.parametrize("members", [1, 2])
@pytest.mark.parametrize("max_reads", [0, 1700])
def test_inflate_alone_inflates_the_reads(tmp_path, fastq, members,
                                          max_reads):
    """Stage (a'): zlib's inflate gives the file's text, every gzip member
    of it, up to the first ``max_reads`` reads' lines (whole 1 MB blocks
    of the file, so possibly more)."""
    with gzip.open(fastq, "rb") as f:
        text = f.read()
    path = fastq
    if members == 2:  # the same reads as two gzip members
        path = tmp_path / "two.fastq.gz"
        half = text.index(b"\n@r1250\n") + 1
        path.write_bytes(gzip.compress(text[:half])
                         + gzip.compress(text[half:]))
    got = ingest_phase.inflate_alone(str(path), max_reads)
    assert got["gzip_bytes"] <= os.path.getsize(path)
    assert got["inflate_s"] > 0
    if max_reads:
        assert got["inflated_lines"] >= 4 * max_reads
        assert got["inflated_bytes"] >= len(b"".join(
            text.splitlines(keepends=True)[: 4 * max_reads]))
    else:
        assert got["gzip_bytes"] == os.path.getsize(path)
        assert (got["inflated_bytes"], got["inflated_lines"]) == (
            len(text), text.count(b"\n"))
    plain = tmp_path / "reads.fastq"
    plain.write_bytes(text)
    assert ingest_phase.inflate_alone(str(plain), max_reads) is None


def test_ingest_phase_main_prints_one_json_line(capsys, monkeypatch, fastq):
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    assert ingest_phase.main(["--width", "10", "--iters", "1", "--fastq",
                              str(fastq), "--max-reads", "500"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    record = json.loads(lines[-1])
    assert record["device"] == "cpu" and record["fastq"]["reads"] == 500
    assert lines[-2].startswith("ingest wall set by the ")


def _run_tool(*args):
    env = dict(os.environ, SHARKMER_TORCH_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "sharkmer_tpu_torch.tools.cold_start", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()


@pytest.fixture(scope="module")
def cold():
    return _run_tool(*COLD_ARGS)


def test_cold_start_prints_its_stages_in_order(cold):
    record = json.loads(cold[-1])
    labels = [label for label, _ in record["stamps"]]
    assert [line.split("] ", 1)[1] for line in cold[:-1]] == labels
    assert [label.split(" (")[0].split(" = ")[0] for label in labels] == [
        "interpreter start to this module", "numpy imported",
        "torch imported", "sharkmer_tpu_torch.main imported",
        "device cpu ready", "kernel libraries not loaded",
        "io/native.available()", "generating 3000 reads",
        "reads generated", "first batch upload", "first ingest",
        "remaining ingests", "flush", "histogram"]
    times = [t for _, t in record["stamps"]]
    assert times == sorted(times) and times[0] >= 0


def test_cold_start_histogram_is_the_count_pass(cold):
    record = json.loads(cold[-1])
    parser = bench.build_parser()
    args = parser.parse_args(COLD_ARGS)
    batches, _ = bench.build_batches(args, args.reads, CPU)
    _, distinct = bench.count_pass(bench.make_store_factory(args, CPU),
                                   batches)
    assert record["histogram_total"] == distinct > 0
    assert record["stamps"][-1][0] == f"histogram (n={distinct})"


def test_cold_start_cli_split_adds_up(tmp_path, fastq):
    lines = _run_tool("--cli", "-s", "s", "-k", str(K), "-o",
                      str(tmp_path / "out"), "-m", "800", str(fastq))
    split = json.loads(lines[-1])
    assert abs(split["sum_s"] - split["wall_s"]) <= 0.5
    assert set(split["stage_walls_s"]) == {"ingest", "consolidate", "sPCR"}
    assert 0 < split["imports_s"] <= split["before_main_s"]
    assert {name for name, _ in split["top_imports"]} >= {"torch", "numpy"}
    assert split["after_stages_s"] >= 0 and split["after_main_s"] >= 0
    with open(tmp_path / "out" / "s.stats.yaml") as f:
        assert yaml.safe_load(f)["n_reads_read"] == 800


@pytest.mark.parametrize("text,seconds", [("12.3s", 12.3), ("1m 23s", 83.0),
                                          ("1h 5m", 3900.0)])
def test_parse_duration_reads_format_duration(text, seconds):
    from sharkmer_tpu_torch.format import format_duration

    assert cold_start.parse_duration(text) == pytest.approx(seconds)
    assert cold_start.parse_duration(format_duration(seconds)) == \
        pytest.approx(seconds, abs=0.5 if seconds >= 60 else 0.05)

