"""Whole runs of the harness on the CPU at a small size: each traffic,
the program broken underneath (each fault must read as not correct),
the control, the table read-out, the entry point without a card, and a
cell added by new files alone."""

import io
import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from perfbench import gen, harness, spec
from perfbench.control import control
from perfbench.units import HISTO_MAX

WORKLOADS = ["count.sorted.8M", "count.hash.8M", "sample.sorted.8M",
             "chunks10.sorted.8M"]


def run(root, small, workload, trace=False, seed=2**31 + 3):
    out = io.StringIO()
    rc = harness.run_cell(root, workload, seed, 0.01, trace, "cpu",
                          time.monotonic(), overrides=small, out=out)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def checks_pass(result):
    return all(c["value"] <= c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_traffic_runs_correct(root, small, workload):
    rc, result = run(root, small, workload)
    assert rc == 0 and result["correct"] and checks_pass(result)
    assert result["attempted"] >= 1 and result["failed"] == 0
    bench = spec.load(root)
    want = {m["name"] for m in spec.metrics_of(bench, workload, "end_to_end")}
    # no card, no peak of its memory: the reader leaves peak_mem out
    assert set(result["metrics"]) == want - {"peak_mem"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", ["count.sorted.8M", "sample.sorted.8M"])
def test_traced_run_reports_per_layer_metrics(root, small, workload):
    """On the CPU the trace has no device work: the spans' metrics are
    read, the device's are left out (no kernel launched on a card)."""
    rc, result = run(root, small, workload, trace=True)
    assert rc == 0 and result["correct"]
    spans = {"count.sorted.8M": {"ingest_s.count", "consolidate_s.count"},
             "sample.sorted.8M": {"count_s.sample", "spcr_s.sample",
                                  "closure_s.sample"}}[workload]
    assert spans <= set(result["metrics"])
    assert "kernel_roofline.count" not in result["metrics"]
    assert "busy_s" in result["device"] and "breakdown" in result


# -- the timed path broken underneath: each must come out not correct -------


def _unchanged(self, kmers, counts=None):
    return self  # an insert that leaves the table as it was


def _altered(original):
    def insert(self, kmers, counts=None):
        if counts is None and torch.is_tensor(kmers) and kmers.numel():
            kmers = kmers.clone()
            kmers[kmers.argmin()] ^= 1  # one k-mer changed as it is made
        return original(self, kmers, counts)
    return insert


def _half_batch(original):
    def ingest(self, codes, lens, max_reads=0):
        n = codes.shape[0] // 2
        return original(self, codes[:n], lens[:n], max_reads)
    return ingest


@pytest.mark.parametrize("workload", ["count.sorted.8M", "count.hash.8M",
                                      "chunks10.sorted.8M",
                                      "sample.sorted.8M"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_faults_are_not_correct(root, small, workload, fault, monkeypatch):
    from sharkmer_tpu_torch.engine import CountingEngine
    from sharkmer_tpu_torch.ops.hashtable import KmerTable
    from sharkmer_tpu_torch.ops.sorted_store import SortedKmerStore

    for cls in (SortedKmerStore, KmerTable):
        if fault == "unchanged":
            monkeypatch.setattr(cls, "insert_kmers", _unchanged)
        elif fault == "altered":
            monkeypatch.setattr(cls, "insert_kmers",
                                _altered(cls.insert_kmers))
    if fault == "half_batch":
        monkeypatch.setattr(CountingEngine, "ingest_code_batch",
                            _half_batch(CountingEngine.ingest_code_batch))
    rc, result = run(root, small, workload)
    assert not result["correct"] and result["failed"] >= 1
    # a table that no longer adds up stops the program itself (rc 1)
    wrong = result["checks"].get("keys_wrong", result["checks"].get(
        "unit_errors"))
    assert rc in (0, 1) and wrong["value"] > wrong["limit"]
    if workload == "sample.sorted.8M" and fault == "half_batch":
        # the run totals of stats.yaml count the reads the engine was given
        assert result["checks"]["stats_wrong"]["value"] > 0


def test_altered_amplicon_is_not_correct(root, small, monkeypatch):
    from sharkmer_tpu_torch import stats

    write = stats.write_fasta_record

    def altered(f, rec_id, desc, seq):
        mid = len(seq) // 2
        flip = {"A": "C", "C": "G", "G": "T", "T": "A"}
        write(f, rec_id, desc, seq[:mid] + flip.get(seq[mid], "A")
              + seq[mid + 1:])

    monkeypatch.setattr(stats, "write_fasta_record", altered)
    rc, result = run(root, small, "sample.sorted.8M")
    assert rc == 0 and not result["correct"]
    assert result["checks"]["amplicon_subst"]["value"] > 0


@pytest.mark.parametrize("cut", ["end", "start"])
def test_truncated_amplicon_is_not_correct(root, small, cut, monkeypatch):
    """A product cut short (a primer and part of the insert) is not the
    product, though it lies inside the amplicon base for base."""
    from sharkmer_tpu_torch import stats

    write = stats.write_fasta_record

    def truncated(f, rec_id, desc, seq):
        n = len(seq) * 2 // 3
        write(f, rec_id, desc, seq[:n] if cut == "end" else seq[-n:])

    monkeypatch.setattr(stats, "write_fasta_record", truncated)
    rc, result = run(root, small, "sample.sorted.8M")
    assert rc == 0 and not result["correct"]
    assert result["checks"]["amplicon_subst"]["value"] > 0
    assert result["checks"]["products_wrong"]["value"] > 0


def test_a_wrong_product_beside_the_right_one_is_not_correct(root, small,
                                                             monkeypatch):
    """Each pair writes its product and a short stretch of it: the best
    product is exact, the extra one is counted."""
    from sharkmer_tpu_torch import stats

    write = stats.write_fasta_record

    def twice(f, rec_id, desc, seq):
        write(f, rec_id, desc, seq)
        write(f, rec_id + "_b", desc, seq[: len(seq) // 2])

    monkeypatch.setattr(stats, "write_fasta_record", twice)
    rc, result = run(root, small, "sample.sorted.8M")
    assert rc == 0 and not result["correct"]
    assert result["checks"]["amplicon_subst"]["value"] == 0
    assert result["checks"]["products_wrong"]["value"] > 0


# -- the control ---------------------------------------------------------------

# amplicon k-mers counted ~600 times, past the control's 8-bit field
CONTROL_SIZE = {"genome_bp": 500_000, "n_reads": 100_000,
                "batch_reads": 16384, "amplicon_copies": 20}


@pytest.mark.parametrize("workload", ["count.sorted.8M", "chunks10.sorted.8M",
                                      "sample.sorted.8M"])
def test_control_is_not_correct(root, workload):
    found = control(root, workload, 5, "cpu", CONTROL_SIZE)
    assert found["keys_wrong"] > harness.LIMITS["keys_wrong"]
    if workload != "sample.sorted.8M":
        assert found["spectra_bins_wrong"] > 0


def test_reference_in_the_programs_place_is_correct(root):
    """Without the narrower field the same path reads 0."""
    found = control(root, "chunks10.sorted.8M", 5, "cpu", CONTROL_SIZE,
                    cap=None)
    assert found["keys_wrong"] == 0 and found["spectra_bins_wrong"] == 0


# -- the program's table read out on the device ----------------------------------


@pytest.mark.parametrize("backend", ["sorted", "hash"])
def test_table_rows_equal_the_host_export(root, small, backend):
    from sharkmer_tpu_torch.engine import CountingEngine

    bench = spec.load(root)
    cfg = spec.config(root, bench, f"cnidaria-8M-{backend}")
    cfg.update(small)
    sample = gen.make_sample(cfg, 9, "cpu")
    engine = CountingEngine(k=cfg["k"], device="cpu", n_chunks=1,
                            histo_max=HISTO_MAX, initial_capacity=1 << 12,
                            backend=backend)
    for codes, lens in sample.batches:
        engine.ingest_code_batch(codes, lens)
    engine.consolidate()
    keys, counts = harness.table_rows(engine.table)
    host_keys, host_counts = engine.table.to_sorted_arrays()
    assert np.array_equal(keys.numpy().view(np.uint64), host_keys)
    assert np.array_equal(counts.numpy(), host_counts.astype(np.int64))


def test_table_rows_refuse_an_unknown_table():
    with pytest.raises(TypeError):
        harness.table_rows(types.SimpleNamespace(n_unique=lambda: 0))


# -- JAX loaded after the window: no result ----------------------------------------


def _load_jax_stub(monkeypatch):
    """What an ``import jax`` leaves in ``sys.modules`` (undone after the
    test)."""
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))


@pytest.mark.parametrize("where", ["e2e_reader", "layer_reader",
                                   "failed_unit"])
def test_jax_loaded_after_the_window_prints_no_result(root, small, where,
                                                      monkeypatch):
    """The check runs just before the result line: a metric's reader, or
    anything after a unit failed, that loads JAX leaves no result."""
    assert not harness.forbidden_modules(sys.modules)
    if where == "failed_unit":
        from perfbench.units import count

        def fails(self):
            _load_jax_stub(monkeypatch)
            raise RuntimeError("a unit that fails")

        monkeypatch.setattr(count.Unit, "run", fails)
    else:
        original = spec.reader

        def reader(name):
            read = original(name)

            def loading(ctx):
                _load_jax_stub(monkeypatch)
                return read(ctx)
            return loading

        monkeypatch.setattr(spec, "reader", reader)
    out = io.StringIO()
    rc = harness.run_cell(root, "count.hash.8M", 2**31 + 5, 0.01,
                          where == "layer_reader", "cpu", time.monotonic(),
                          overrides=small, out=out)
    assert rc != 0 and out.getvalue() == ""


# -- the entry point -------------------------------------------------------------


def test_entry_without_a_card_prints_no_result(root):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "count.sorted.8M",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


# -- driven by data: a new cell from new files only ----------------------------------


def test_new_cell_from_new_files_only(root, small, tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell are
    added as files and entries; no existing file changes."""
    shutil.copytree(os.path.join(root, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: (tmp_path / p).read_bytes()
              for p in _files(tmp_path / "perfbench", tmp_path)}
    bench = spec.load(root)
    cfg = json.loads((tmp_path / "perfbench/configs/cnidaria-8M-hash.json")
                     .read_text())
    cfg.update(small, threads=2)
    (tmp_path / "perfbench/configs/tiny-hash.json").write_text(
        json.dumps(cfg))
    (tmp_path / "perfbench/traffic/chunks3.json").write_text(json.dumps(
        {"unit": "halves", "n_chunks": 3}))
    (tmp_path / "perfbench/units/halves.py").write_text(HALVES)
    (tmp_path / "perfbench/metrics/units_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['units'])\n")
    (tmp_path / "perfbench/metrics/passes_per_min.py").write_text(
        "def read(ctx):\n    return 60 * ctx['units'] / ctx['window_s']\n")
    bench["configs"].append({"name": "tiny-hash", "source": "a test",
                             "file": "perfbench/configs/tiny-hash.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "chunks3.tiny", "config": "tiny-hash",
                               "traffic": "chunks3", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "units_seen", "unit": "units",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "count_rate",
                               "workloads": ["chunks3.tiny"]})
    for m in bench["end_to_end"]:
        if m["name"] == "count_rate":
            m["workloads"].append("chunks3.tiny")
    bench["end_to_end"].append({"name": "passes_per_min", "unit": "1/min",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["chunks3.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, time; from perfbench import harness; "
            "sys.exit(harness.run_cell(sys.argv[1], 'chunks3.tiny', 4, 0.01, "
            "bool(int(sys.argv[2])), 'cpu', time.monotonic()))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), root]))
    results = []
    for traced in ("0", "1"):
        proc = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                               traced], cwd=tmp_path, env=env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert results[0]["correct"] and "count_rate" in results[0]["metrics"]
    assert results[0]["metrics"]["passes_per_min"]["value"] > 0
    assert results[1]["metrics"]["units_seen"]["value"] >= 1
    assert all((tmp_path / p).read_bytes() == data
               for p, data in before.items())


# a new kind of unit: a count pass that hands each batch over in halves
HALVES = '''
from perfbench.units import HISTO_MAX, Done
from perfbench.units import Unit as Base


class Unit(Base):
    def run(self):
        from sharkmer_tpu_torch.engine import CountingEngine

        engine = CountingEngine(
            k=self.cfg["k"], device=self.device,
            n_chunks=self.traffic["n_chunks"], histo_max=HISTO_MAX,
            initial_capacity=self.cfg["initial_capacity"],
            backend=self.cfg["backend"])
        for codes, lens in self.sample.batches:
            h = codes.shape[0] // 2
            engine.ingest_code_batch(codes[:h], lens[:h])
            engine.ingest_code_batch(codes[h:], lens[h:])
        spectra = engine.consolidate()
        self.sync()
        return Done(engine, spectra, self.sample.n_events)
'''


def _files(top, base):
    return [os.path.relpath(os.path.join(d, f), base)
            for d, _s, fs in os.walk(top) for f in fs]
