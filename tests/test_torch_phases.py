"""The port's trace registry (``utils/phases``) on the CPU: spans and
their self time, per-thread tallies, run records, profiler ranges, host
syncs, the sPCR phase view, and the spans and syncs of small count
passes and of a small sPCR run."""

import logging
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sharkmer_tpu_torch.engine import COUNT_SPANS, CountingEngine
from sharkmer_tpu_torch.main import main as torch_main
from sharkmer_tpu_torch.ops import reach
from sharkmer_tpu_torch.ops.encoding import canonical_kmers
from sharkmer_tpu_torch.ops.keys import SENTINEL
from sharkmer_tpu_torch.pcr.counts import FilteredTable
from sharkmer_tpu_torch.utils import phases

from data_18s import READ_STRING
from test_cli_e2e import PRIMER_SPEC, tiling_reads
from util import write_fastq

K = 15


class Clock:
    """A stand-in for the registry's ``perf_counter``."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self, seconds):
        self.t += seconds


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(phases, "perf_counter", c)
    return c


def code_batches(n_batches, rows=256, width=64, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        codes = rng.integers(0, 4, size=(rows, width), dtype=np.uint8)
        codes[:, width - 8:] = 5  # pad past each read's 56 bases
        out.append((codes, np.full(rows, width - 8, np.int32)))
    return out


def count_pass(backend, batches, **kw):
    engine = CountingEngine(k=K, device="cpu", n_chunks=1, backend=backend,
                            **kw)
    for codes, lens in batches:
        engine.ingest_code_batch(codes, lens)
    engine.consolidate()
    return engine, phases.current()


def test_span_nesting_and_self_time(clock):
    record = phases.begin()
    with phases.span("a"):
        clock.tick(1)
        with phases.span("b"):
            clock.tick(2)
            with phases.span("c"):
                clock.tick(4)
        with phases.span("b"):
            clock.tick(8)
    spans = record.spans()
    assert spans[("a",)] == [1, 15.0, 1.0, 15.0]
    assert spans[("a", "b")] == [2, 14.0, 10.0, 8.0]
    assert spans[("a", "b", "c")] == [1, 4.0, 4.0, 4.0]
    assert record.total("b") == phases.Stat(2, 14.0, 10.0, 8.0)


def test_a_span_inside_its_own_name_counts_its_wall_once(clock):
    record = phases.begin()
    with phases.span("m"):
        clock.tick(1)
        with phases.span("m"):
            clock.tick(2)
    assert record.total("m") == phases.Stat(2, 3.0, 3.0, 3.0)


def test_syncs_are_charged_to_the_innermost_span(clock):
    record = phases.begin()
    with phases.sync("outside"):
        clock.tick(1)
    with phases.span("ingest.batch"):
        with phases.span("ingest.upload"):
            assert not phases.in_sync()
            with phases.sync("codes.upload"):
                assert phases.in_sync()
                clock.tick(2)
        with phases.sync("claims.read", calls=2):
            clock.tick(3)
    with phases.span("consolidate"):
        with phases.sync("kmers.total"):
            clock.tick(5)
    assert not phases.in_sync()
    assert record.sites("ingest.batch") == {"codes.upload": [1, 2.0],
                                            "claims.read": [2, 3.0]}
    assert record.syncs("ingest.upload") == (1, 2.0)
    assert record.syncs("ingest.batch", "consolidate") == (4, 10.0)
    assert record.syncs() == (4, 10.0)  # the one outside every span: not
    line = record.describe("ingest.batch", "consolidate")
    assert line.endswith("host_syncs 4 (claims.read 2, codes.upload 1, "
                         "kmers.total 1), sync_wait 10.000s")


def test_threads_add_into_their_own_tallies_merged_on_read():
    record = phases.begin()
    n_threads, n_calls = 8, 400
    barrier = threading.Barrier(n_threads)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            barrier.wait(timeout=30)
            for _ in range(n_calls):
                with phases.span("spcr.gene"):
                    with phases.span("closures"):
                        with phases.sync("closure.state"):
                            pass
                    phases.count("closure_levels", 3)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    total = n_threads * n_calls
    assert len(record._tallies) == n_threads
    assert record.total("spcr.gene").calls == total
    assert record.total("closures").calls == total
    assert record.syncs("spcr.gene") == (total, pytest.approx(
        record.syncs("closures")[1]))
    assert record.syncs("closures")[0] == total
    assert record.counter("closure_levels") == 3 * total


def test_records_begin_with_each_engine_in_order_and_are_bounded():
    ids = []
    for _ in range(phases.RECORDS_KEPT + 3):
        CountingEngine(k=K, device="cpu", backend="hash",
                       initial_capacity=1 << 12)
        ids.append(phases.current().id)
    kept = phases.records()
    assert len(kept) == phases.RECORDS_KEPT
    assert [r.id for r in kept] == ids[-phases.RECORDS_KEPT:]
    assert ids == sorted(set(ids))
    assert all(r.total("engine.create").calls == 1 for r in kept)


def test_no_profiler_range_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range with no profiler recording")

    monkeypatch.setattr(phases._profiler, "record_function", refuse)
    _engine, record = count_pass("hash", code_batches(2),
                                 initial_capacity=1 << 12)
    assert record.total("ingest.batch").calls == 2


def test_spans_are_profiler_ranges_under_a_cpu_profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        count_pass("sorted", code_batches(2))
        with phases.span("spcr.gene", tag="18s@t0"):
            pass
    names = {e.name for e in prof.events() if e.name.startswith("sharkmer.")}
    assert {"sharkmer.engine.create", "sharkmer.ingest.batch",
            "sharkmer.ingest.host", "sharkmer.ingest.upload",
            "sharkmer.ingest.encode", "sharkmer.ingest.insert",
            "sharkmer.store.drain", "sharkmer.consolidate",
            "sharkmer.consolidate.spectrum",
            "sharkmer.spcr.gene[18s@t0]"} <= names


@pytest.mark.parametrize("n_batches", [1, 4])
def test_hash_count_spans_syncs_and_grows(n_batches):
    batches = code_batches(n_batches, seed=n_batches)
    capacity, grows, seen = 1 << 12, 0, set()
    for codes, _lens in batches:
        kmers = canonical_kmers(torch.from_numpy(codes), K)
        while len(seen) + kmers.numel() > 0.70 * capacity:
            capacity, grows = 2 * capacity, grows + 1
        seen.update(kmers[kmers != SENTINEL].tolist())
    engine, record = count_pass("hash", batches, initial_capacity=1 << 12)
    assert engine.table.capacity == capacity
    assert record.total("ingest.batch").calls == n_batches
    sites = record.sites("ingest.batch")
    assert sites["claims.read"][0] == n_batches  # the grow check
    assert sites["codes.upload"][0] == n_batches
    assert record.syncs("ingest.upload")[0] == n_batches
    assert record.total("store.grow").calls == grows
    assert record.total("consolidate.spectrum").calls == 1


@pytest.mark.parametrize("n_batches", [1, 3])
def test_sorted_count_drains_as_its_budget_implies(monkeypatch, n_batches):
    budget = 1 << 12
    monkeypatch.setenv("SHARKMER_MAX_AGG", str(budget))
    batches = code_batches(n_batches, rows=300, seed=n_batches)
    # one tile of the budget's width a drain: every tile but the first
    # drains the full buffer before its append, the last at consolidate
    tiles = sum(-(-codes.shape[0] * (codes.shape[1] - K + 1) // budget)
                for codes, _lens in batches)
    _engine, record = count_pass("sorted", batches)
    assert record.total("store.drain").calls == tiles
    assert record.total("ingest.batch").calls == n_batches
    assert record.sites("ingest.batch")["codes.upload"][0] == n_batches


def test_phase_view_since_reset(clock):
    phases.begin()
    with phases.span("closures"):
        clock.tick(1)
    phases.reset()
    with phases.span(phases.WARM_UP):
        with phases.span("closures"):
            clock.tick(2)
        phases.count("closure_levels", 5)
    with phases.span("closures"):
        clock.tick(4)
    phases.count("closure_levels", 7)
    phases.add("extra", 0.5, calls=2)
    snap = phases.snapshot()
    assert snap == {"closures": (4.0, 1), phases.WARM_UP: (2.0, 1),
                    "extra": (0.5, 2)}
    assert phases.report() == ("closures 4.00s/1, warm_caches 2.00s/1, "
                               "extra 0.50s/2, closure_levels 7")


@pytest.fixture(scope="module")
def fastq_18s(tmp_path_factory):
    path = tmp_path_factory.mktemp("reads") / "reads.fastq"
    write_fastq(path, tiling_reads(READ_STRING) + [READ_STRING] * 5)
    return str(path)


def test_closures_phase_keeps_its_meaning(tmp_path, monkeypatch, caplog,
                                          fastq_18s):
    """``snapshot()["closures"]``, which ``closure_s.sample`` reads: a
    call a reach chunk, its wall summed over the gene threads, the
    warm-up's calls left out; the CLI's log lines keep their form."""
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    warming = threading.local()
    calls = []  # (wall, warm-up) of each `_drive_closure` call with roots
    drive, warm = reach._drive_closure, FilteredTable.warm_caches

    def spied_drive(run_kernel, roots, *args, **kwargs):
        start = time.perf_counter()
        try:
            return drive(run_kernel, roots, *args, **kwargs)
        finally:
            if len(np.unique(np.asarray(roots, np.uint64))):
                calls.append((time.perf_counter() - start,
                              getattr(warming, "on", False)))

    def spied_warm(self):
        warming.on = True
        try:
            return warm(self)
        finally:
            warming.on = False

    monkeypatch.setattr(reach, "_drive_closure", spied_drive)
    monkeypatch.setattr(FilteredTable, "warm_caches", spied_warm)
    caplog.set_level(logging.WARNING, logger="sharkmer")
    rc = torch_main([fastq_18s, "-s", "samp", "-k", "21", "-t", "2",
                     "-o", str(tmp_path / "out"), "--pcr-primers",
                     PRIMER_SPEC])
    assert rc == 0
    wall, n = phases.snapshot()["closures"]
    gene_calls = [w for w, warm_up in calls if not warm_up]
    assert n == len(gene_calls) > 0
    assert 0 < wall <= sum(gene_calls)
    assert phases.current().total("closures").calls == len(calls)
    assert len(calls) > len(gene_calls)  # the warm-up ran closures too
    lines = [r.getMessage() for r in caplog.records]
    spcr = next(m for m in lines if "sPCR phases:" in m)
    # chip_smoke.py's parse of the closure calls
    assert int(spcr.split(" closures ")[1].split("/")[1].split(",")[0]) == n
    assert "extend_total" not in spcr and "closure_levels 0.00s" not in spcr
    assert any("stage walls:" in m for m in lines)
    trace = next(m for m in lines if "count trace:" in m)
    assert all(name in trace for name in COUNT_SPANS)
    assert "host_syncs" in trace and "sync_wait" in trace


def test_idle_split_names_each_gap_by_its_innermost_range():
    from sharkmer_tpu_torch.tools.trace_spcr import OUTSIDE, idle_split

    device = [(0, 10), (20, 30), (35, 40), (60, 100)]
    ranges = [(5, 50, "sharkmer.ingest.batch"),
              (12, 18, "sharkmer.ingest.host"),
              (31, 34, "sharkmer.spcr.gene[18s@t1]"),
              (0, 100, "sharkmer.consolidate")]
    assert idle_split(device, ranges, 0, 110) == {
        "ingest.batch": [20.0, 1], "ingest.host": [10.0, 1],
        OUTSIDE: [10.0, 1], "spcr.gene": [5.0, 1]}
    assert idle_split([], [], 0, 5) == {OUTSIDE: [5, 1]}
