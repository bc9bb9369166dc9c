"""The metrics read from the port's own trace registry (``utils/phases``):
whole traced runs on the CPU at a small size, each new metric against
the records of the window's units; and, on the card, every host sync of
a count pass inside the registry's ``sync`` (the sync audit)."""

import collections
import io
import json
import os
import tempfile
import time
import traceback
import warnings

import pytest
import torch

from perfbench import gen, harness, spec, units

WINDOW_READS = {
    "host_syncs.count": lambda r: r.syncs("ingest.batch", "consolidate")[0],
    "sync_wait_s.count": lambda r: r.syncs("ingest.batch",
                                           "consolidate")[1],
    "batch_host_s.count": lambda r: r.total("ingest.host").wall,
    "spectrum_s.count": lambda r: r.total("consolidate.spectrum").self_s,
    "sync_wait_s.sample": lambda r: r.syncs()[1],
    "gene_max_s.sample": lambda r: r.total("spcr.gene").max_s,
    "extend_host_s.sample": lambda r: r.total("spcr.extend").self_s,
}


def traced(root, small, workload, seed=2**31 + 11):
    out = io.StringIO()
    rc = harness.run_cell(root, workload, seed, 0.01, True, "cpu",
                          time.monotonic(), overrides=small, out=out)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["count.sorted.8M", "count.hash.8M",
                                      "chunks10.sorted.8M",
                                      "sample.sorted.8M"])
def test_registry_metrics_read_the_window_units(root, small, workload):
    from sharkmer_tpu_torch.utils import phases

    rc, result = traced(root, small, workload)
    assert rc == 0 and result["correct"]
    bench = spec.load(root)
    listed = {m["name"] for m in spec.metrics_of(bench, workload,
                                                 "per_layer")}
    new = listed & set(WINDOW_READS)
    assert len(new) == (3 if workload.startswith("sample") else 4)
    n = result["attempted"]
    kept = phases.records()
    # the set-up unit, the window's units, the measuring unit: one
    # engine, one record each
    setup, window, measuring = kept[-(n + 2)], kept[-(n + 1):-1], kept[-1]
    for name in new:
        reading = result["metrics"][name]["value"]
        want = sum(WINDOW_READS[name](r) for r in window) / n
        assert reading == pytest.approx(want, rel=1e-12), name
        assert reading > 0, name
    # a wall, unlike a count, tells the units apart
    wall = ("extend_host_s.sample" if workload.startswith("sample")
            else "batch_host_s.count")
    read = WINDOW_READS[wall]
    assert result["metrics"][wall]["value"] not in (read(setup),
                                                    read(measuring))


def test_registry_metrics_are_left_out_without_records(root, small,
                                                       monkeypatch):
    """A program with no run records (as before the registry kept them)
    gives these metrics nothing to read: the line leaves them out."""
    from sharkmer_tpu_torch.utils import phases

    monkeypatch.delattr(phases, "records")
    rc, result = traced(root, small, "count.hash.8M")
    assert rc == 0 and result["correct"]
    assert not set(result["metrics"]) & set(WINDOW_READS)
    assert "ingest_s.count" in result["metrics"]


# -- the sync audit, on the card -----------------------------------------------


def audit(root, workload, seed, device, overrides=None):
    """One unit of ``workload`` after a set-up unit, under
    ``torch.cuda.set_sync_debug_mode("warn")``: the sync warnings it
    raised, those raised outside ``phases.sync`` (and the port's frames
    they came from), and the host syncs the unit's record counted, by
    site."""
    from sharkmer_tpu_torch.utils import phases

    bench = spec.load(root)
    cell = spec.cell(bench, workload)
    cfg = spec.config(root, bench, cell["config"])
    cfg.update(overrides or {})
    traffic = spec.traffic(cell["traffic"])
    sample = gen.make_sample(cfg, seed, device)
    with tempfile.TemporaryDirectory() as work:
        unit = units.make(cfg, traffic, sample, device, units.Spans(), work)
        unit.run()
        torch.cuda.synchronize(device)
        found = {"warnings": 0, "outside": 0}
        outside = collections.Counter()
        show = warnings.showwarning

        def counted(message, *args, **kwargs):
            if "synchronizing CUDA operation" in str(message):
                found["warnings"] += 1
                if not phases.in_sync():
                    found["outside"] += 1
                    frames = [f for f in traceback.extract_stack()
                              if "sharkmer_tpu_torch" in f.filename]
                    outside[" <- ".join(
                        f"{os.path.basename(f.filename)}:{f.lineno}"
                        for f in reversed(frames[-4:]))] += 1

        warnings.showwarning = counted
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    unit.run()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        finally:
            warnings.showwarning = show
    record = phases.records()[-1]
    found["host_syncs"] = record.syncs()[0]
    found["sites"] = record.sites()
    found["outside_sites"] = dict(outside)
    return found


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["count.sorted.8M", "count.hash.8M"])
def test_every_sync_of_a_pass_goes_through_the_helper(root, small, card,
                                                      workload):
    found = audit(root, workload, 2**31 + 29, card, small)
    assert found["outside"] == 0
    assert found["warnings"] == found["host_syncs"] > 0


if __name__ == "__main__":  # the audit at a cell's own size, on the card
    import sys

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for name in sys.argv[1:]:
        found = audit(root, name, 2**31 + 101, torch.device("cuda", 0))
        print(json.dumps({"workload": name, **found}), flush=True)
