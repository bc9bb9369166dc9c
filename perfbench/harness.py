"""One run of one cell: set-up, the measured window, the check of what
the window produced, and the result line.

Set-up makes the sample from the seed, runs one whole unit of the
traffic (it builds and loads every kernel the window runs, and fills the
allocator's pools), and, for a traced run, wraps the kernels and starts
the profiler once. The window then repeats the unit, each from a fresh
engine, until a unit ends at or past ``seconds``: every unit in it is
whole, and its rates are taken over all its units and all its time.

After the window: the peak is read, the last unit's table is exported
and freed, and the plain reference recounts the sample (``reference/``)
to judge it and every unit's spectra; the unit's own checks judge what
else it wrote (``units/<unit>.py``). A traced run then reads the profile
and runs one more unit with measuring wraps for the kernels' bytes
(``devtrace.py``). Every metric, end to end or per layer, is read by its
file under ``metrics/``. Last, the loaded modules are checked, and a
result is printed only where none is JAX's or the JAX package's.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import torch

from . import devtrace as tr
from . import gen, note, spec, units
from .reference import count as ref_count

FORBIDDEN = ("jax", "jaxlib", "flax", "sharkmer_tpu")
# Each number compared, with its limit: the configurations state exact
# counts, so every one of them is exact (PERF.md gives the readings).
# A unit's own numbers and limits are its file's.
LIMITS = {"keys_wrong": 0, "spectra_bins_wrong": 0, "unit_errors": 0}
CLOCKS = ("clocks.sm,clocks.mem,power.draw,temperature.gpu,"
          "clocks_throttle_reasons.active")


def forbidden_modules(names) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``sharkmer_tpu_torch`` is not ``sharkmer_tpu``)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def smi(device, query: str) -> str:
    """``nvidia-smi``'s reading of ``query`` for the card, or "-"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "-"
    try:
        proc = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return proc.stdout.strip() if proc.returncode == 0 else "not read"


def card(device) -> dict:
    """The card's name and power limit, or the CPU's."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "limit": "-"}
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(device.index or 0),
            "count": 1, "limit": smi(device, "power.limit")}


def _peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def _profiler_warm(device) -> None:
    """Start and stop the profiler once, so its own first start does not
    fall in the window."""
    with torch.profiler.profile(activities=_activities(device)):
        torch.ones(1, device=device).sum().item()


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device, setup_started: float,
             overrides: dict | None = None, out=None) -> int:
    """Run the cell once and print its result line to ``out``. Returns
    the exit code. ``setup_started`` is the host clock's reading
    (``time.monotonic``) at the process's start; ``overrides`` replaces
    configuration values (the tests' small sizes)."""
    out = out or sys.stdout
    bench = spec.load(root)
    cell = spec.cell(bench, workload)
    cfg = spec.config(root, bench, cell["config"])
    cfg.update(overrides or {})
    traffic = spec.traffic(cell["traffic"])
    device = torch.device(device)
    info = card(device)
    note(f"card {info['kind']}, power limit {info['limit']}; workload "
         f"{workload}, seed {seed}, {seconds} s, trace {int(trace)}")

    t0 = time.perf_counter()
    sample = gen.make_sample(cfg, seed, device)
    note(f"sample: {sample.n_reads} reads, {sample.n_events} k-mer events, "
         f"made in {time.perf_counter() - t0:.3f} s")
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    try:
        return _run(root, bench, workload, cfg, traffic, sample, seconds,
                    trace, device, setup_started, info, workdir, out)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(root, bench, workload, cfg, traffic, sample, seconds, trace,
         device, setup_started, info, workdir, out) -> int:
    spans = units.Spans()
    unit = units.make(cfg, traffic, sample, device, spans, workdir)
    t0 = time.perf_counter()
    try:
        unit.run()
    except Exception:  # the program failed: a result that says so
        return _unit_failed(info, device, 1, out)
    note(f"set-up unit: {time.perf_counter() - t0:.3f} s")
    wraps = None
    if trace:
        wraps = tr.KernelWraps()
        wraps.install()
        _profiler_warm(device)
        spans.traced = True
    spans.clear()
    setup_peak = _peak(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.monotonic() - setup_started
    note(f"card before the window: {smi(device, CLOCKS)} ({CLOCKS})")

    prof = None
    if trace:
        prof = torch.profiler.profile(activities=_activities(device))
        prof.__enter__()
    kept, walls, cpu, bounds = [], [], [], []
    last = None
    start = time.perf_counter()
    with spans("window"):
        while True:
            last = None  # the previous unit's table goes before the next
            t, c = time.perf_counter(), time.process_time()
            try:
                done = unit.run()
            except Exception:
                if prof is not None:
                    prof.__exit__(None, None, None)
                return _unit_failed(info, device, len(walls) + 1, out)
            walls.append(time.perf_counter() - t)
            cpu.append(time.process_time() - c)
            kept.append(replace(done, engine=None))
            last, done = done.engine, None
            if wraps is not None:
                bounds.append(len(wraps.launches))
            if time.perf_counter() - start >= seconds:
                break
    window_s = time.perf_counter() - start
    if prof is not None:
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        note(f"profiler stopped in {time.perf_counter() - t:.3f} s")
    window_peak = _peak(device)
    note(f"card after the window: {smi(device, CLOCKS)}")

    n = len(walls)
    span_walls = {k: list(v) for k, v in spans.walls.items() if k != "window"}
    n_unique = last.table.n_unique()
    note(f"window: {n} units in {window_s:.4f} s; unit walls "
         + ", ".join(f"{w:.4f}" for w in walls)
         + f"; distinct keys {n_unique}")
    for name, w in span_walls.items():
        note(f"span {name}: " + ", ".join(f"{x:.4f}" for x in w))
    # the host's share: a pass whose wall follows its CPU seconds is paced
    # by the host, not the card
    note("process cpu a unit: " + ", ".join(f"{x:.3f}" for x in cpu))

    # -- the check ----------------------------------------------------------
    t = time.perf_counter()
    keys, counts = table_rows(last.table)
    last = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    note(f"table exported in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    checks, failed = judge(unit, traffic, sample, device, keys, counts, kept)
    del keys, counts
    note(f"reference check: {time.perf_counter() - t:.3f} s")

    ctx = {"unit": traffic["unit"], "units": n, "window_s": window_s,
           "setup_s": setup_s, "events": sum(d.events for d in kept),
           "peak_bytes": window_peak, "on_card": device.type == "cuda"}
    metrics = read_metrics(bench, workload, "end_to_end", ctx)
    result = {"correct": all(checks[c]["value"] <= checks[c]["limit"]
                             for c in checks),
              "attempted": n, "failed": failed}
    device_info = {"platform": info["platform"], "kind": info["kind"],
                   "count": info["count"],
                   "memory_peak_bytes": max(setup_peak, window_peak)}
    if trace:
        t = time.perf_counter()
        summary = tr.summarize(prof, tr.SPAN_PREFIX + "window")
        prof = None
        summary.update(kernel_least(wraps, unit, bounds))
        wraps.remove()
        note(f"trace read in {time.perf_counter() - t:.3f} s: busy "
             f"{summary.get('busy_s')} s of {summary.get('window_s')} s; "
             f"kernels {summary.get('kernel_note')}")
        ctx.update(spans=span_walls, trace=summary,
                   phases=[d.phases for d in kept if d.phases is not None])
        metrics = read_metrics(bench, workload, "per_layer", ctx)
        if summary.get("busy_s") is not None:
            device_info["busy_s"] = summary["busy_s"]
            device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary.get("device_ops", []),
                               "idle_gaps": summary.get("idle_gaps", [])}
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = checks
    return emit(result, 0, out)


def read_metrics(bench, workload, kind, ctx) -> dict:
    """The cell's ``end_to_end`` or ``per_layer`` metrics, each read by
    its file; one whose reader finds nothing is left out."""
    metrics = {}
    for m in spec.metrics_of(bench, workload, kind):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def emit(result: dict, rc: int, out) -> int:
    """Print the result line and its checks, unless the process holds
    JAX or the JAX package: then no result, and a code that says so."""
    leaked = forbidden_modules(sys.modules)
    if leaked:
        note(f"the process loaded {leaked}; no result")
        return 3
    for name, c in result["checks"].items():
        note(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), file=out, flush=True)
    return rc


def table_rows(table):
    """The program's count table as sorted int64 keys and their counts on
    ``device``: a sorted store's partitions (in key order, ghost and pad
    rows counted 0 left out) or a hash table's occupied slots sorted by
    key."""
    table.n_unique()  # folds what is staged into the partitions
    parts = getattr(table, "parts", None)
    if parts is not None and all(hasattr(p, "kmers") for p in parts):
        keys = [p.kmers[p.counts > 0] for p in parts]
        counts = [p.counts[p.counts > 0] for p in parts]
        return torch.cat(keys), torch.cat(counts).to(torch.int64)
    slot_keys = getattr(table, "keys", None)
    slot_counts = getattr(table, "counts", None)
    if not (isinstance(slot_keys, torch.Tensor)
            and isinstance(slot_counts, torch.Tensor)):
        raise TypeError(f"no read-out for a {type(table).__name__}")
    counts = slot_counts.to(torch.int64) & 0xFFFFFFFF  # u32 bits
    live = counts > 0
    keys, order = torch.sort(slot_keys[live])
    return keys, counts[live][order]


def _unit_failed(info, device, attempted: int, out) -> int:
    """A unit raised: its traceback to standard error, and a result that
    is not correct."""
    import traceback

    traceback.print_exc(file=sys.stderr)
    checks = {"unit_errors": {"value": 1, "limit": LIMITS["unit_errors"]}}
    result = {"correct": False, "attempted": attempted, "failed": 1,
              "metrics": {},
              "device": {"platform": info["platform"], "kind": info["kind"],
                         "count": info["count"],
                         "memory_peak_bytes": _peak(device)},
              "checks": checks}
    return emit(result, 1, out)


def judge(unit, traffic, sample, device, keys, counts, kept):
    """The numbers compared, each with its limit, and the number of units
    that got any of them wrong: the table and the spectra against the
    plain recount, then the unit's own checks."""
    found = ref_count.compare(sample.codes, sample.batch_reads, sample.k,
                              traffic["n_chunks"], units.HISTO_MAX, device,
                              keys, counts, [d.spectra for d in kept])
    names = ["keys_wrong"]
    if traffic["n_chunks"] > 0:
        names.append("spectra_bins_wrong")
    wrong = [b > 0 for b in found["bins_by_unit"]]
    wrong[-1] = wrong[-1] or found["keys_wrong"] > 0
    checks = {name: {"value": int(found[name]), "limit": LIMITS[name]}
              for name in names}
    own, own_wrong = unit.checks(kept)
    checks.update(own)
    return checks, sum(a or b for a, b in zip(wrong, own_wrong))


def kernel_least(wraps, unit, bounds) -> dict:
    """Least and device seconds of the wrapped kernels' launches in the
    window. One more unit with measuring wraps gives each launch's bytes;
    it must launch what each window unit launched, shape for shape."""
    launches = wraps.launches
    per_unit = [launches[a:b] for a, b in zip([0] + bounds[:-1], bounds)]
    wraps.launches, wraps.bytes, wraps.measuring = [], [], True
    unit.run()
    measured, nbytes = wraps.launches, wraps.bytes
    if not launches:
        return {"kernel_note": "no wrapped kernel launched"}
    if any(u != measured for u in per_unit):
        return {"kernel_note": "the window's launches differ from the "
                               "measured unit's"}
    return {"kernel_least_s": len(per_unit) * sum(tr.least_s(b)
                                                  for b in nbytes),
            "kernel_launches": len(launches),
            "kernel_note": f"{len(launches)} launches, {len(per_unit)} units"}

