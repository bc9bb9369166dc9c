"""The traced run's readings: device busy time, idle gaps, and each
hand-written kernel's launches against its least time.

The four kernels of the count path are wrapped where the port's stores
call them (``KERNELS``). In the traced window a wrap only names its
launch for the profiler (``perfbench.kernel.<name>``) and notes its
argument shapes. Bytes that depend on the data are read afterwards, in
one more unit run with measuring wraps: the program is deterministic on
a given input, so that unit's launches, shape for shape, are each traced
unit's. A launch's least time is the larger of its bytes over the card's
memory rate and its operations over the card's peak; these kernels move
keys and do next to no arithmetic, so bytes bound them.
"""

from __future__ import annotations

import bisect
import importlib
import sys
import time
from collections import defaultdict

import torch

# The NVIDIA H100 SXM's data sheet (dense rates, at its 700 W limit): HBM3
# at 3.35 TB/s, the rate of PERF.md's kernel table and of the port's
# chip_smoke.py (HBM_BYTES_PER_MS = 3.35e9, byte_bound).
HBM_BYTES_PER_S = 3.35e12
SECTOR = 32  # bytes of a DRAM sector, the unit a random access moves
SPAN_PREFIX = "perfbench."
KERNEL_PREFIX = SPAN_PREFIX + "kernel."
NAME_CHARS = 160  # of a device operation's name in the breakdown


def merged(intervals) -> float:
    """Total length of the union of (start, end) intervals, in their
    unit (a copy of the port's tools/trace_spcr.py ``_merged_ms``,
    without its conversion)."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


# -- least bytes of each kernel's launch ------------------------------------
#
# As PERF.md's kernel table counts them: each input read once, each output
# written once; for hash_insert the batch read once and each 32 B sector
# of the table that holds a key it adds to read and written once.


def run_scan_bytes(args, kwargs, changed) -> int:
    """run_ends / run_starts: n int64 keys in, n int32 positions out."""
    return 12 * args[0].numel()


def stitch_bytes(args, kwargs, changed) -> int:
    """stitch_rows(rows [R, W], offs [R], fill): each row's kept prefix
    read once (the last row whole), the offsets read, the R*W output
    written (chip_smoke.py's kernel_phase bound)."""
    rows, offs = args[0], args[1]
    n_rows, width = rows.shape
    kept = int(offs[-1]) + width
    return 8 * kept + 4 * n_rows + 8 * n_rows * width


def hash_insert_bytes(args, kwargs, changed) -> int:
    """hash_insert(slots, claims, entries, amounts=None, ...): the entries
    read once (8 B keys and 4 B amounts, or 16 B source slots), and each
    sector of ``slots`` whose contents the launch changed read and
    written once."""
    entries = args[2]
    amounts = args[3] if len(args) > 3 else kwargs.get("amounts")
    entry = entries.element_size() * (entries.shape[1] if entries.dim() == 2
                                      else 1)
    if amounts is not None:
        entry += amounts.element_size()
    return entry * entries.shape[0] + 2 * SECTOR * changed


def changed_sectors(before: torch.Tensor, after: torch.Tensor) -> int:
    """Sectors of a table whose rows (slots) differ between two copies."""
    rows = after.reshape(after.shape[0], -1)
    changed = (rows != before.reshape(rows.shape)).any(dim=1)
    slot = rows.shape[1] * after.element_size()
    idx = torch.nonzero(changed).reshape(-1) * slot // SECTOR
    return int(torch.unique_consecutive(idx).numel())


# (module the store calls it from, attribute, least bytes)
KERNELS = {
    "run_ends": ("sharkmer_tpu_torch.ops.sorted_store", "run_ends",
                 run_scan_bytes),
    "run_starts": ("sharkmer_tpu_torch.ops.sorted_store", "run_starts",
                   run_scan_bytes),
    "stitch_rows": ("sharkmer_tpu_torch.ops.sorted_store", "stitch_rows",
                    stitch_bytes),
    "hash_insert": ("sharkmer_tpu_torch.ops.hashtable", "hash_insert",
                    hash_insert_bytes),
}


def _signature(name, args) -> tuple:
    return (name,) + tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor))


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.device.type == "cuda"
               for a in args)


class KernelWraps:
    """Wraps of the kernels' entry points. ``launches`` lists each card
    launch's signature; with ``measuring`` set, each is followed by its
    least bytes."""

    def __init__(self):
        self.launches: list[tuple] = []
        self.bytes: list[int] = []
        self.measuring = False
        self._saved = []

    def install(self) -> None:
        for name, (module, attr, nbytes) in KERNELS.items():
            mod = importlib.import_module(module)
            fn = getattr(mod, attr, None)
            if fn is None:  # the store no longer calls it: nothing to read
                continue
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(name, fn, nbytes))

    def remove(self) -> None:
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        self._saved = []

    def _wrap(self, name, fn, nbytes):
        def wrapped(*args, **kwargs):
            if not _on_card(args):
                return fn(*args, **kwargs)
            self.launches.append(_signature(name, args))
            if not self.measuring:
                with torch.profiler.record_function(KERNEL_PREFIX + name):
                    return fn(*args, **kwargs)
            # the table the launch writes, kept to see what it changed
            before = args[0].clone() if name == "hash_insert" else None
            out = fn(*args, **kwargs)
            changed = (None if before is None
                       else changed_sectors(before, args[0]))
            del before
            self.bytes.append(nbytes(args, kwargs, changed))
            return out

        return wrapped


def least_s(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S


# -- the profiler's events ---------------------------------------------------
#
# Read from the profiler's raw events (``kineto_results``): building its
# Python event tree takes minutes for a window of chunked passes.


def _cpu(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type() == DeviceType.CPU


def _device_work(e) -> bool:
    """A kernel, copy or set on the card (not a range's projection)."""
    from torch.autograd import DeviceType

    annotation = getattr(e, "is_user_annotation", None)
    return (e.device_type() == DeviceType.CUDA
            and not e.name().startswith(SPAN_PREFIX)
            and not (annotation is not None and annotation()))


def summarize(prof, window_name: str) -> dict:
    """Busy and idle time of the card inside the span ``window_name``,
    the device time of each wrapped kernel's launches, the operations
    that took most time and the longest idle gaps, each named by the
    benchmark's innermost span around it. Times in seconds."""
    t = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    print(f"perfbench: {len(events)} profiler events read in "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
    spans = [e for e in events if _cpu(e)
             and e.name().startswith(SPAN_PREFIX)]
    window = [e for e in spans if e.name() == window_name]
    if not window:
        return {}
    lo, hi = window[0].start_ns(), window[0].end_ns()
    device = [e for e in events if _device_work(e)
              and e.end_ns() > lo and e.start_ns() < hi]
    intervals = [(max(e.start_ns(), lo), min(e.end_ns(), hi))
                 for e in device]
    busy_ns = merged(intervals)

    by_name = defaultdict(float)
    for e in device:
        by_name[e.name()] += e.end_ns() - e.start_ns()
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    inner = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in spans
                    if e.name() != window_name
                    and not e.name().startswith(KERNEL_PREFIX)),
                   key=lambda t: t[1] - t[0])

    def host_doing(t: float) -> str:
        for s, e, name in inner:  # the shortest span that holds t
            if s <= t <= e:
                return name[len(SPAN_PREFIX):]
        return "between units"

    idle = sorted(gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (hi - lo) / 1e9,
        "kernel_device_s": kernel_device_s(events, spans),
        "device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in ops],
        "idle_gaps": [[host_doing((s + e) / 2), (e - s) / 1e9]
                      for s, e in idle],
    }


def kernel_device_s(events, spans) -> dict:
    """Device seconds of each launch a wrap named, by kernel: the device
    work whose correlation id is that of a kernel launch made inside the
    wrap's range (the profiler leaves the device events' link to the
    range itself unset)."""
    device = defaultdict(float)
    for e in events:
        if _device_work(e):
            device[e.correlation_id()] += e.end_ns() - e.start_ns()
    calls = sorted((e.start_ns(), e.correlation_id()) for e in events
                   if _cpu(e) and "LaunchKernel" in e.name())
    starts = [t for t, _c in calls]
    out = defaultdict(list)
    for e in spans:
        if e.name().startswith(KERNEL_PREFIX):
            a = bisect.bisect_left(starts, e.start_ns())
            b = bisect.bisect_right(starts, e.end_ns())
            out[e.name()[len(KERNEL_PREFIX):]].append(
                sum(device.get(c, 0.0) for _t, c in calls[a:b]) / 1e9)
    return dict(out)
