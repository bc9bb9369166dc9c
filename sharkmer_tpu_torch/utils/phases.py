"""The port's trace registry: run records, spans, counters and host syncs.

A run record begins with each ``CountingEngine`` (one CLI run, or one
unit of the benchmark; ``begin``). Everything is charged to the newest
record, and ``records()`` keeps the last ``RECORDS_KEPT``, oldest first,
each with an ``id`` that all its spans share.

* ``span(name)`` times a piece of work. Spans nest per thread; each adds
  a call, its host wall (``time.perf_counter``), its self time (the wall
  less its child spans') and its longest wall to the record, keyed by
  its path (the names of the open spans, outermost first). Only while a
  ``torch.profiler`` or autograd profiler records is a span also a
  ``record_function("sharkmer.<name>")`` range, on the device trace's
  clock. A span never synchronises, launches or allocates on a device.
* ``sync(site)`` goes around one call that blocks the host on the device:
  a read to the host (``int(t)``, ``.item()``, ``.tolist()``,
  ``.cpu()``), a boolean mask, ``nonzero``, ``unique``, a pageable
  upload. It counts the call as a host sync of ``site`` and adds its wall
  to the sync wait, both charged to the innermost open span.
* ``count(name, n)`` adds to a counter, charged the same way.

Each thread adds into a tally of its own a record, merged when the
record is read: the hot path takes no lock. A gene thread charges the
record that is newest when it starts a span: the sample's.

The sPCR phase view (``add``, ``reset``, ``snapshot``, ``report``; the
``sPCR phases:`` line of ``stats.run_pcr``, the benchmark's
``closure_s.sample``): ``reset()`` marks the newest record, and
``snapshot()`` gives the wall and calls of each span name since the
mark. Spans inside ``warm_caches`` are left out of it: its reach calls
load the closure kernel, and are no sPCR closures.
"""

from __future__ import annotations

import threading
from collections import deque
from contextlib import contextmanager
from itertools import count as _ids
from time import perf_counter
from typing import NamedTuple

from torch.autograd import profiler as _profiler

RECORDS_KEPT = 64
RANGE_PREFIX = "sharkmer."
WARM_UP = "warm_caches"

_lock = threading.Lock()  # begin() and the phase mark
_records: deque = deque(maxlen=RECORDS_KEPT)
_next_id = _ids(1)
_current = None
_mark = (None, {}, {})  # (record, its spans and counters at reset())


class Stat(NamedTuple):
    calls: int
    wall: float  # outermost spans of the name only: no wall counted twice
    self_s: float
    max_s: float


class _Tally:
    """One thread's part of a record."""

    def __init__(self):
        # path -> [calls, wall, self, max wall]
        self.spans: dict[tuple, list] = {}
        # (path, site) -> [syncs, wait]
        self.syncs: dict[tuple, list] = {}
        # (path, name) -> n
        self.counters: dict[tuple, int] = {}


class Record:
    """One run's spans, host syncs and counters."""

    def __init__(self):
        self.id = next(_next_id)
        self._tallies: list[_Tally] = []

    def _new_tally(self) -> _Tally:
        tally = _Tally()
        self._tallies.append(tally)
        return tally

    def _merged(self, attr: str) -> dict:
        out: dict = {}
        for tally in list(self._tallies):
            for key, v in list(getattr(tally, attr).items()):
                if isinstance(v, list):
                    have = out.setdefault(key, [0] * len(v))
                    for i, x in enumerate(v):
                        have[i] = max(have[i], x) if i == 3 else have[i] + x
                else:
                    out[key] = out.get(key, 0) + v
        return out

    def spans(self) -> dict[tuple, list]:
        """Path -> [calls, wall, self, max wall], over the threads."""
        return self._merged("spans")

    def total(self, name: str) -> Stat:
        """The spans named ``name``, wherever they ran."""
        calls = wall = self_s = max_s = 0
        for path, (n, w, s, m) in self.spans().items():
            if path[-1] != name:
                continue
            calls += n
            self_s += s
            if name not in path[:-1]:
                wall += w
                max_s = max(max_s, m)
        return Stat(calls, wall, self_s, max_s)

    def sites(self, *within: str) -> dict[str, list]:
        """Site -> [syncs, wait] of the host syncs inside a span of one
        of ``within``, or inside any span when none is named."""
        out: dict[str, list] = {}
        for (path, site), (n, w) in self._merged("syncs").items():
            if path and (not within or any(r in path for r in within)):
                have = out.setdefault(site, [0, 0.0])
                have[0] += n
                have[1] += w
        return out

    def syncs(self, *within: str) -> tuple[int, float]:
        """(host syncs, their wait) inside ``within`` (see ``sites``)."""
        found = self.sites(*within).values()
        return sum(n for n, _w in found), sum(w for _n, w in found)

    def counter(self, name: str) -> int:
        return sum(n for (_path, c), n in self._merged("counters").items()
                   if c == name)

    def describe(self, *roots: str) -> str:
        """The spans under ``roots`` (calls, wall, self time), the
        counters counted inside them, and their host syncs by site: the
        CLI's ``count trace:`` line. A span or counter seen under
        ``roots`` is given over the whole record (the record-stream
        entry's groups run outside ``ingest.batch``)."""
        names = dict.fromkeys(
            path[-1] for path in self.spans() if path[0] in roots)
        parts = []
        for name in names:
            s = self.total(name)
            parts.append(f"{name} {s.wall:.3f}s/{s.calls} "
                         f"(self {s.self_s:.3f}s)")
        counters = dict.fromkeys(
            name for path, name in self._merged("counters")
            if path and path[0] in roots)
        parts.extend(f"{name} {self.counter(name)}" for name in counters)
        sites = self.sites(*roots)
        n, wait = self.syncs(*roots)
        by_site = ", ".join(f"{site} {v[0]}"
                            for site, v in sorted(sites.items(),
                                                  key=lambda kv: -kv[1][0]))
        return (", ".join(parts) + f"; host_syncs {n} ({by_site}), "
                f"sync_wait {wait:.3f}s")


class _Thread(threading.local):
    def __init__(self):
        self.record = None  # the record ``tally`` belongs to
        self.tally = None
        self.stack: list[list] = []  # [path, start, child wall, tally]
        self.syncing = 0


_thread = _Thread()


def begin() -> Record:
    """Start a run record; it is the newest until the next one."""
    global _current
    with _lock:
        _current = Record()
        _records.append(_current)
        return _current


def current() -> Record:
    """The newest record (one begun here if there is none)."""
    return _current or begin()


def records() -> list[Record]:
    """The last ``RECORDS_KEPT`` records, oldest first."""
    return list(_records)


def _tally() -> _Tally:
    """The calling thread's tally: of its innermost open span's record,
    else of the newest record."""
    t = _thread
    if t.stack:
        return t.stack[-1][3]
    record = current()
    if t.record is not record:
        t.record, t.tally = record, record._new_tally()
    return t.tally


def _path() -> tuple:
    stack = _thread.stack
    return stack[-1][0] if stack else ()


@contextmanager
def span(name: str, tag: str | None = None):
    """Time the block as the span ``name`` (``tag``, say a gene and its
    thread, only names the profiler range)."""
    t = _thread
    if t.stack:
        parent = t.stack[-1]
        path, tally = parent[0] + (name,), parent[3]
    else:
        parent, path, tally = None, (name,), _tally()
    ranged = None
    if _profiler._is_profiler_enabled:
        label = RANGE_PREFIX + name + (f"[{tag}]" if tag else "")
        ranged = _profiler.record_function(label)
        ranged.__enter__()
    frame = [path, perf_counter(), 0.0, tally]
    t.stack.append(frame)
    try:
        yield
    finally:
        t.stack.pop()
        wall = perf_counter() - frame[1]
        if ranged is not None:
            ranged.__exit__(None, None, None)
        s = tally.spans.get(path)
        if s is None:
            s = tally.spans[path] = [0, 0.0, 0.0, 0.0]
        s[0] += 1
        s[1] += wall
        s[2] += wall - frame[2]
        s[3] = max(s[3], wall)
        if parent is not None:
            parent[2] += wall


@contextmanager
def sync(site: str, calls: int = 1):
    """Count the block as ``calls`` host syncs of ``site`` (one call that
    blocks the host on the device, or ``calls`` of them in one library
    call) and its wall as their wait."""
    t = _thread
    t.syncing += 1
    start = perf_counter()
    try:
        yield
    finally:
        wait = perf_counter() - start
        t.syncing -= 1
        key = (_path(), site)
        syncs = _tally().syncs
        s = syncs.get(key)
        if s is None:
            s = syncs[key] = [0, 0.0]
        s[0] += calls
        s[1] += wait


def in_sync() -> bool:
    """Whether the calling thread is inside ``sync`` (the sync audit's
    test: every blocking call of the count path is inside one)."""
    return _thread.syncing > 0


def count(name: str, n: int = 1) -> None:
    key = (_path(), name)
    counters = _tally().counters
    counters[key] = counters.get(key, 0) + n


# -- the sPCR phase view ------------------------------------------------------


def add(phase: str, seconds: float, calls: int = 1) -> None:
    """Add a wall timed elsewhere as ``calls`` spans named ``phase``."""
    path = _path() + (phase,)
    spans = _tally().spans
    s = spans.get(path)
    if s is None:
        s = spans[path] = [0, 0.0, 0.0, 0.0]
    s[0] += calls
    s[1] += seconds
    s[2] += seconds
    s[3] = max(s[3], seconds)


def reset() -> None:
    """Start the phase view: spans closed before now are left out."""
    global _mark
    record = current()
    with _lock:
        _mark = (record, record.spans(), record._merged("counters"))


def _since_mark() -> tuple[dict, dict]:
    """The newest record's spans and counters less their values at the
    mark."""
    record = current()
    marked, spans_at, counters_at = _mark
    spans = record.spans()
    counters = record._merged("counters")
    if marked is record:
        for path, before in spans_at.items():
            if path in spans:
                spans[path] = [a - b for a, b in zip(spans[path], before)]
        for key, before in counters_at.items():
            counters[key] = counters.get(key, 0) - before
    return spans, counters


def snapshot() -> dict[str, tuple[float, int]]:
    """Span name -> (wall, calls) since ``reset``, the warm-up's inner
    spans left out; each call's wall is summed over threads."""
    spans, _counters = _since_mark()
    out: dict[str, list] = {}
    for path, (n, w, _s, _m) in spans.items():
        if n <= 0 or WARM_UP in path[:-1]:
            continue
        have = out.setdefault(path[-1], [0.0, 0])
        have[1] += n
        if path[-1] not in path[:-1]:
            have[0] += w
    return {name: (w, n) for name, (w, n) in out.items()}


def report() -> str:
    """One-line phase split, biggest first, then the counters since
    ``reset`` (``closure_levels``: the closures' levels), the warm-up's
    left out."""
    snap = sorted(snapshot().items(), key=lambda kv: -kv[1][0])
    counters: dict[str, int] = {}
    for (path, name), n in _since_mark()[1].items():
        if n > 0 and WARM_UP not in path:
            counters[name] = counters.get(name, 0) + n
    return ", ".join([f"{p} {w:.2f}s/{n}" for p, (w, n) in snap]
                     + [f"{c} {n}" for c, n in sorted(counters.items())])
