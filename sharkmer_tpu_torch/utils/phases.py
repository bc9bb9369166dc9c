"""Thread-safe sPCR phase-wall accumulators.

The bench (and any verbose CLI run) needs a permanent record of where
sPCR wall time goes — primer discovery, panel scans, device closures,
host graph extension, assembly — without a profiler run. Phases are
accumulated here from the code that owns each phase (do_pcr, run_pcr,
_drive_closure) and reported once per panel by stats.run_pcr.

Counts as well as walls are kept so per-call costs (e.g. seconds per
closure) fall out of the report.
"""

from __future__ import annotations

import threading
from collections import defaultdict

_lock = threading.Lock()
_walls: dict[str, float] = defaultdict(float)
_calls: dict[str, int] = defaultdict(int)


def add(phase: str, seconds: float, calls: int = 1) -> None:
    with _lock:
        _walls[phase] += seconds
        _calls[phase] += calls


def reset() -> None:
    with _lock:
        _walls.clear()
        _calls.clear()


def snapshot() -> dict[str, tuple[float, int]]:
    with _lock:
        return {p: (_walls[p], _calls[p]) for p in _walls}


def report() -> str:
    """One-line phase split, biggest first."""
    snap = sorted(snapshot().items(), key=lambda kv: -kv[1][0])
    return ", ".join(
        f"{p} {w:.2f}s/{n}" for p, (w, n) in snap
    )
