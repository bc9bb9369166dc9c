"""Terminal progress reporting — the indicatif analog.

The reference shows tty-gated progress bars/spinners during ingest and
graph extension (upstream sharkmer src/io.rs:392-410, main.rs:100),
silent when stderr is not a terminal. Same contract here: a single
throttled, thread-safe, carriage-return-rewritten status line on
stderr. When stderr is redirected (tests, pipelines, SLURM logs) every
call is a no-op, so log files stay clean.
"""

from __future__ import annotations

import sys
import threading
import time


class Progress:
    """One rewritten status line on stderr; disabled off-tty."""

    def __init__(self, enabled: bool | None = None,
                 min_interval: float = 0.1):
        if enabled is None:
            try:
                enabled = sys.stderr.isatty()
            except Exception:
                enabled = False
        self.enabled = enabled
        self.min_interval = min_interval
        self._lock = threading.Lock()
        # -inf so the first tick always draws (monotonic() can be < the
        # interval right after boot, which would silently drop it)
        self._last_t = float("-inf")
        self._last_w = 0  # width of the currently displayed line

    def tick(self, msg: str, *, force: bool = False) -> None:
        """Redraw the status line (throttled to min_interval)."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_t < self.min_interval:
                return
            self._last_t = now
            pad = max(0, self._last_w - len(msg))
            sys.stderr.write("\r" + msg + " " * pad)
            sys.stderr.flush()
            self._last_w = len(msg)

    def finish(self) -> None:
        """Clear the status line (call before normal log output resumes)."""
        if not self.enabled:
            return
        with self._lock:
            if self._last_w:
                sys.stderr.write("\r" + " " * self._last_w + "\r")
                sys.stderr.flush()
            self._last_w = 0
            self._last_t = float("-inf")


# Shared instance: ingest and the per-gene extension workers all write
# through one line (last writer wins — matches a multi-spinner collapsing
# to the most recent update, without interleaving torn lines).
_global = Progress()


def get_progress() -> Progress:
    return _global
