"""Host-side count views for the sPCR engine.

``SmallCounts`` is the host equivalent of the reference's small
``KmerCounts`` result tables (primer-matching k-mers — tens of
entries). ``FilteredTable`` is the lazy min-count view over the device
table (``FilteredKmerCounts``, counting.rs:316-350): lookups apply the
global --min-kmer-count threshold on the fly, no data is copied.

Lookup strategies (``mode``):

* ``auto`` (default): when the backend supports device reachability
  closures (SortedKmerStore.reach), graph-extension waves are served
  by per-walk PrefetchSession caches (pcr/prefetch.py) — the table
  never leaves the device and only the walk's own neighbourhood
  crosses the link. Otherwise degrades to ``full`` for small tables
  and ``device`` beyond MIRROR_MAX_UNIQUE.
* ``full``: one-time full-table device->host export (sorted mirror);
  waves served by host searchsorted. Pays the export once but makes
  every later lookup free.
* ``device``: no host state; every wave is a synchronous device
  lookup. Exact at any table size, dominated by round-trip latency.

Primer scans go to the device in every mode (``table.prefix_scan`` —
range queries on the sorted backend, a full sweep on the hash
backend); their outputs are tiny.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field

import numpy as np

from ..ops.encoding import revcomp_kmer
from ..ops.sorted_store import SortedKmerStore as KmerTable

log = logging.getLogger("sharkmer")


class SmallCounts:
    """Tiny kmer -> count map with the reference's stat accessors."""

    def __init__(self, k: int, items: dict[int, int] | None = None):
        self.k = k
        self.data: dict[int, int] = dict(items or {})

    def insert(self, kmer: int, count: int) -> None:
        cur = self.data.get(kmer, 0)
        self.data[kmer] = min(cur + count, 0xFFFF_FFFF)

    def get(self, kmer: int) -> int | None:
        return self.data.get(kmer)

    def __len__(self) -> int:
        return len(self.data)

    def __bool__(self) -> bool:
        return bool(self.data)

    def items(self):
        return self.data.items()

    def kmers(self) -> list[int]:
        return list(self.data.keys())

    def get_max_count(self) -> int:
        return max(self.data.values(), default=0)

    def get_median_count(self) -> int:
        """Integer median with the reference's even-length halving
        semantics: (lower_max // 2) + (upper_min // 2)
        (counting.rs:275-298)."""
        counts = sorted(self.data.values())
        if not counts:
            return 0
        mid = len(counts) // 2
        if len(counts) % 2 == 0:
            return counts[mid - 1] // 2 + counts[mid] // 2
        return counts[mid]


# Above this many unique k-mers the full host mirror is not built
# (memory); auto mode then degrades to device lookups when the backend
# has no reach support. It also caps the closure-overflow fallback's
# mirror (~12 B/key of host RAM), past which the fallback is per-wave
# lookups.
MIRROR_MAX_UNIQUE = 256_000_000


@dataclass
class FilteredTable:
    """Read-only min-count view of a device count backend."""

    table: KmerTable
    min_count: int
    mode: str = "auto"  # auto | full | device
    prefetch_depth: int = 2048
    _mirror: tuple[np.ndarray, np.ndarray] | None = None
    # one gene pool shares this view: without the lock every worker
    # would race to build the same multi-second mirror
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    # primer-scan results pre-fetched for the whole panel in one
    # batched dispatch (primers.warm_panel_scans): (oligo_len, sorted
    # oligo bytes) -> (kmers, counts) at min count 1
    _scan_cache: dict = field(
        default_factory=dict, repr=False, compare=False
    )

    @property
    def k(self) -> int:
        return self.table.k

    _mode_cache: str | None = field(default=None, repr=False)

    def _resolved_mode(self) -> str:
        if self._mode_cache is not None:
            return self._mode_cache
        if self.mode == "device":
            resolved = "device"
        elif self.mode == "auto" and hasattr(self.table, "reach"):
            resolved = "prefetch"
        elif self._mirror is not None:
            resolved = "full"
        else:
            # full requested, or auto on a backend without reach support
            try:
                small = self.table.n_unique() <= MIRROR_MAX_UNIQUE
            except Exception:
                small = False
            resolved = "full" if small else "device"
        self._mode_cache = resolved
        return resolved

    def extension_session(self, threshold: int):
        """Per-walk lookup provider for extend_graph: a PrefetchSession
        in prefetch mode, the view itself otherwise."""
        if self._resolved_mode() == "prefetch":
            from .prefetch import PrefetchSession

            return PrefetchSession(self, threshold, depth=self.prefetch_depth)
        return self

    def warm_caches(self) -> None:
        """One-time builds shared by the gene pool: the device sPCR
        indexes (prefetch mode) or the host mirror (full mode)."""
        mode = self._resolved_mode()
        if mode == "prefetch":
            try:
                self.table.prepare_spcr()
            except Exception:
                # very large tables can exhaust HBM building the sPCR
                # sidecars: degrade to the mirror (small table) or
                # per-wave device lookups instead of crashing the run
                log.warning(
                    "sPCR device-index build failed; falling back from "
                    "reach-prefetch mode", exc_info=True,
                )
                try:
                    small = self.table.n_unique() <= MIRROR_MAX_UNIQUE
                except Exception:
                    small = False
                self._mode_cache = "full" if small else "device"
                self.warm_caches()
                return
            # compile the closure kernel at the production variants so
            # the first genes' walks don't pay the (tens of seconds)
            # compile: both standard frontier shapes, and a min_count
            # just below the packed-count saturation cap — high enough
            # that the warmup quiesces after the root level, low enough
            # to select the same packed kernel production calls use
            spare = 64 - 2 * self.table.k
            warm_mc = (1 << spare) - 2 if spare >= 12 else (1 << 30)
            # f_cap 256 and 1024 shapes, plus the warm-started (pre)
            # variant at 256 that mid-walk re-prefetches hit
            for n_roots, pre in ((1, None), (257, None),
                                 (1, np.arange(300, 320, dtype=np.uint64))):
                try:
                    self.table.reach(
                        np.arange(1, n_roots + 1, dtype=np.uint64),
                        warm_mc, depth=self.prefetch_depth, pre=pre,
                    )
                except Exception:  # pragma: no cover - best-effort
                    # a silent warmup failure pushes a tens-of-seconds
                    # kernel compile into the first gene's wall time:
                    # surface it where default logging shows it
                    log.warning(
                        "reach warmup failed (first gene will pay the "
                        "closure-kernel compile)", exc_info=True,
                    )
        elif mode == "full":
            self._get_mirror()

    def mirror_rows(self) -> int:
        """Occupied row count of the host mirror (0 if not built)."""
        return len(self._mirror[0]) if self._mirror is not None else 0

    def _get_mirror(self):
        """(sorted kmers, counts) restricted to rows >= the view's
        min_count: sub-threshold rows are invisible through a
        FilteredTable anyway, and dropping them on device shrinks the
        export payload before it crosses the slow link."""
        if self._mirror is not None:  # hot path: one read per BFS wave
            return self._mirror
        with self._lock:
            if self._mirror is None:
                if hasattr(self.table, "to_sorted_arrays"):
                    self._mirror = self.table.to_sorted_arrays(
                        min_count=self.min_count
                    )
                else:  # generic fallback
                    pairs = self.table.to_dict()
                    kmers = np.fromiter(
                        pairs.keys(), dtype=np.uint64, count=len(pairs)
                    )
                    counts = np.fromiter(
                        pairs.values(), dtype=np.uint32, count=len(pairs)
                    )
                    keep = counts >= np.uint32(max(self.min_count, 1))
                    kmers, counts = kmers[keep], counts[keep]
                    order = np.argsort(kmers)
                    self._mirror = (kmers[order], counts[order])
        return self._mirror

    def get_canonical_many(self, kmers: np.ndarray) -> np.ndarray:
        """Counts for directional k-mers; entries below the global
        threshold report 0 (i.e. absent)."""
        if self._resolved_mode() == "full":
            from ..ops.encoding import revcomp_kmers_np

            q = np.asarray(kmers, dtype=np.uint64).reshape(-1)
            canon = np.minimum(q, revcomp_kmers_np(q, self.k))
            mk, mc = self._get_mirror()
            idx = np.searchsorted(mk, canon)
            idx = np.minimum(idx, max(len(mk) - 1, 0))
            if len(mk):
                hit = mk[idx] == canon
                counts = np.where(hit, mc[idx], 0).astype(np.uint32)
            else:
                counts = np.zeros(len(canon), np.uint32)
        else:
            counts = np.array(self.table.lookup_directional(kmers))
        counts[counts < self.min_count] = 0
        return counts

    def find_primer_matches(self, oligos: np.ndarray, oligo_len: int,
                            min_count: int):
        """All table k-mers starting with an oligo on either strand
        (find_oligos_in_kmers semantics: forward precedence, RC hits
        revcomp-normalized). Served from the panel-batched scan cache
        when warm_panel_scans pre-fetched this oligo set, else on
        device — range queries on the sorted backend, a sweep on the
        hash backend; outputs are tiny either way."""
        oligos = np.asarray(oligos, dtype=np.uint64)
        hit = self._scan_cache.get((oligo_len, oligos.tobytes()))
        if hit is not None:
            km, ct = hit
            keep = ct >= np.uint32(max(min_count, 1))
            return km[keep], ct[keep]
        return self.table.prefix_scan(oligos, oligo_len, min_count)

    def get_canonical(self, kmer: int) -> int | None:
        c = int(self.get_canonical_many(np.array([kmer], np.uint64))[0])
        return c if c > 0 else None

    def get_canonical_count(self, kmer: int) -> int:
        return int(self.get_canonical_many(np.array([kmer], np.uint64))[0])

    def revcomp(self, kmer: int) -> int:
        return revcomp_kmer(kmer, self.k)
