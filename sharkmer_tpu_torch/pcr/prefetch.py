"""Host-side prefetch session: the cache layer between the exact host
graph extension and the device reach kernel.

One session serves one (gene, threshold-step) extension walk
(pcr/graph.py extend_graph). Waves query through
``get_canonical_many``; the session answers from a local numpy cache
filled by depth-capped device closures (ops/reach.py):

* cache hit -> exact table count (zeroed below the step threshold,
  which is exactly how the host treats it: extend_graph skips any
  candidate whose count is below the step's min_count);
* cache miss within the covered horizon -> provably below threshold
  (the closure is a superset of every candidate the walk can enumerate
  within ``depth`` waves of the prefetch roots) -> 0;
* horizon exhausted -> re-prefetch rooted at the current wave's
  candidates;
* closure ran to quiescence -> misses trusted for the rest of the walk
  (the common case: one device call per gene x step).

If the device closure overflows its retry ladder (pathological
connectivity, e.g. the floor threshold on a deep table, where the
above-threshold background is one giant component), the session
degrades to the shared host mirror when the filtered table is small
enough to export (one multi-second transfer amortized across the gene
pool via FilteredTable's lock), else to exact per-wave device lookups
— slower but correct either way.
"""

from __future__ import annotations

import logging

import numpy as np

from ..ops.encoding import revcomp_kmers_np

log = logging.getLogger("sharkmer")


class PrefetchSession:
    """Lookup provider for one extension walk at one threshold."""

    def __init__(self, view, threshold: int, depth: int = 512):
        self.view = view
        self.k = view.k
        # the host skips candidates below both the step threshold and
        # the view's global floor, so the closure may prune at the max
        self.threshold = max(int(threshold), int(view.min_count), 1)
        self.depth = depth
        self._keys = np.zeros(0, np.uint64)
        self._counts = np.zeros(0, np.uint32)
        self._waves_left = 0
        self._complete = False  # closure quiesced: misses final
        self._dead = False  # device overflowed: mirror/per-wave fallback
        self._fallback_mirror = None  # (sorted keys, counts) after overflow
        # cutoff-frontier keys of every depth-capped closure so far:
        # these rows' neighbours were never explored, so they must stay
        # OUT of a later closure's warm-start interior
        self._boundary = np.zeros(0, np.uint64)
        self.n_prefetches = 0
        self.device_iters = 0

    def get_canonical_many(self, kmers: np.ndarray) -> np.ndarray:
        q = np.asarray(kmers, dtype=np.uint64).reshape(-1)
        canon = np.minimum(q, revcomp_kmers_np(q, self.k))
        if self._dead:
            return self._device_exact(canon)
        if not self._complete and self._waves_left <= 0:
            self._prefetch(canon)
            if self._dead:
                return self._device_exact(canon)
        self._waves_left -= 1
        idx = np.searchsorted(self._keys, canon)
        idx = np.minimum(idx, max(len(self._keys) - 1, 0))
        if len(self._keys):
            hit = self._keys[idx] == canon
            return np.where(hit, self._counts[idx], 0).astype(np.uint32)
        return np.zeros(len(canon), np.uint32)

    def _device_exact(self, canon: np.ndarray) -> np.ndarray:
        if self._fallback_mirror is not None:
            mk, mc = self._fallback_mirror
            idx = np.searchsorted(mk, canon)
            idx = np.minimum(idx, max(len(mk) - 1, 0))
            if len(mk):
                hit = mk[idx] == canon
                counts = np.where(hit, mc[idx], 0).astype(np.uint32)
            else:
                counts = np.zeros(len(canon), np.uint32)
        else:
            counts = np.asarray(self.view.table.lookup_directional(canon))
        counts[counts < self.threshold] = 0
        return counts

    def _prefetch(self, roots: np.ndarray) -> None:
        pre = None
        if len(self._keys):
            # warm-start with the cache's CLOSED interior: every cached
            # row except the previous closures' cutoff frontiers (their
            # neighbours were never explored) and the new roots (they
            # must be processed, not skipped). Without this, a mid-walk
            # re-prefetch re-expands backward over the covered region
            # on long low-coverage chains.
            pre = np.setdiff1d(
                self._keys, np.concatenate([self._boundary, roots])
            )
        res = self.view.table.reach(
            roots, self.threshold, self.depth, pre=pre
        )
        if res is None:
            self._dead = True
            from .counts import MIRROR_MAX_UNIQUE

            try:
                small = self.view.table.n_unique() <= MIRROR_MAX_UNIQUE
            except Exception:
                small = False
            if small:
                log.debug(
                    "prefetch overflow at threshold %d: falling back to "
                    "the shared host mirror", self.threshold,
                )
                self._fallback_mirror = self.view._get_mirror()
            else:
                log.debug(
                    "prefetch overflow at threshold %d: falling back to "
                    "per-wave device lookups", self.threshold,
                )
            return
        self.n_prefetches += 1
        self.device_iters += res.iters
        self._boundary = np.union1d(self._boundary, res.boundary)
        if len(self._keys):
            keys = np.concatenate([self._keys, res.keys])
            counts = np.concatenate([self._counts, res.counts])
            order = np.argsort(keys)
            keys, counts = keys[order], counts[order]
            keep = np.concatenate([[True], keys[1:] != keys[:-1]])
            self._keys, self._counts = keys[keep], counts[keep]
        else:
            self._keys, self._counts = res.keys, res.counts
        self._complete = res.complete
        self._waves_left = self.depth
