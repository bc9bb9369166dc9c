"""Bounded Levenshtein distance (banded DP).

Equivalent of bio::alignment::distance::simd::bounded_levenshtein used
for product dedup (upstream sharkmer src/pcr/paths.rs:386-395): returns
the edit distance if it is <= bound, else None. Uses the Ukkonen band
of width 2*bound+1; rows are vectorised with numpy except the
insertion min-scan, which is a short sequential pass over the band.

Band bookkeeping: row i stores D(i, j) for j in [i-bound, i+bound] at
offset d = j - i + bound. Transitions into (i, j):
  substitution from D(i-1, j-1) -> prev offset d
  deletion     from D(i-1, j)   -> prev offset d+1
  insertion    from D(i,   j-1) -> current offset d-1 (the scan)
"""

from __future__ import annotations

import numpy as np


def bounded_levenshtein(a: bytes | str, b: bytes | str, bound: int) -> int | None:
    if isinstance(a, str):
        a = a.encode()
    if isinstance(b, str):
        b = b.encode()
    n, m = len(a), len(b)
    if abs(n - m) > bound:
        return None
    if n == 0:
        return m if m <= bound else None
    if m == 0:
        return n if n <= bound else None

    av = np.frombuffer(a, dtype=np.uint8)
    bv = np.frombuffer(b, dtype=np.uint8)

    BIG = np.int32(bound + 1)
    width = 2 * bound + 1
    prev = np.full(width, BIG, dtype=np.int32)
    for d in range(width):
        j = d - bound  # i=0 -> D(0, j) = j
        if 0 <= j <= m:
            prev[d] = j

    for i in range(1, n + 1):
        j_lo = max(0, i - bound)
        j_hi = min(m, i + bound)
        if j_lo > j_hi:
            return None
        js = np.arange(j_lo, j_hi + 1)
        ds = js - i + bound

        # substitution: prev[d] + mismatch(a[i-1], b[j-1]); j=0 -> base case i
        jm1 = np.maximum(js - 1, 0)
        mismatch = (av[i - 1] != bv[jm1]).astype(np.int32)
        sub = np.where(js > 0, np.minimum(prev[ds], BIG) + mismatch, np.int32(i))

        # deletion: prev[d+1] + 1
        dp1 = ds + 1
        dele = np.where(
            dp1 < width, np.minimum(prev[np.minimum(dp1, width - 1)], BIG) + 1, BIG
        )

        vals = np.minimum(np.minimum(sub, dele), BIG)
        # insertion: running scan over ascending j within the band
        for t in range(1, len(vals)):
            if vals[t - 1] + 1 < vals[t]:
                vals[t] = vals[t - 1] + 1

        if vals.min() > bound:
            return None
        cur = np.full(width, BIG, dtype=np.int32)
        cur[ds] = vals
        prev = cur

    d_final = m - n + bound
    if 0 <= d_final < width and prev[d_final] <= bound:
        return int(prev[d_final])
    return None
