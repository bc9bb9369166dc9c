"""Build ``chip_smoke.py``'s closure table the way phases 13 and 18 do,
and find where the two builds, or the structures made from them, differ.

Run from the root of a checkout, on the GPU:

    python3 closure_table_check.py

It imports ``chip_smoke.py`` and the package from the current directory,
so a tree without this file (an older commit) is checked by running it
from there: ``(cd <tree> && python3 <path of this file>)``. Steps:

1. ``closure_table`` twice on the card (phase 13's build, phase 18's
   build), then EXTRA_BUILDS times more: the rows whose key or count
   differ from the first build's, and whether the genome holds each
   one's k-mer more than once (a repeated row of ``closure_table``'s
   count assignment);
2. the two builds cut by ``shard_table`` into the owner shards, phase 13's
   in one allocation a shard on the card, phase 18's on
   ``cuda:0`` x4 (shard groups in separate allocations): every sidecar
   tensor and field compared shard by shard;
3. phase 13's closure calls (``closure_cases``), each through
   ``closure_plain`` and ``reach_closure``, and ``probe_rows`` with its
   plain version on 4096 genome keys, on each table; then every tensor
   of both tables (sidecars, LUT copies, descriptors, the plain lookup's
   cached flat copies) against a copy taken before the calls, and the two
   tables against each other again.

The last line is ``RESULT <tree> <JSON>``.
"""

from __future__ import annotations

import json
import os
import sys

EXTRA_BUILDS = 6


def table_tensors(torch, table) -> dict:
    """Every tensor of a ``PartTable`` and its sidecars, by name."""
    out = {}
    for i, sc in enumerate(table.sidecars):
        for name in ("keys1d", "counts1d", "lut"):
            out[f"shard {i} {name}"] = getattr(sc, name)
        for name in ("bits", "shift", "probe_blocks", "first_key"):
            out[f"shard {i} {name}"] = torch.tensor(getattr(sc, name))
    for i, lut in enumerate(table.luts):
        out[f"descriptor LUT {i}"] = lut
    # the descriptors' words but the pointers (words 0-2)
    out["descriptors"] = table.desc[:, 3:]
    for device, blocks in table.plain_blocks.items():
        for j, t in enumerate(blocks):
            if isinstance(t, torch.Tensor):
                out[f"plain_blocks {device} {j}"] = t
    return out


def differ(torch, a: dict, b: dict) -> list[str]:
    """The names whose tensors differ (or that only one side has)."""
    names = sorted(set(a) | set(b))
    return [n for n in names if n not in a or n not in b
            or a[n].shape != b[n].shape
            or not torch.equal(a[n].cpu(), b[n].cpu())]


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from sharkmer_tpu_torch.kernels import build, closure, probe
    from sharkmer_tpu_torch.ops import reach
    from sharkmer_tpu_torch.ops.histogram import revcomp

    if not torch.cuda.is_available():
        raise SystemExit("closure_table_check: torch sees no CUDA device")
    build.build_all(["probe_rows", "reach_closure"])
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    result = {}

    # 1. two builds
    a_keys, a_counts, n_real, fwd = cs.closure_table(np, torch, cs.PART_ROWS,
                                                     cs.K)
    b_keys, b_counts, b_real, _ = cs.closure_table(np, torch, cs.PART_ROWS,
                                                   cs.K)
    # more builds: which repeated row's value lands may vary from build
    # to build, or not in every pair of builds
    more = [cs.closure_table(np, torch, cs.PART_ROWS, cs.K)[:2]
            for _ in range(EXTRA_BUILDS)]
    more_rows = sorted({r for keys, counts in more for r in torch.nonzero(
        (keys != a_keys) | (counts != a_counts)).reshape(-1).tolist()})
    del more
    g = torch.from_numpy(fwd)
    canonical = torch.minimum(g, revcomp(g, cs.K)).numpy()
    once, seen = np.unique(canonical, return_counts=True)
    repeated = torch.from_numpy(once[seen > 1]).cuda()
    repeated_rows = torch.searchsorted(a_keys[:n_real], repeated)
    rows = torch.nonzero((a_keys != b_keys) | (a_counts != b_counts))
    rows = rows.reshape(-1)
    is_repeated = torch.isin(rows, repeated_rows)
    result.update(
        n_real=[n_real, b_real], keys_equal=bool(torch.equal(a_keys, b_keys)),
        counts_equal=bool(torch.equal(a_counts, b_counts)),
        repeated_kmers=int(repeated.numel()),
        repeated_rows=repeated_rows.tolist(),
        occurrences=seen[seen > 1].tolist(),
        differing_rows=rows.tolist(),
        rows_differing_in_more_builds=more_rows,
        differing_counts=[[int(a_counts[r]), int(b_counts[r])]
                          for r in rows.tolist()],
        every_difference_a_repeated_row=bool(
            is_repeated.all() and torch.isin(
                torch.tensor(more_rows, dtype=torch.int64,
                             device=repeated_rows.device),
                repeated_rows).all()))
    print(f"1. two builds: keys equal {result['keys_equal']}, counts equal "
          f"{result['counts_equal']}; rows that differ "
          f"{result['differing_rows']} (counts {result['differing_counts']}),"
          f" in {EXTRA_BUILDS} more builds from the first {more_rows};"
          f" the genome's repeated k-mers sit on rows "
          f"{result['repeated_rows']} ({result['occurrences']} occurrences);"
          f" every difference on a repeated row: "
          f"{result['every_difference_a_repeated_row']}", flush=True)

    # 2. the owner shards: phase 13's layout and phase 18's
    a = cs.shard_table(torch, a_keys, a_counts, n_real, cs.CLOSURE_SHARDS,
                       cs.K)
    b = cs.shard_table(torch, b_keys, b_counts, b_real, cs.CLOSURE_SHARDS,
                       cs.K, cs.ONE_CARD_GROUPS)
    a_before = {n: t.clone() for n, t in table_tensors(torch, a).items()}
    b_before = {n: t.clone() for n, t in table_tensors(torch, b).items()}
    result["sidecars_differ"] = differ(torch, a_before, b_before)
    print(f"2. shards, phase 13's layout against phase 18's: differ in "
          f"{result['sidecars_differ']}", flush=True)

    # 3. phase 13's calls on each table, then every tensor again
    cases = cs.closure_cases(np, fwd)
    pick = np.random.default_rng(9).choice(fwd.shape[0], reach.PRE_W,
                                           replace=False)
    cand = torch.from_numpy(fwd[np.sort(pick)]).cuda()
    cand = torch.minimum(cand, revcomp(cand, cs.K))
    states = {}
    for name, table in (("phase 13", a), ("phase 18", b)):
        for call, (roots, shape) in cases.items():
            c0 = cs.closure_roots(np, roots)
            want = closure.closure_plain(table, c0, None, cs.CLOSURE_MC, cs.K,
                                         *shape)
            got = closure.reach_closure(table, c0, None, cs.CLOSURE_MC, cs.K,
                                        *shape)
            states[f"{name} {call}"] = [closure.unpack_state(want[2]),
                                        closure.unpack_state(got[2])]
        ids = probe.probe_rows(table, cand, cs.CLOSURE_MC)
        plain_ids = probe.probe_rows_plain(table, cand, cs.CLOSURE_MC)
        states[f"{name} probe_rows equal"] = bool(torch.equal(ids, plain_ids))
    torch.cuda.synchronize()
    a_after = table_tensors(torch, a)
    b_after = table_tensors(torch, b)
    # the cached flat copies against copies made anew from the sidecars
    stale = []
    for name, table in (("phase 13", a), ("phase 18", b)):
        for device, cached in list(table.plain_blocks.items()):
            del table.plain_blocks[device]
            anew = closure.stack_parts(table, device)
            stale += [f"{name} {device} {j}"
                      for j, (x, y) in enumerate(zip(cached, anew))
                      if isinstance(x, torch.Tensor)
                      and not torch.equal(x, y)]
    result["plain_blocks_stale"] = stale
    result.update(
        states=states,
        phase13_changed_by_calls=differ(
            torch, {n: t for n, t in a_before.items()},
            {n: t for n, t in a_after.items() if n in a_before}),
        phase18_changed_by_calls=differ(
            torch, {n: t for n, t in b_before.items()},
            {n: t for n, t in b_after.items() if n in b_before}),
        plain_blocks_differ=differ(
            torch, {n: t for n, t in a_after.items()
                    if n.startswith("plain_blocks")},
            {n: t for n, t in b_after.items()
             if n.startswith("plain_blocks")}),
        sidecars_differ_after_calls=differ(
            torch, {n: t for n, t in a_after.items()
                    if not n.startswith("plain_blocks")},
            {n: t for n, t in b_after.items()
             if not n.startswith("plain_blocks")}))
    print(f"3. after phase 13's calls: [plain state, kernel state] "
          f"{states}; changed by the calls: phase 13's table "
          f"{result['phase13_changed_by_calls']}, phase 18's "
          f"{result['phase18_changed_by_calls']}; the two tables now differ "
          f"in {result['sidecars_differ_after_calls']}, their plain lookup "
          f"copies in {result['plain_blocks_differ']}; cached copies unlike "
          f"copies made anew: {stale}", flush=True)
    print("RESULT", os.getcwd(), json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
