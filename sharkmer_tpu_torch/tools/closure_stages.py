"""Split a reach-closure level into its stages on the card, for the
design of ``csrc/reach_closure.cu``. Run from the root of a checkout:

    python3 -m sharkmer_tpu_torch.tools.closure_stages

It builds ``csrc/reach_closure_stages.cu`` (the program's kernel with
``SHK_STAGE_CLOCKS``, measurement only), which stamps ``clock()`` after
every stage of every level in its thread 0 (``csrc/stage_clock.cuh``):
frontier read, route, LUT, bucket rows (keys and counts), claim,
barriers. It runs ``chip_smoke.py``'s narrow and wide closure calls
(``closure_cases``: a 2^26-row table of every 19-mer of a random genome
plus filler, as one partition and as 21 key-range partitions; 2 roots
and 48 roots; depth 2048, f_cap 256): once untimed to bring the walk's
rows into L2, once warm, as the script times them, and once after a
write of 256 MB has pushed the table out of L2 (cold). Each result is
checked against the program's ``reach_closure``. Cycles become ns at
the SM clock that the kernel's own ``%globaltimer`` gives. The latencies
beside them: a dependent load through L2 and from DRAM, and a returning
L2 ``atomicOr`` (``csrc/chase.cu``).

It prints, per call, the mean ns per level of each stage for the narrow
levels (at most 128 candidates) and for the wide ones (with their rounds
of candidates, each round's mean ns by its index), and ends with a line
``RESULT <JSON>``.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

STAGES = ("frontier", "route", "lut", "rows", "claim", "barriers")
NARROW_SPLIT, WIDE_SPLIT, ROUND_BASE, MAX_ROUNDS = 0, 10, 20, 64
TOTAL_CYCLES = ROUND_BASE + MAX_ROUNDS
CLOCK_WORDS = TOTAL_CYCLES + 2


def _lib():
    from sharkmer_tpu_torch.kernels import build

    build.build_all(["reach_closure_stages", "chase"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = build.load("reach_closure_stages")
    lib.shk_reach_closure_clocked.argtypes = [
        p, i, i, p, i, p, i, ctypes.c_int64, i, i, i, i, p, p, p, p, p, p, i,
        p, p]
    lib.shk_reach_closure_clocked.restype = i
    return lib


def split(clocks, ns_per_cycle: float) -> dict:
    """Mean ns per level of each stage, narrow and wide, and the wide
    levels' rounds."""
    out = {}
    for name, base in (("narrow", NARROW_SPLIT), ("wide", WIDE_SPLIT)):
        n = len(STAGES)
        levels = clocks[base + n]
        if not levels:
            continue
        per = {s: clocks[base + j] * ns_per_cycle / levels
               for j, s in enumerate(STAGES)}
        per["level"] = clocks[base + n + 1] * ns_per_cycle / levels
        per["levels"] = levels
        per["rounds"] = clocks[base + n + 2] / levels
        out[name] = per
    if "wide" in out:
        n = out["wide"]["levels"]
        out["wide"]["round_ns"] = [
            clocks[ROUND_BASE + r] * ns_per_cycle / n
            for r in range(MAX_ROUNDS) if clocks[ROUND_BASE + r]]
    return out


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from sharkmer_tpu_torch.kernels import closure
    from sharkmer_tpu_torch.ops import reach
    from sharkmer_tpu_torch.ops.keys import keys_to_device

    if not torch.cuda.is_available():
        raise SystemExit("closure_stages: torch sees no CUDA device")
    card = cs.card_line()
    lib = _lib()
    print(f"card: {card}", flush=True)
    latency = cs.load_latency(torch)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"dependent-load latency: {latency['l2_ns']:.1f} ns L2, "
          f"{latency['dram_ns']:.1f} ns DRAM", flush=True)
    # a returning atomicOr's latency, along a 4 MB ring that hits L2
    out1 = torch.empty(1, dtype=torch.int32, device="cuda")
    n_lines, steps = 1 << 15, 1 << 14
    ring = 32 * torch.randperm(n_lines, device="cuda")
    nxt = torch.zeros(32 * n_lines, dtype=torch.int32, device="cuda")
    nxt[ring] = torch.roll(ring, -1).to(torch.int32)

    chase = cs.chase_lib()
    chase.shk_atomic_chase.argtypes = chase.shk_chase.argtypes
    chase.shk_atomic_chase.restype = ctypes.c_int

    def walk(n):
        rc = chase.shk_atomic_chase(nxt.data_ptr(), int(ring[0]), n,
                                    out1.data_ptr(), stream)
        cs.require(rc == 0, f"atomic chase: launch failed ({rc})")

    walk(n_lines)
    latency["atomic_ns"] = cs.median_ms(torch, lambda: walk(steps),
                                        3) * 1e6 / steps
    print(f"returning L2 atomicOr: {latency['atomic_ns']:.1f} ns",
          flush=True)
    del ring, nxt
    keys, counts, n_real, fwd = cs.closure_table(np, torch, cs.PART_ROWS,
                                                 cs.K)
    layouts = cs.key_range_layouts(torch)
    cases = cs.closure_cases(np, fwd)
    flush = torch.empty(1 << 25, dtype=torch.int64, device="cuda")
    record = {"card": card, "latency_ns": latency}

    def c0_of(roots):
        c0 = np.full(8 * reach.F_CAP, reach.EMPTY, np.uint64)
        roots = np.unique(np.asarray(roots, np.uint64))
        c0[: len(roots)] = roots
        return keys_to_device(c0, "cuda")

    def run(table, c0, shape, cold):
        out = closure.closure_scratch(table.n_rows, shape[0], shape[1],
                                      "cuda", c0.shape[0])
        clocks = torch.zeros(CLOCK_WORDS, dtype=torch.int64, device="cuda")
        if cold:
            flush.fill_(1)
        torch.cuda.synchronize()
        d = table.desc
        rc = lib.shk_reach_closure_clocked(
            d.data_ptr(), d.shape[0], table.n_shards, c0.data_ptr(),
            c0.shape[0], None, 0, cs.CLOSURE_MC, cs.K, *shape,
            out["bitmap"].data_ptr(), out["front"].data_ptr(),
            out["log"].data_ptr(), out["boundary"].data_ptr(),
            out["state"].data_ptr(), out["spill"].data_ptr(),
            out["spill"].shape[0] // 3, clocks.data_ptr(), stream)
        cs.require(rc == 0, f"closure_stages: launch failed ({rc})")
        torch.cuda.synchronize()
        return closure.unpack_state(out["state"]), clocks.tolist()

    for layout, build in layouts.items():
        table = build(keys, counts, n_real)
        for call in ("narrow", "wide"):
            roots, shape = cases[call]
            c0 = c0_of(roots)
            want = closure.unpack_state(closure.reach_closure(
                table, c0, None, cs.CLOSURE_MC, cs.K, *shape)[2])
            run(table, c0, shape, False)  # the rows into L2
            key = f"{layout}, {call}"
            record[key] = {}
            for temp in ("warm", "cold"):
                state, clocks = run(table, c0, shape, temp == "cold")
                cs.require(state == want, f"{key}: state {state} vs "
                           f"reach_closure {want}")
                ns_per_cycle = clocks[TOTAL_CYCLES + 1] / clocks[TOTAL_CYCLES]
                res = {"kernel_ns": clocks[TOTAL_CYCLES + 1],
                       "sm_ghz": 1 / ns_per_cycle,
                       **split(clocks, ns_per_cycle)}
                record[key][temp] = res
                print(f"{key}, {temp}: {json.dumps(res)}", flush=True)
        del table
        torch.cuda.empty_cache()
    print(f"card: {card}")
    print("RESULT " + json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
