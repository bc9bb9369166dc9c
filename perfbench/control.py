#!/usr/bin/env python3
"""The control of the benchmark's comparison: the plain reference put in
the program's place, with one guarantee of the configuration broken.

The configurations state exact counts. The control keeps each count in
an 8-bit field that saturates at 255, the narrower count a store might
be tempted to keep; its table and spectra are judged exactly as a run's
are (``reference/count.compare``) and must come out wrong. It prints one
JSON line a seed with the numbers compared:

    python3 perfbench/control.py --workload count.sorted.8M \\
        --seeds 11,12,13

The benchmark's own runs do not run it; ``perfbench/tests`` holds it at
a small size.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNT_CAP = 255  # an unsigned 8-bit count field


def control(root, workload, seed, device, overrides=None,
            cap: int = COUNT_CAP) -> dict:
    from perfbench import gen, spec
    from perfbench.reference import count as ref_count
    from perfbench.units import HISTO_MAX

    bench = spec.load(root)
    cell = spec.cell(bench, workload)
    cfg = spec.config(root, bench, cell["config"])
    cfg.update(overrides or {})
    traffic = spec.traffic(cell["traffic"])
    sample = gen.make_sample(cfg, seed, device)
    args = (sample.codes, sample.batch_reads, sample.k, traffic["n_chunks"],
            HISTO_MAX, device)
    keys, counts, spectra = ref_count.table(*args, count_cap=cap)
    found = ref_count.compare(*args, keys, counts, [spectra or None])
    found.pop("bins_by_unit")
    if traffic["n_chunks"] == 0:
        found.pop("spectra_bins_wrong")
    return {"workload": workload, "seed": seed, "count_cap": cap, **found}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True,
                        help="comma-separated seeds")
    args = parser.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    import torch

    if not torch.cuda.is_available():
        print("control: torch sees no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = control(ROOT, args.workload, seed, torch.device("cuda", 0))
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
