"""Run ``chip_smoke.py``'s phase 18 alone on one placement of the shards:
the windowed ``hash_insert``, the pointer-table ``hash_lookup`` and the
closures over owner shards placed on a device list, each against its
plain version, then the 1M cnidaria cell with ``--n-shards 4`` (sorted,
and hash with ``--mirror device``) under ``SHARKMER_TORCH_DEVICES``,
byte-identical to the committed oracle. Run from the root of a
checkout:

    python3 -m sharkmer_tpu_torch.tools.groups_phase [DEVICES]

DEVICES is a comma list (default: the first four visible cards, or
``cuda:0`` four times on a machine with one). On distinct cards it first
measures the dependent-load latency from the first card into each other
card's memory. It makes the synthetic FASTQ when it is missing (as
``chip_smoke.py`` does). The last line is ``RESULT <devices> <card>
<JSON of every *ms and *ns field>``.
"""

from __future__ import annotations

import json
import os
import sys


def main(argv=None) -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from sharkmer_tpu_torch.kernels import build, closure, probe, run_scan
    from sharkmer_tpu_torch.kernels import hash as hk
    from sharkmer_tpu_torch.kernels import stitch
    from sharkmer_tpu_torch.tools.synth import synthesize_panel_fastq

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("groups_phase: torch sees no CUDA device")
    n_cards = torch.cuda.device_count()
    devices = (argv[0].split(",") if argv else
               [f"cuda:{i}" for i in range(min(4, n_cards))] if n_cards > 1
               else ["cuda:0"] * 4)
    build.build_all(sorted({os.path.basename(src)[:-3]
                            for src, _ in cs.KERNELS.values()}
                           | {"chase", "peer"}))
    if not os.path.exists(cs.FASTQ):
        synthesize_panel_fastq(cs.PANEL, cs.FASTQ, n_reads=cs.N_READS_MAX,
                               seed=0)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    os.environ["SHARKMER_TORCH_DEVICE"] = "cuda"
    card = cs.card_line()
    print(f"card: {card}; {n_cards} card(s) visible; devices {devices}",
          flush=True)
    latency = cs.load_latency(torch)
    record = {"latency_ns": latency}
    distinct = list(dict.fromkeys(devices))
    if len(distinct) > 1:
        record["peer_dram_ns"] = cs.peer_latencies(torch, distinct, card,
                                                   latency)
    kernels = {"run_ends": run_scan.run_ends,
               "run_starts": run_scan.run_starts,
               "probe_rows": probe.probe_rows,
               "stitch_rows": stitch.stitch_rows,
               "reach_closure": closure.reach_closure,
               "hash_insert": hk.hash_insert, "hash_lookup": hk.hash_lookup}
    ctx = cs.instrument(torch, kernels)
    runs = {}
    cs.placement_phase(ctx, np, card, latency, "placement", devices, record,
                       runs, load=False)
    cs.check_group_runs(runs, "placement", len(devices))
    kept = {name: rec if name == "peer_dram_ns" else
            {k: v for k, v in rec.items() if k.endswith(("ms", "ns"))}
            for name, rec in record.items()}
    print("RESULT", ",".join(devices), card, json.dumps(kept), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
