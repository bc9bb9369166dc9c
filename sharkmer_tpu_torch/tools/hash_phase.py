"""Run ``chip_smoke.py``'s phase 8 alone: the hash kernels against their
plain versions on one real ingest batch, timed, on the GPU.

Run from the root of a checkout that holds the synthetic FASTQ
(``chip_smoke.py`` makes it; its first 2^17 reads are the batch):

    python3 -m sharkmer_tpu_torch.tools.hash_phase

It imports ``chip_smoke.py`` and the package from the current directory,
so two trees (two commits) are compared in one call by running this
file from each in turns: ``(cd <tree> && python3 <path of this file>)``.
The last line is ``RESULT <tree> <card> <JSON of every *ms field>``.
"""

from __future__ import annotations

import json
import os
import sys


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from sharkmer_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("hash_phase: torch sees no CUDA device")
    build.build_all(["hash_table", "chase"])
    card = cs.card_line()
    record = cs.hash_phase(torch, np, card, cs.load_latency(torch))
    print("RESULT", os.getcwd(), card, json.dumps(
        {name: {k: v for k, v in r.items() if k.endswith("ms")}
         for name, r in record.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
