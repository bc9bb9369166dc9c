"""The benchmark of the PyTorch and CUDA port, ``sharkmer_tpu_torch``.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.
"""

import sys


def note(msg: str) -> None:
    """A line of the run's notes, on standard error."""
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
