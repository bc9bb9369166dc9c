#!/usr/bin/env python3
"""Run one cell of the benchmark of ``sharkmer_tpu_torch`` once.

    python3 perfbench/run.py --workload count.sorted.8M --seed 7 \\
        --seconds 20 --trace 0

from the root of a checkout that holds the port. The last line of
standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; ``checks``, each
number compared beside its limit, comes last. Notes, and the same checks
as the last lines, go to standard error.

It exits non-zero and prints no result when torch sees no CUDA card or
fewer than the cell asks for, when the port cannot be imported from the
checkout, or when the process has loaded JAX or the JAX package.
Kernel and compiler caches stay under the checkout's ``build/``.
"""

import time

_STARTED = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _age() -> float:
    """Seconds the process had run when this module started: its start
    time from /proc (clock ticks since boot) against the uptime."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def _environment() -> None:
    """Caches inside the checkout at fixed paths; the port's own tuning
    variables cleared, so that it runs as the configuration states."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    for name in list(os.environ):
        if name.startswith("SHARKMER_"):
            del os.environ[name]


def main(argv=None) -> int:
    started = _STARTED - _age()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = parser.parse_args(argv)
    _environment()
    # the checkout's root, in place of this script's own directory
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]

    from perfbench import harness, spec

    cell = spec.cell(spec.load(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: torch sees no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: the cell needs {cell['chips']} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import sharkmer_tpu_torch
    except ImportError as e:
        print(f"perfbench: the port does not import: {e}", file=sys.stderr)
        return 2
    where = os.path.dirname(os.path.abspath(sharkmer_tpu_torch.__file__))
    if os.path.dirname(where) != ROOT:
        print(f"perfbench: the port was imported from {where}, not from the "
              f"checkout {ROOT}", file=sys.stderr)
        return 2

    out, sys.stdout = sys.stdout, sys.stderr  # the program's prints
    try:
        return harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0),
                                started, out=out)
    finally:
        sys.stdout = out


if __name__ == "__main__":
    sys.exit(main())
