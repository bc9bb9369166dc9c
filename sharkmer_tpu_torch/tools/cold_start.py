#!/usr/bin/env python3
"""Where a fresh process's seconds go, before and around its first result.

The counterpart of the repository's ``scripts/cold_start_diag.py``. Run
bare, it stamps the seconds since this process started (``/proc/self/
stat``) after each first-call stage of the count path, one line each:
the numpy import, the torch import, ``import sharkmer_tpu_torch.main``
(the CLI's modules), the CUDA context (the first tensor on the card,
synchronised), ``kernels/build.load`` of each kernel library one by one
(the mtime check and the ``ctypes`` load; an ``nvcc`` build where the
library is missing), ``io/native.available()``, the reads of
``tools/bench.make_reads_codes`` (``bench``'s flags: ``--reads``,
``--batch``, ``--quick`` ...), the first batch's upload, the first
ingest (``ingest_codes``' encode and ``insert_kmers`` on the uploaded
batch), the remaining ingests, the flush (the first drain) and the
histogram. Each stage ends in a synchronise of the device. The JAX
script's compile-cache log has no counterpart: it follows the TPU's
compile bill.

``--cli ARGS...`` runs the port's CLI (``sharkmer_tpu_torch.main.main``
on ``ARGS``, as ``python -m sharkmer_tpu_torch ARGS`` does) in a child
process under ``python -X importtime`` and splits the child's wall three
ways:

* before ``main()``: interpreter start and imports (the largest
  top-level import times beside it);
* inside ``main()``: the CLI's own total (``print_summary``'s figure),
  its stage walls (the ``stage walls:`` line) and the rest: from
  ``main()`` to that line less the stage walls (set-up before the
  ingest), and from that line to ``main()``'s return (stats and
  summary);
* after ``main()`` returns: the child's teardown, to its exit.

Each part is stamped on its own clock (the parent's and the child's
``time.monotonic``, which is the system's), so their sum against the
measured wall is a check of the split. Each run's last line is one JSON
object of every number. Runs on the card unless
``SHARKMER_TORCH_DEVICE=cpu``:

    python -m sharkmer_tpu_torch.tools.cold_start [--quick | --reads N]
    python -m sharkmer_tpu_torch.tools.cold_start --cli -s S -k 19 -o OUT reads.fastq.gz
"""

import json
import os
import re
import subprocess
import sys
import time

_T_MODULE = time.monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the kernel libraries the CLI can load (csrc/<name>.cu)
LIBRARIES = ("run_scan", "stitch_rows", "probe_rows", "reach_closure",
             "hash_table", "peer")
TOP_IMPORTS = 8

# The child of --cli: the CLI's main() between two stamps, and a stamp
# when it logs its stage walls; the stamps go to stderr as one line.
CHILD = """
import json, logging, sys, time
sys.path.insert(0, {root!r})
from sharkmer_tpu_torch.main import main
stamps = {{}}

class _StageWalls(logging.Filter):
    def filter(self, record):
        if "stage walls:" in record.getMessage():
            stamps["stage_walls_line"] = time.monotonic()
        return True

logging.getLogger("sharkmer").addFilter(_StageWalls())
stamps["main_enter"] = time.monotonic()
print({marker!r}, file=sys.stderr, flush=True)
rc = main()
stamps["main_exit"] = time.monotonic()
print({marker!r} + " " + json.dumps(stamps), file=sys.stderr, flush=True)
sys.exit(rc)
"""
MARKER = "cold_start: main()"


def process_start() -> float:
    """This process's start on ``time.monotonic``'s clock: its start
    time since boot from ``/proc/self/stat`` (clock ticks) against
    ``CLOCK_BOOTTIME`` now, or this module's import without ``/proc``."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        since = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return _T_MODULE
    # a clock that disagrees with this module's own import time
    now = time.monotonic()
    return now - since if 0 <= since <= now - _T_MODULE + 600 else _T_MODULE


class Stamps:
    """Seconds since process start, printed and kept after each stage."""

    def __init__(self):
        self.t0 = process_start()
        self.rows = []

    def __call__(self, label: str) -> None:
        now = time.monotonic() - self.t0
        self.rows.append([label, now])
        print(f"[{now:8.3f}s] {label}", flush=True)


def bare(argv) -> dict:
    """The first-call stages of the count path, stamped."""
    stamp = Stamps()
    stamp("interpreter start to this module")
    import numpy as np

    stamp("numpy imported")
    import torch

    stamp("torch imported")
    import sharkmer_tpu_torch.main  # noqa: F401  (the CLI's modules)

    stamp("sharkmer_tpu_torch.main imported")
    from ..device import default_device, synchronize
    from ..io import native
    from ..kernels import build
    from ..ops.encoding import canonical_kmers
    from ..ops.sorted_store import SortedKmerStore
    from . import bench

    parser = bench.build_parser()
    parser.description = __doc__
    args = parser.parse_args(argv)
    if args.quick:
        args.reads, args.batch, args.genome_mbp = 50_000, 1 << 14, 1.0
    device = default_device()
    torch.zeros(1, device=device)
    synchronize(device)
    stamp(f"device {device} ready"
          + (f" (CUDA context on {torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    if device.type == "cuda":
        for name in LIBRARIES:
            build.load(name)
            stamp(f"kernels/build.load({name!r})")
    else:
        stamp("kernel libraries not loaded (cpu: the plain versions)")
    stamp(f"io/native.available() = {native.available()}")

    stamp(f"generating {args.reads} reads (host)")
    codes_all = bench.make_reads_codes(
        args.reads, args.read_len, args.genome_mbp, panel=args.panel,
        error_rate=args.error_rate)
    stamp("reads generated")

    def ingest(store, codes):
        kmers, _ = canonical_kmers(codes, store.k)
        store.insert_kmers(kmers.reshape(-1))

    store = SortedKmerStore(args.k, device)
    first = torch.from_numpy(codes_all[: args.batch]).to(device)
    synchronize(device)
    stamp(f"first batch upload ({first.numel() / 1e6:.1f} MB)")
    ingest(store, first)
    synchronize(device)
    stamp("first ingest (encode + insert_kmers)")
    for lo in range(args.batch, args.reads, args.batch):
        ingest(store, torch.from_numpy(codes_all[lo : lo + args.batch])
               .to(device))
    synchronize(device)
    stamp("remaining ingests (upload, encode, insert)")
    store._flushed()
    synchronize(device)
    stamp("flush (the first drain)")
    total = int(np.sum(store.histogram(10_000)))
    stamp(f"histogram (n={total})")
    return {"stamps": stamp.rows, "histogram_total": total,
            "reads": args.reads, "device": str(device),
            "card": bench.card() if device.type == "cuda" else None}


def parse_duration(text: str) -> float:
    """Seconds of ``format.format_duration``'s '12.3s', '1m 23s', '1h 5m'."""
    seconds = 0.0
    for value, unit in re.findall(r"([\d.]+)([hms])", text):
        seconds += float(value) * {"h": 3600, "m": 60, "s": 1}[unit]
    return seconds


def split_cli(cli: list[str]) -> dict:
    """The CLI on ``cli`` in a child under ``-X importtime``, its wall
    split three ways (the module docstring); raises if it fails."""
    code = CHILD.format(root=ROOT, marker=MARKER)
    start = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-c", code, *cli],
        capture_output=True, text=True)
    end = time.monotonic()
    if proc.returncode != 0:
        raise RuntimeError(f"cold_start: the CLI exited {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    lines = proc.stderr.splitlines()
    enter = lines.index(MARKER)
    stamps = json.loads(next(line for line in lines
                             if line.startswith(MARKER + " "))
                        .split(" ", 2)[2])
    # -X importtime: "import time: self [us] | cumulative | package", a
    # nested import indented under its importer. The top-level entries'
    # cumulative times add up to the import time; the self times, summed
    # by root package, say which packages hold it
    imports_s, by_package = 0.0, {}
    for line in lines[:enter]:
        if not line.startswith("import time:") or "|" not in line:
            continue
        self_us, cumulative, name = line[len("import time:"):].split("|")
        if not self_us.strip().isdigit():
            continue  # the header line
        if not name.startswith("  "):
            imports_s += int(cumulative) / 1e6
        root = name.strip().split(".")[0]
        by_package[root] = by_package.get(root, 0.0) + int(self_us) / 1e6
    walls_line = next(line for line in lines if "stage walls:" in line)
    walls = {name: float(value) for name, value in re.findall(
        r"(ingest|consolidate|sPCR) ([\d.]+) s", walls_line)}
    summary = next(line for line in lines if "sharkmer complete:" in line)
    cli_total = parse_duration(summary.rsplit(", ", 1)[1])
    stage_s = sum(walls.values())
    wall = end - start
    before = stamps["main_enter"] - start
    after = end - stamps["main_exit"]
    record = {
        "wall_s": wall,
        "before_main_s": before,
        "imports_s": imports_s,
        "top_imports": sorted(by_package.items(),
                              key=lambda x: -x[1])[:TOP_IMPORTS],
        "inside_main_s": cli_total,
        "main_stamped_s": stamps["main_exit"] - stamps["main_enter"],
        "stage_walls_s": walls,
        "outside_stages_s": cli_total - stage_s,
        "setup_before_stages_s": (stamps["stage_walls_line"]
                                  - stamps["main_enter"] - stage_s),
        "after_stages_s": stamps["main_exit"] - stamps["stage_walls_line"],
        "after_main_s": after,
        "sum_s": before + cli_total + after,
    }
    print(f"CLI child wall {wall:.3f} s = before main() {before:.3f} s + "
          f"inside main() {cli_total:.1f} s (print_summary; stamped "
          f"{record['main_stamped_s']:.3f} s) + after main() {after:.3f} s "
          f"= {record['sum_s']:.3f} s", flush=True)
    print(f"  before main(): imports {imports_s:.3f} s (-X importtime), the "
          f"rest {before - imports_s:.3f} s (process spawn, interpreter "
          f"start); the largest packages' own import time:", flush=True)
    for name, seconds in record["top_imports"]:
        print(f"    {name}: {seconds:.3f} s", flush=True)
    print(f"  inside main(): stage walls {walls} = {stage_s:.3f} s; outside "
          f"them {record['outside_stages_s']:.3f} s: set-up before the "
          f"stages {record['setup_before_stages_s']:.3f} s, from the "
          f"stage-walls line to the return {record['after_stages_s']:.3f} s",
          flush=True)
    print(f"  after main(): teardown {after:.3f} s", flush=True)
    return record


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--cli"]:
        record = split_cli(argv[1:])
    else:
        record = bare(argv)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
