"""The import check, and what a whole run loads and reads: no module
whose top-level name is JAX's or the JAX package's (``sharkmer_tpu_torch``
begins with ``sharkmer_tpu`` and is the port), and no file under the
JAX package's ``benchmarks/``."""

import json
import os
import subprocess
import sys

import pytest

from perfbench import harness


@pytest.mark.parametrize("names, found", [
    (["jax"], ["jax"]),
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["sharkmer_tpu"], ["sharkmer_tpu"]),
    (["sharkmer_tpu.ops.reach", "sharkmer_tpu_torch"], ["sharkmer_tpu"]),
    (["sharkmer_tpu_torch", "sharkmer_tpu_torch.ops.reach"], []),
    (["jaxtyping", "flaxen", "sharkmer_tpu_tools", "torch"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert harness.forbidden_modules(names) == found


RUN = """
import json, os, sys, time
opened = []
sys.addaudithook(lambda event, args: event == "open" and isinstance(
    args[0], (str, bytes)) and opened.append(os.fsdecode(args[0])))
from perfbench import harness
small = json.loads(sys.argv[2])
rc = harness.run_cell(sys.argv[1], "sample.sorted.8M", 2**31 + 11, 0.01,
                      True, "cpu", time.monotonic(), overrides=small)
bench = os.path.join(sys.argv[1], "benchmarks") + os.sep
print(json.dumps({"rc": rc, "modules": sorted(sys.modules),
                  "benchmarks": [p for p in opened
                                 if os.path.abspath(p).startswith(bench)]}))
"""


def test_a_run_loads_no_jax_and_reads_no_benchmarks(root, small):
    """A traced sample run, the traffic that loads the most of the port,
    in a process of its own."""
    proc = subprocess.run([sys.executable, "-c", RUN, root, json.dumps(small)],
                          cwd=root, capture_output=True, text=True,
                          timeout=900, env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0
    assert "sharkmer_tpu_torch" in {m.split(".")[0] for m in out["modules"]}
    assert harness.forbidden_modules(out["modules"]) == []
    assert out["benchmarks"] == []
