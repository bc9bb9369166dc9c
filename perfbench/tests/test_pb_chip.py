"""The harness on the card at a small size: each count traffic traced,
its kernels' roofline share read and within 100%, and the control
failing there as on the CPU."""

import io
import json
import time

import pytest

from perfbench import harness
from perfbench.control import control


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["count.sorted.8M", "count.hash.8M",
                                      "chunks10.sorted.8M"])
def test_traced_count_on_the_card(root, small, card, workload):
    out = io.StringIO()
    rc = harness.run_cell(root, workload, 2**31 + 17, 0.5, True, card,
                          time.monotonic(), overrides=small, out=out)
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and result["correct"]
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    share = result["metrics"]["kernel_roofline.count"]["value"]
    assert 0 < share <= 100


@pytest.mark.chip
def test_control_on_the_card(root, card):
    size = {"genome_bp": 500_000, "n_reads": 100_000, "batch_reads": 16384,
            "amplicon_copies": 20}
    assert control(root, "count.hash.8M", 5, card, size)["keys_wrong"] > 0
