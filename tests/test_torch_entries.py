"""Both CLIs, in process, through the record-stream entries and the
several-file loop: identical output files.

The entries: FASTQ on stdin, ``--paired R1 R2`` (records taken R1, R2,
R1, ... through ``read_fastq_paired``), and several FASTQ files (the
native loader, one reader a file, ``-m`` counted across the files). The
JAX package's CLI runs on the CPU, the port's under
``SHARKMER_TORCH_DEVICE=cpu``. ``.histo``, ``.final.histo`` and the
FASTA files must be byte-identical, and ``stats.yaml`` equal apart from
``command`` and ``peak_memory_bytes``.
"""

import sys

import pytest
import torch

from sharkmer_tpu.main import main as jax_main
from sharkmer_tpu_torch.main import main as torch_main

from data_18s import READ_STRING
from test_cli_e2e import PRIMER_SPEC, tiling_reads
from test_torch_cli import _assert_same_outputs
from util import write_fastq

N_READS = 2200  # three turns of 1000 reads: three chunks of --chunks 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU closure runs many small torch ops a level: on one
    intra-op thread they take a fraction of the time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """One read set (the 18S fixture's 120-base tiles, over and over)
    written as one plain FASTQ (for stdin), as its two
    gzip halves, and as R1 / R2 gzip files holding the reads at even and
    odd positions, so that the pairs come back in the set's order."""
    tiles = tiling_reads(READ_STRING) + [READ_STRING[-120:]]
    reads = [tiles[i % len(tiles)] for i in range(N_READS)]
    d = tmp_path_factory.mktemp("entries")
    paths = {"all": d / "all.fastq", "a": d / "a.fastq.gz",
             "b": d / "b.fastq.gz", "r1": d / "r1.fastq.gz",
             "r2": d / "r2.fastq.gz"}
    half = N_READS // 2
    for name, part in (("all", reads), ("a", reads[:half]),
                       ("b", reads[half:]), ("r1", reads[0::2]),
                       ("r2", reads[1::2])):
        write_fastq(paths[name], part, gzipped=name != "all")
    return {name: str(p) for name, p in paths.items()}


class _Stdin:
    """``sys.stdin`` as the CLIs read it: its binary ``buffer``, not a
    terminal."""

    def __init__(self, path):
        self.buffer = open(path, "rb")

    def isatty(self):
        return False


CASES = {
    "stdin": (True, ()),
    "stdin_m": (True, ("-m", "1700")),
    "paired": (False, ("--paired", "{r1}", "{r2}")),
    "two_files": (False, ("{a}", "{b}")),
    "two_files_m": (False, ("-m", "1500", "{a}", "{b}")),  # ends in b
    "paired_odd_m": (False, ("-m", "1501", "--paired", "{r1}", "{r2}")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_entries_outputs_identical(tmp_path, monkeypatch, inputs, case):
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    stdin, extra = CASES[case]
    extra = [arg.format(**inputs) for arg in extra]
    outs = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / name
        if stdin:
            monkeypatch.setattr(sys, "stdin", _Stdin(inputs["all"]))
        rc = main(["-s", "samp", "-k", "21", "--chunks", "3", "-o", str(out),
                   "--pcr-primers", PRIMER_SPEC, *extra])
        if stdin:
            sys.stdin.buffer.close()
        assert rc == 0, name
        outs[name] = out
    _assert_same_outputs(outs["jax"], outs["torch"], expect_histo=True)
    # the run read what the case asks for
    stats = (outs["torch"] / "samp.stats.yaml").read_text()
    want = {"stdin_m": 1700, "two_files_m": 1500,
            "paired_odd_m": 1502}.get(case, N_READS)
    assert f"n_reads_read: {want}\n" in stats, stats
