"""``--read-threading`` and ``--validate-every`` through both CLIs, in
process: identical outputs and log counts.

``--read-threading`` reads the input again after counting (Pass 2,
``main._reread_sequences``) and threads the reads through each gene's
graph (``pcr/read_filter.py``, ``pcr/threading.py``, ``pcr/bubble.py``):
one FASTQ, ``--paired R1 R2`` (mates assigned), and stdin, where Pass 2
is unavailable. ``--validate-every N`` checks every N-th record: on good
input the outputs are those of the JAX CLI; on a malformed record both
CLIs validate the same records, so they exit alike, with the same
error, or write the same files. The JAX CLI runs on the CPU, the port's
under ``SHARKMER_TORCH_DEVICE=cpu``.
"""

import logging
import os
import re
import sys

import pytest
import yaml

from sharkmer_tpu.main import main as jax_main
from sharkmer_tpu_torch.main import main as torch_main

from data_18s import READ_STRING
from test_cli_e2e import PRIMER_SPEC, _rc, tiling_reads
from test_torch_entries import _Stdin, _one_torch_thread  # noqa: F401
from util import write_fastq

VARYING = ("command", "peak_memory_bytes")
# the log lines whose counts must agree: Pass 2's reads, each gene's
# threaded reads, its edges with read support, stdin's fallback
COUNTED = ("Pass 2: collected", "Read threading:", "Threading:",
           "Read threading unavailable")
BAD_RECORD = 6  # the malformed record's index (0-based)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The 18S reads (``test_cli_e2e``'s fixture) as one FASTQ and as R1 /
    R2 (``test_paired_with_read_threading``'s split: even reads forward,
    odd reads reverse-complemented); the same FASTQ with record
    BAD_RECORD's quality line one base short."""
    d = tmp_path_factory.mktemp("options")
    reads = tiling_reads(READ_STRING) + [READ_STRING] * 5
    r1, r2 = reads[0::2], [_rc(r) for r in reads[1::2]]
    n = min(len(r1), len(r2))
    paths = {name: d / f"{name}.fastq" for name in ("all", "r1", "r2", "bad")}
    write_fastq(paths["all"], reads)
    write_fastq(paths["r1"], r1[:n])
    write_fastq(paths["r2"], r2[:n])
    lines = paths["all"].read_bytes().split(b"\n")
    lines[4 * BAD_RECORD + 3] = lines[4 * BAD_RECORD + 3][:-1]
    paths["bad"].write_bytes(b"\n".join(lines))
    return {name: str(p) for name, p in paths.items()}


def _run_both(tmp_path, monkeypatch, caplog, args, stdin=None) -> dict:
    """Both CLIs on ``args`` (``{out}`` is each one's output directory):
    {name: (exit code, output directory, INFO and higher messages)}."""
    runs = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / name
        if stdin:
            monkeypatch.setattr(sys, "stdin", _Stdin(stdin))
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="sharkmer"):
            rc = main([a.format(out=out) for a in args])
        if stdin:
            sys.stdin.buffer.close()
        runs[name] = (rc, out, [r.getMessage() for r in caplog.records])
    return runs


def _assert_same_outputs(runs) -> None:
    """Same exit code and files; FASTA and histograms byte-identical,
    ``stats.yaml`` equal but for VARYING."""
    (rc_j, jax_out, _), (rc_t, torch_out, _) = runs["jax"], runs["torch"]
    assert rc_j == rc_t
    names = sorted(os.listdir(jax_out)) if jax_out.exists() else []
    assert names == (sorted(os.listdir(torch_out))
                     if torch_out.exists() else [])
    for name in names:
        a, b = (jax_out / name).read_bytes(), (torch_out / name).read_bytes()
        if name.endswith(".stats.yaml"):
            a, b = yaml.safe_load(a), yaml.safe_load(b)
            for key in VARYING:
                a.pop(key), b.pop(key)
        assert a == b, name


def _counted(messages) -> list:
    """The COUNTED lines without their walls, sorted (the gene threads
    log in any order)."""
    return sorted(re.sub(r" Time: [0-9.]+s", "", m) for m in messages
                  if any(c in m for c in COUNTED))


THREADING_CASES = {
    "single": (None, ("{all}",)),
    "paired": (None, ("{r1}", "{r2}", "--paired")),
    "stdin": ("all", ()),
}


@pytest.mark.parametrize("case", list(THREADING_CASES))
def test_read_threading_matches_jax(tmp_path, monkeypatch, caplog, inputs,
                                    case):
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    stdin, files = THREADING_CASES[case]
    runs = _run_both(
        tmp_path, monkeypatch, caplog,
        [*(f.format(**inputs) for f in files), "-s", "t", "-k", "21",
         "-o", "{out}", "-v", "--read-threading", "--pcr-primers",
         PRIMER_SPEC],
        stdin=inputs[stdin] if stdin else None)
    _assert_same_outputs(runs)
    assert runs["torch"][0] == 0
    jax_lines, torch_lines = (_counted(runs[n][2]) for n in ("jax", "torch"))
    assert torch_lines == jax_lines
    if case == "stdin":
        assert any("unavailable (stdin input)" in m for m in torch_lines)
        assert not any(m.startswith("Pass 2: collected") for m in torch_lines)
    else:
        collected = [m for m in torch_lines
                     if m.startswith("Pass 2: collected")]
        assert collected and " 0 reads" not in collected[0]
        assert any("Read threading:" in m for m in torch_lines)


def test_validate_every_good_input_matches_jax(tmp_path, monkeypatch,
                                               caplog, inputs):
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    runs = _run_both(tmp_path, monkeypatch, caplog, [
        inputs["all"], "-s", "v", "-k", "21", "-o", "{out}",
        "--validate-every", "1", "--chunks", "2", "--pcr-primers",
        PRIMER_SPEC])
    _assert_same_outputs(runs)
    assert runs["torch"][0] == 0
    assert (runs["torch"][1] / "v_18s.fasta").exists()


@pytest.mark.parametrize("every,stdin", [
    ("1", False), ("3", False), ("4", False), ("1", True), ("4", True)])
def test_validate_every_malformed_record_matches_jax(
        tmp_path, monkeypatch, caplog, inputs, every, stdin):
    """Record BAD_RECORD (6) has a short quality line: ``--validate-every``
    1 and 3 check it and fail, 4 passes it by (4 and 8 are checked); from
    the file (the native loader) and from stdin (the record stream)."""
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    runs = _run_both(
        tmp_path, monkeypatch, caplog,
        [*(() if stdin else (inputs["bad"],)), "-s", "b", "-k", "21", "-o",
         "{out}", "--validate-every", every, "--pcr-primers", PRIMER_SPEC],
        stdin=inputs["bad"] if stdin else None)
    _assert_same_outputs(runs)
    checked = BAD_RECORD % int(every) == 0
    assert runs["torch"][0] == (1 if checked else 0)
    errors = {name: [m for m in runs[name][2] if "FASTQ record" in m]
              for name in runs}
    assert errors["torch"] == errors["jax"]
    assert bool(errors["torch"]) == checked
    if checked:
        assert f"record {BAD_RECORD + 1} " in errors["torch"][0]
