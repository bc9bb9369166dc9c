"""Every remaining CLI knob through both CLIs, in process: identical
outputs, and each knob shown to bind on the input.

The input is the 18S fixture of ``test_cli_e2e`` (tiling reads of one
amplicon) with a few seeded read families added so that each knob has
something to act on: error bubbles at 1, 2 and 4 copies, a low-coverage
tip, a high-coverage window, a back-jumping chimera (a cycle in the
graph) and a primer-site variant. Every case runs with ``-vv
--dump-graph``: ``.dot`` files, FASTA and ``stats.yaml`` (but for
``command`` and ``peak_memory_bytes``) must agree between the JAX CLI
(on the CPU) and the port's (``SHARKMER_TORCH_DEVICE=cpu``), and the
port's outputs or its evidence log lines must differ from the run
without the knob. The early exits must print the same and exit alike.
"""

import logging
import os
import pathlib
import re

import pytest
import yaml

from sharkmer_tpu.main import main as jax_main
from sharkmer_tpu_torch.main import main as torch_main

from data_18s import READ_STRING as S
from test_cli_e2e import PRIMER_SPEC, tiling_reads
from test_torch_entries import _one_torch_thread  # noqa: F401
from util import fastq_bytes, write_fastq

import chip_smoke

VARYING = ("command", "peak_memory_bytes")
# the primer pair at the CLI's lowest min-count, so that
# --min-kmer-count 3 clamps it
SPEC = PRIMER_SPEC.replace("min-count=3", "min-count=2")
# the log lines that show a knob at work: the table's floor, tip pruning
# (what reachability pruning still finds), the primer-kmer cap, the node
# budget, the paths each walk finds and the products kept
EVIDENCE = ("Filtering kmers with count", "Reachability pruning",
            "dropped", "Global node budget", "Found", "were retained",
            "were generated and retained", "node budget exceeded")


def _sub(seq: str, i: int) -> str:
    return seq[:i] + "ACGT"[("ACGT".index(seq[i]) + 1) % 4] + seq[i + 1:]


def knob_reads() -> list[str]:
    """The 18S fixture and the read families its knobs act on."""
    fwd = S.index("GTTGATCCTGCCAGTATCATA")  # the forward primer's k-mer
    return (tiling_reads(S) + [S] * 5
            + [_sub(S[1200:1320], 60)]  # a bubble of count 1
            + [_sub(S[300:420], 60)] * 2  # count 2: --min-kmer-count 3
            + [_sub(S[1500:1620], 60)] * 4  # count 4: both paths kept
            + [_sub(S[500:620], 115)] * 3  # a tip short of k
            + [S[600:720]] * 40  # high coverage: --high-coverage-ratio
            + [S[340:400] + S[250:310]] * 4  # a cycle: --max-node-visits
            + [_sub(S[fwd:fwd + 120], 20)] * 3)  # --max-primer-kmers


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    path = tmp_path_factory.mktemp("knobs") / "reads.fastq"
    write_fastq(path, knob_reads())
    return str(path)


def _run(main, argv, caplog) -> tuple[int, list[str]]:
    caplog.clear()
    with caplog.at_level(logging.DEBUG, logger="sharkmer"):
        rc = main(argv)
    return rc, [r.getMessage() for r in caplog.records]


def _outputs(out) -> dict:
    """{file name: bytes}, ``stats.yaml`` parsed without VARYING."""
    files = {}
    for name in sorted(os.listdir(out)):
        data = (out / name).read_bytes()
        if name.endswith(".stats.yaml"):
            data = yaml.safe_load(data)
            for key in VARYING:
                data.pop(key)
        files[name] = data
    return files


def _evidence(messages) -> list[str]:
    return sorted(re.sub(r" Time: [0-9.]+s", "", m) for m in messages
                  if any(e in m for e in EVIDENCE))


def _knob_run(tmp_path, caplog, fastq, name, main, extra) -> tuple:
    out = tmp_path / name
    rc, messages = _run(main, [fastq, "-s", "samp", "-k", "21", "-o",
                               str(out), "-vv", "--dump-graph",
                               "--pcr-primers", SPEC, *extra], caplog)
    assert rc == 0, name
    return _outputs(out), _evidence(messages)


class _Keep(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture(scope="module")
def baseline(tmp_path_factory, fastq):
    """The port's run without a knob: its outputs and evidence lines."""
    patch = pytest.MonkeyPatch()
    patch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    out = tmp_path_factory.mktemp("baseline") / "out"
    logger = logging.getLogger()  # the CLI resets the "sharkmer" handlers
    handler = _Keep()
    logger.addHandler(handler)
    try:
        rc = torch_main([fastq, "-s", "samp", "-k", "21", "-o", str(out),
                         "-vv", "--dump-graph", "--pcr-primers", SPEC])
    finally:
        logger.removeHandler(handler)
        patch.undo()
    assert rc == 0
    return _outputs(out), _evidence(handler.messages)


# each knob at a value that binds on knob_reads(), and what shows it
KNOBS = {
    # the table's floor (the copied FilteredTable and its mirror filter)
    # below the pair's min-count: the same graph, the floor logged
    "min_kmer_count_1": ["--min-kmer-count", "1"],
    # clamps the pair's min-count 2 -> 3: one threshold step, a .dot
    # named _3, the count-2 bubble out
    "min_kmer_count_3": ["--min-kmer-count", "3"],
    "dump_graph": [],  # the pruned graph of the step that found a path
    "table_capacity": ["--backend", "hash", "--table-capacity", "256"],
    "node_budget_global": ["--node-budget-global", "100"],
    "max_node_visits": ["--max-node-visits", "1"],  # no turn of the cycle
    "max_dfs_states": ["--max-dfs-states", "50"],
    "max_paths_per_pair": ["--max-paths-per-pair", "1"],
    "max_primer_kmers": ["--max-primer-kmers", "1"],
    "high_coverage_ratio": ["--high-coverage-ratio", "1.5"],
    "tip_coverage_fraction": ["--tip-coverage-fraction", "0.9"],
    # a second inline pair with every optional key set
    "pcr_primers_inline": [
        "--pcr-primers",
        "name=18s_inline,forward=AACCTGGTTGATCCTGCCAGT,"
        "reverse=TGATCCTTCTGCAGGTTCACCTAC,min-length=1000,max-length=2400,"
        "min-count=3,mismatches=1,trim=14,dedup-edit-threshold=0,"
        "citation=none,notes=every key"],
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_knob_matches_jax_and_binds(tmp_path, monkeypatch, caplog, fastq,
                                    baseline, knob):
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    extra = KNOBS[knob]
    want, want_log = _knob_run(tmp_path, caplog, fastq, "jax", jax_main,
                               extra)
    got, got_log = _knob_run(tmp_path, caplog, fastq, "torch", torch_main,
                             extra)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert got_log == want_log
    if knob == "dump_graph":
        assert (got, got_log) == baseline
    elif knob != "table_capacity":  # the hash table: a capacity, not a cut
        assert got != baseline[0] or got_log != baseline[1], knob


def test_threads_match_jax(tmp_path, monkeypatch, caplog, fastq):
    """The JAX CLI at its default ``-t 1``; the port at ``-t 1`` (one
    gene after another) and at ``-t 4`` (a pool of gene threads) on two
    pairs: the same files."""
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    pairs = KNOBS["pcr_primers_inline"]
    want, _ = _knob_run(tmp_path, caplog, fastq, "jax", jax_main, pairs)
    for threads in ("1", "4"):
        got, _ = _knob_run(tmp_path, caplog, fastq, f"torch_{threads}",
                           torch_main, ["-t", threads, *pairs])
        assert got == want, threads
    assert len([n for n in want if n.endswith(".fasta")]) == 2


def test_committed_fixture_is_knob_reads():
    """``oracles/knobs/knobs.fastq``, the input of ``chip_smoke.py``'s
    knob runs, holds knob_reads() as this file writes them."""
    with open(os.path.join(chip_smoke.KNOB_DIR, "knobs.fastq"), "rb") as f:
        assert f.read() == fastq_bytes(knob_reads())
    assert chip_smoke.KNOB_SPEC == SPEC


@pytest.mark.parametrize("run", chip_smoke.KNOB_RUNS, ids=lambda r: r[1])
def test_knob_oracle_matches_port(tmp_path, monkeypatch, caplog, run):
    """The port on the CPU, as ``chip_smoke.py`` runs it on the card,
    equals each committed JAX oracle of ``oracles/knobs/``; the two limits
    find fewer paths than the unlimited run."""
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    label, name, extra = run
    out = tmp_path / name
    rc, messages = _run(torch_main, [
        os.path.join(chip_smoke.KNOB_DIR, "knobs.fastq"), "-s", "knobs",
        "-k", "21", "-o", str(out), "-v", "--dump-graph", "--pcr-primers",
        SPEC, *extra], caplog)
    assert rc == 0
    oracle = _outputs(pathlib.Path(chip_smoke.KNOB_DIR, name))
    assert _outputs(out) == oracle
    assert chip_smoke.paths_found(messages) == {
        "free": 8, "max_node_visits": 4, "max_paths_per_pair": 1}[name]


EARLY_EXITS = {
    "list_panels": ["--list-panels"],
    "export_panel": ["--export-panel", "cnidaria"],
    "help_pcr": ["--help-pcr"],
    "cite": ["--cite"],
    "completions": ["--completions", "bash"],
    "validate_panels": ["--validate-panels", "--pcr-panel", "cnidaria",
                        "--pcr-primers", SPEC],
    "dry_run": ["{fastq}", "-s", "samp", "-o", "{out}", "--dry-run",
                "--chunks", "3", "-m", "100", "--pcr-panel", "cnidaria"],
}


@pytest.mark.parametrize("flag", list(EARLY_EXITS))
def test_early_exit_matches_jax(tmp_path, monkeypatch, capsys, fastq, flag):
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    argv = [a.format(fastq=fastq, out=tmp_path / "out")
            for a in EARLY_EXITS[flag]]
    said = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        with pytest.raises(SystemExit) as exit_:
            main(argv)
        captured = capsys.readouterr()
        said[name] = (exit_.value.code, captured.out, captured.err)
    assert said["torch"] == said["jax"]
    code, out, err = said["torch"]
    assert code in (0, None) and (out or err)
    assert not (tmp_path / "out").exists()
