"""Both CLIs, in process, on the same FASTQ: identical output files.

The JAX package's CLI (``sharkmer_tpu.main``) runs on the CPU; the
port's (``sharkmer_tpu_torch.main``) under ``SHARKMER_TORCH_DEVICE=cpu``.
``.histo``, ``.final.histo`` and the FASTA files must be byte-identical,
and ``stats.yaml`` identical apart from ``command`` and
``peak_memory_bytes``.
"""

import os

import pytest
import yaml

from sharkmer_tpu.main import main as jax_main
from sharkmer_tpu_torch.main import main as torch_main

from data_18s import READ_STRING
from test_cli_e2e import PRIMER_SPEC, tiling_reads
from util import write_fastq

VARYING = ("command", "peak_memory_bytes")


@pytest.fixture(scope="module")
def fastq_18s(tmp_path_factory):
    path = tmp_path_factory.mktemp("reads") / "reads.fastq"
    write_fastq(path, tiling_reads(READ_STRING) + [READ_STRING] * 5)
    return str(path)


def _run_both(tmp_path, fastq, extra):
    outs = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / name
        rc = main([fastq, "-s", "samp", "-k", "21", "-o", str(out),
                   "--pcr-primers", PRIMER_SPEC, *extra])
        assert rc == 0, name
        outs[name] = out
    return outs["jax"], outs["torch"]


def _assert_same_outputs(jax_out, torch_out, expect_histo):
    names = sorted(os.listdir(jax_out))
    assert names == sorted(os.listdir(torch_out))
    assert "samp_18s.fasta" in names
    assert ("samp.final.histo" in names) == expect_histo
    for name in names:
        a = (jax_out / name).read_bytes()
        b = (torch_out / name).read_bytes()
        if name.endswith(".stats.yaml"):
            a, b = yaml.safe_load(a), yaml.safe_load(b)
            for key in VARYING:
                a.pop(key), b.pop(key)
        assert a == b, name


@pytest.mark.parametrize("chunks", ["0", "5"])
def test_cli_outputs_identical(tmp_path, monkeypatch, fastq_18s, chunks):
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    jax_out, torch_out = _run_both(tmp_path, fastq_18s, ["--chunks", chunks])
    _assert_same_outputs(jax_out, torch_out, expect_histo=chunks != "0")


def test_cli_outputs_identical_small_drain_budget(tmp_path, monkeypatch,
                                                  fastq_18s):
    """A drain budget below the input's k-mer count: several drains,
    compacting drains on the run_starts path, staged merges."""
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SHARKMER_MAX_AGG", "16384")
    jax_out, torch_out = _run_both(tmp_path, fastq_18s, ["--chunks", "1"])
    _assert_same_outputs(jax_out, torch_out, expect_histo=True)


@pytest.mark.parametrize("mirror", ["auto", "full"])
def test_cli_mirror_modes_identical(tmp_path, monkeypatch, fastq_18s, mirror):
    """``--mirror auto`` resolves to the reach prefetch (the port's store
    has ``reach``) and never builds the host mirror; ``--mirror full``
    serves the walk from the mirror. Both match the JAX CLI byte for
    byte."""
    from sharkmer_tpu_torch.ops.sorted_store import SortedKmerStore

    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    calls = {"reach": 0, "to_sorted_arrays": 0}
    for name in calls:
        original = getattr(SortedKmerStore, name)

        def counted(self, *a, _name=name, _original=original, **kw):
            calls[_name] += 1
            return _original(self, *a, **kw)

        monkeypatch.setattr(SortedKmerStore, name, counted)
    jax_out, torch_out = _run_both(tmp_path, fastq_18s, ["--mirror", mirror])
    _assert_same_outputs(jax_out, torch_out, expect_histo=False)
    if mirror == "auto":
        assert calls["reach"] > 3 and calls["to_sorted_arrays"] == 0
    else:
        assert calls["reach"] == 0 and calls["to_sorted_arrays"] == 1


def test_cli_refuses_unported_options(tmp_path, monkeypatch, fastq_18s):
    """Every option is ported: ``--n-shards 4`` (the sharded sorted
    store, ``parallel/``) under ``--mirror auto`` serves the walk from
    the owner-routed reach closure, never builds the host mirror, and
    matches the JAX CLI's ``--n-shards 4`` (four devices of the CPU
    mesh) byte for byte."""
    from sharkmer_tpu_torch.parallel.sorted_sharded import ShardedSortedStore

    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    calls = {"reach": 0, "to_sorted_arrays": 0}
    for name in calls:
        original = getattr(ShardedSortedStore, name)

        def counted(self, *a, _name=name, _original=original, **kw):
            calls[_name] += 1
            return _original(self, *a, **kw)

        monkeypatch.setattr(ShardedSortedStore, name, counted)
    jax_out, torch_out = _run_both(tmp_path, fastq_18s, ["--n-shards", "4"])
    _assert_same_outputs(jax_out, torch_out, expect_histo=False)
    assert calls["reach"] > 3 and calls["to_sorted_arrays"] == 0
