"""The hash backend and table checkpoints through both CLIs, in process.

The JAX package's CLI (``sharkmer_tpu.main``) runs on the CPU; the
port's (``sharkmer_tpu_torch.main``) under ``SHARKMER_TORCH_DEVICE=cpu``.

* ``--backend hash`` under every ``--mirror`` mode, and with chunked
  spectra: ``.histo``, ``.final.histo`` and FASTA byte-identical,
  ``stats.yaml`` equal but for ``command`` and ``peak_memory_bytes``.
* ``--save-table`` / ``--load-table`` across packages and backends: a
  checkpoint saved by either package loads into either backend of the
  other, and the sPCR run from it gives the counting run's FASTA and
  ``stats.yaml`` (the ingest stats restored from the checkpoint). The two
  packages' checkpoints hold equal arrays and ``meta``.
"""

import json
import os

import numpy as np
import pytest
import yaml

from sharkmer_tpu.main import main as jax_main
from sharkmer_tpu_torch.main import main as torch_main

from data_18s import READ_STRING
from test_cli_e2e import PRIMER_SPEC, tiling_reads
from util import write_fastq

VARYING = ("command", "peak_memory_bytes")
MAINS = {"jax": jax_main, "torch": torch_main}


@pytest.fixture(scope="module")
def fastq_18s(tmp_path_factory):
    path = tmp_path_factory.mktemp("reads") / "reads.fastq"
    write_fastq(path, tiling_reads(READ_STRING) + [READ_STRING] * 5)
    return str(path)


@pytest.fixture(autouse=True)
def _torch_on_cpu(monkeypatch):
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")


def _run(name, out, args):
    rc = MAINS[name](["-s", "samp", "-k", "21", "-o", str(out),
                      "--pcr-primers", PRIMER_SPEC, *args])
    assert rc == 0, (name, args)
    return out


def _assert_same_outputs(a_dir, b_dir):
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir))
    assert "samp_18s.fasta" in names
    for name in names:
        a = (a_dir / name).read_bytes()
        b = (b_dir / name).read_bytes()
        if name.endswith(".stats.yaml"):
            a, b = yaml.safe_load(a), yaml.safe_load(b)
            for key in VARYING:
                a.pop(key), b.pop(key)
        assert a == b, name


def _count_calls(monkeypatch, cls, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        original = getattr(cls, name)

        def counted(self, *a, _name=name, _original=original, **kw):
            calls[_name] += 1
            return _original(self, *a, **kw)

        monkeypatch.setattr(cls, name, counted)
    return calls


@pytest.mark.parametrize("mirror,chunks", [("auto", "0"), ("full", "0"),
                                           ("device", "0"), ("auto", "5")])
def test_hash_backend_outputs_identical(tmp_path, monkeypatch, fastq_18s,
                                        mirror, chunks):
    """The hash table has no ``reach``: ``--mirror auto`` resolves to the
    host mirror (one ``to_sorted_arrays``), ``--mirror device`` to
    directional lookups and no mirror."""
    from sharkmer_tpu_torch.ops.hashtable import KmerTable

    calls = _count_calls(monkeypatch, KmerTable,
                         ["to_sorted_arrays", "lookup_directional"])
    args = [fastq_18s, "--backend", "hash", "--mirror", mirror,
            "--chunks", chunks]
    jax_out = _run("jax", tmp_path / "jax", args)
    torch_out = _run("torch", tmp_path / "torch", args)
    _assert_same_outputs(jax_out, torch_out)
    assert ("samp.final.histo" in os.listdir(torch_out)) == (chunks != "0")
    if mirror == "device":
        assert calls["to_sorted_arrays"] == 0
        assert calls["lookup_directional"] > 3
    else:
        assert calls["to_sorted_arrays"] == 1
        assert calls["lookup_directional"] == 0


def test_hash_backend_equals_sorted_backend(tmp_path, fastq_18s):
    """In the port, the two backends give the same files (chunked, so
    the spectra are compared too), at a first hash table far below the
    input (``--table-capacity 4096``: the table grows)."""
    common = [fastq_18s, "--chunks", "3"]
    sorted_out = _run("torch", tmp_path / "sorted", common)
    hash_out = _run("torch", tmp_path / "hash",
                    [*common, "--backend", "hash", "--table-capacity", "4096"])
    _assert_same_outputs(sorted_out, hash_out)


@pytest.fixture(scope="module")
def counting_runs(fastq_18s, tmp_path_factory):
    """Each package's counting run with ``--save-table``: the JAX package
    on its default (sorted) backend, the port on the hash backend."""
    root = tmp_path_factory.mktemp("counting")
    mp = pytest.MonkeyPatch()
    mp.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    try:
        runs = {}
        for name, backend in (("jax", "sorted"), ("torch", "hash")):
            ckpt = root / f"{name}.npz"
            out = _run(name, root / name, [fastq_18s, "--backend", backend,
                                           "--save-table", str(ckpt)])
            assert ckpt.exists()
            runs[name] = (out, ckpt)
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("saver,loader,backend", [
    ("jax", "torch", "sorted"), ("jax", "torch", "hash"),
    ("torch", "jax", "sorted"), ("torch", "jax", "hash"),
    ("torch", "torch", "sorted"),
])
def test_checkpoint_cross_load(tmp_path, counting_runs, saver, loader,
                               backend):
    """An sPCR run from the other package's checkpoint (no reads) gives
    the counting run's FASTA and stats."""
    counted, ckpt = counting_runs[saver]
    out = _run(loader, tmp_path / "loaded",
               ["--load-table", str(ckpt), "--backend", backend])
    _assert_same_outputs(counted, out)


def test_checkpoint_k_comes_from_the_file(tmp_path, counting_runs):
    """``-k`` on the command line yields to the checkpoint's k."""
    counted, ckpt = counting_runs["jax"]
    out = tmp_path / "loaded"
    rc = torch_main(["-s", "samp", "-k", "17", "-o", str(out),
                     "--pcr-primers", PRIMER_SPEC, "--load-table", str(ckpt),
                     "--backend", "hash"])
    assert rc == 0
    assert (out / "samp_18s.fasta").read_bytes() == \
        (counted / "samp_18s.fasta").read_bytes()


def test_checkpoint_arrays_and_meta_equal(tmp_path, fastq_18s):
    """The two packages' checkpoints of the same backend hold equal
    arrays (dtype included) and ``meta`` (not equal bytes: zip entries
    carry timestamps)."""
    for backend in ("hash", "sorted"):
        saved = {}
        for name in MAINS:
            ckpt = tmp_path / f"{name}_{backend}.npz"
            _run(name, tmp_path / f"{name}_{backend}",
                 [fastq_18s, "--backend", backend, "--save-table", str(ckpt)])
            with np.load(ckpt, allow_pickle=False) as data:
                saved[name] = {key: data[key] for key in data.files}
        jax_saved, torch_saved = saved["jax"], saved["torch"]
        assert sorted(jax_saved) == sorted(torch_saved) == ["counts", "keys",
                                                            "meta"]
        for key in ("keys", "counts"):
            assert torch_saved[key].dtype == jax_saved[key].dtype
            np.testing.assert_array_equal(torch_saved[key], jax_saved[key])
        meta = json.loads(str(torch_saved["meta"]))
        assert meta == json.loads(str(jax_saved["meta"]))
        assert meta["backend"] == ("KmerTable" if backend == "hash"
                                   else "SortedKmerStore")
        assert meta["format_version"] == 1 and meta["k"] == 21
        assert meta["stats"]["n_reads_read"] > 0


def test_load_table_refuses_shards_and_versions(tmp_path, counting_runs):
    """Shards are no longer refused: with ``--n-shards 4`` each package
    loads the other's checkpoint into a ``ShardedKmerTable`` whatever
    ``--backend`` says, and the sPCR run from it gives the counting run's
    files; both packages' sharded tables hold the same rows. A checkpoint
    of an unknown format version is still refused."""
    from sharkmer_tpu.io.checkpoint import load_table as jax_load_table
    from sharkmer_tpu_torch.io.checkpoint import load_table

    for saver, loader in (("jax", "torch"), ("torch", "jax")):
        counted, ckpt = counting_runs[saver]
        out = _run(loader, tmp_path / f"{saver}_to_{loader}",
                   ["--load-table", str(ckpt), "--n-shards", "4",
                    "--backend", "sorted"])
        _assert_same_outputs(counted, out)
        table, stats = load_table(str(ckpt), "cpu", n_shards=4)
        want, want_stats = jax_load_table(str(ckpt), 4)
        assert type(table).__name__ == type(want).__name__ \
            == "ShardedKmerTable"
        assert table.n_shards == want.n_shards == 4
        assert table.local_capacity == want.local_capacity
        assert stats == want_stats
        for got, expected in zip(table.to_sorted_arrays(),
                                 want.to_sorted_arrays()):
            np.testing.assert_array_equal(got, expected)
    bad = tmp_path / "v2.npz"
    np.savez_compressed(bad, keys=np.zeros(0, np.uint64),
                        counts=np.zeros(0, np.uint32),
                        meta=json.dumps({"format_version": 2, "k": 21}))
    with pytest.raises(ValueError, match="version"):
        load_table(str(bad), "cpu")
