"""The chunked spectra (``--chunks N``) against a reference with no count
store in it.

``chip_smoke.chunk_spectra_reference`` (loaded from ``chip_smoke.py``,
which holds the port's runs to it on the card at 8M reads) reads the
reads with the port's FASTQ loader, encodes them with
``ops/encoding.canonical_kmers``, gives read ``i`` to chunk ``(i // 1000)
% N`` and folds the chunks in order into one sorted (key, count) array
with ``torch.sort`` and ``torch.unique_consecutive``. On a seeded FASTQ of
2,600 reads (chunk turns of 1000, 1000 and 600 reads; at ``--chunks 7``
four chunks are empty), some of them with ``N`` bases, and a histogram
cap below the deepest counts (the folded tail bin is full):

* the reference, on the CPU, written through the port's writers, equals
  the JAX CLI's ``.histo`` and ``.final.histo`` byte for byte;
* the port's CLI (``SHARKMER_TORCH_DEVICE=cpu``) writes the same files,
  byte for byte, on the sorted and on the hash backend.

The consolidation's merges (each chunk store's partitions re-inserted
into the master in chunk order) on a small budget, in both packages:
equal contents and spectra after every merge, and the port's master no
wider than twice its keys (a partition at most twice its rows, 64 at
least), where the JAX store's many merges into full partitions leave it
more than three times wider. On the card at 8M reads with 10 chunks, that
widening took the sorted run out of the H100's 80 GB.
"""

import importlib.util
import os

import numpy as np
import pytest
import yaml

from sharkmer_tpu.main import main as jax_main
from sharkmer_tpu.ops.sorted_store import SortedKmerStore as JaxStore
from sharkmer_tpu_torch.main import main as torch_main
from sharkmer_tpu_torch.ops.sorted_store import SortedKmerStore

from util import write_fastq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 21
HISTO_MAX = 40  # below the deepest counts (coverage ~60x)
N_READS = 2600
SAMPLE = "samp"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reads() -> list[str]:
    """2,600 reads of 60-150 bases from both strands of a random 3 kbp
    genome; one in eight carries one to three ``N``."""
    rng = np.random.default_rng(2026)
    genome = rng.integers(0, 4, 3000)
    reads = []
    for _ in range(N_READS):
        length = int(rng.integers(60, 151))
        start = int(rng.integers(0, genome.size - length))
        codes = genome[start : start + length]
        if rng.random() < 0.5:
            codes = 3 - codes[::-1]
        seq = np.array(list("ACGT"))[codes]
        if rng.random() < 0.125:
            seq[rng.integers(0, length, int(rng.integers(1, 4)))] = "N"
        reads.append("".join(seq))
    return reads


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    path = tmp_path_factory.mktemp("reads") / "reads.fastq.gz"
    write_fastq(path, _reads(), gzipped=True)
    return str(path)


@pytest.fixture(scope="module")
def jax_histos(fastq, tmp_path_factory):
    """The JAX CLI's (``.histo``, ``.final.histo``) bytes, a run a chunk
    count."""
    runs = {}

    def run(chunks: int):
        if chunks not in runs:
            out = tmp_path_factory.mktemp(f"jax_chunks{chunks}")
            runs[chunks] = _histos(jax_main, out, chunks, fastq)
        return runs[chunks]

    return run


def _histos(main, out, chunks: int, fastq: str, *extra: str):
    rc = main(["-s", SAMPLE, "-k", str(K), "-o", str(out), "--chunks",
               str(chunks), "--histo-max", str(HISTO_MAX), *extra, fastq])
    assert rc == 0
    return tuple((out / f"{SAMPLE}{suffix}").read_bytes()
                 for suffix in (".histo", ".final.histo"))


@pytest.mark.parametrize("backend", ["sorted", "hash"])
@pytest.mark.parametrize("chunks", [1, 3, 7])
def test_chunk_spectra_equal_reference(tmp_path, monkeypatch, fastq,
                                       jax_histos, chunks, backend):
    want = jax_histos(chunks)
    cs = _chip_smoke()
    spectra, n_kmers = cs.chunk_spectra_reference(fastq, N_READS, chunks, K,
                                                  HISTO_MAX, "cpu")
    assert len(spectra) == chunks
    # the tail bin is in use, and no chunk's spectrum is lost
    assert spectra[-1][HISTO_MAX + 1] > 0
    assert all(a[1:].sum() <= b[1:].sum()
               for a, b in zip(spectra, spectra[1:]))
    cs.write_spectra(str(tmp_path / "ref"), SAMPLE, spectra, K, chunks)
    ref = tuple((tmp_path / "ref" / f"{SAMPLE}{suffix}").read_bytes()
                for suffix in (".histo", ".final.histo"))
    assert ref == want

    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    out = tmp_path / "torch"
    assert _histos(torch_main, out, chunks, fastq, "--backend",
                   backend) == want
    # the reference's valid k-mers are the ones the CLI counted
    stats = yaml.safe_load((out / f"{SAMPLE}.stats.yaml").read_text())
    assert n_kmers == stats["n_kmers"] > 0


def test_consolidation_keeps_the_master_dense():
    k = 21
    rng = np.random.default_rng(11)
    pool = rng.integers(0, 1 << (2 * k), 40_000, dtype=np.uint64)
    jmaster = JaxStore(k, max_agg=1 << 12)
    tmaster = SortedKmerStore(k, "cpu", max_agg=1 << 12)
    for _ in range(8):
        keys = rng.choice(pool, 9000)
        jchunk = JaxStore(k, max_agg=1 << 10)
        tchunk = SortedKmerStore(k, "cpu", max_agg=1 << 10)
        jchunk.insert_kmers(keys)
        tchunk.insert_kmers(keys)
        jmaster = jmaster.merge_from(jchunk)
        tmaster = tmaster.merge_from(tchunk)
        np.testing.assert_array_equal(tmaster.histogram(20),
                                      jmaster.histogram(20))
    for got, want in zip(tmaster.to_sorted_arrays(),
                         jmaster.to_sorted_arrays()):
        np.testing.assert_array_equal(got, want)
    n = tmaster.n_unique()
    assert n == jmaster.n_unique() > 30_000
    width = sum(p.kmers.shape[0] for p in tmaster.parts)
    jax_width = sum(int(p.kmers.shape[0]) for p in jmaster.parts)
    assert width <= 2 * n + 64 * len(tmaster.parts)
    assert jax_width > 3 * n
