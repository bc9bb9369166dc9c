"""Both CLIs, in process, with built-in panels (``--pcr-panel NAME``,
the copied YAML through ``get_panel``): identical output files.

* ``--pcr-panel insecta --mirror full`` (21 pairs: the 2^20-wide
  batched primer scan, 21 gene threads) on ``tests/test_torch_panels.py``'s
  tiling reads of ``synth_genome_for_panel("insecta", seed=7)``.
* ``--pcr-panel human`` on ``test_noisy_recovery``'s heterozygous input
  built from human's amplicons: two haplotypes differing by isolated
  SNPs, each on its own contig, with 0.3% errors, so the reach closure,
  pruning and paths meet real bubbles.

The JAX CLI runs on the CPU, the port's under
``SHARKMER_TORCH_DEVICE=cpu`` (its reach closure, for human, the plain
loop).
FASTA files byte-identical, ``stats.yaml`` equal but for ``command`` and
``peak_memory_bytes``.
"""

import numpy as np
import yaml

from test_gene_recovery import _rc, synth_genome_for_panel, tiling_reads
from test_noisy_recovery import (
    _mutate_allele,
    _random_seq_pair,
    add_errors,
    write_fastq,
)
from test_torch_cli_options import _assert_same_outputs, _run_both
from test_torch_entries import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_panels import K, _reads


def _both(tmp_path, monkeypatch, caplog, fastq: str, panel: str,
          *extra: str) -> dict:
    """Both CLIs with ``--pcr-panel panel`` on ``fastq``, their outputs
    held identical; the port's ``stats.yaml``."""
    runs = _run_both(tmp_path, monkeypatch, caplog, [
        fastq, "-s", "samp", "-k", str(K), "-o", "{out}", "--pcr-panel",
        panel, *extra])
    _assert_same_outputs(runs)
    assert runs["torch"][0] == 0
    return yaml.safe_load((runs["torch"][1] / "samp.stats.yaml").read_text())


def test_insecta_cli_matches_jax(tmp_path, monkeypatch, caplog):
    """``--pcr-panel insecta`` (21 pairs) on the tiling reads: the
    panel's 2^20-wide scan, 21 gene threads, identical outputs. With
    ``--mirror full`` the host mirror serves the walk in both packages,
    so the time goes to the panel, not to the CPU's plain closure loop
    (held to JAX by ``test_torch_reach.py`` and the human case below)."""
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    path = tmp_path / "reads.fastq"
    write_fastq(path, _reads("insecta"))
    stats = _both(tmp_path, monkeypatch, caplog, str(path), "insecta",
                  "--mirror", "full")
    results = stats["pcr_results"]
    assert len(results) == 21
    assert sum(r["status"] == "success" for r in results) >= 15


def test_heterozygous_human_cli_matches_jax(tmp_path, monkeypatch, caplog):
    """Two haplotypes of human's amplicons differing by isolated SNPs,
    each on its own contig, with 0.3% errors (``test_noisy_recovery``'s
    heterozygous input): real bubbles on the reach and path code, and
    identical outputs."""
    monkeypatch.setenv("SHARKMER_TORCH_DEVICE", "cpu")
    _, amplicons = synth_genome_for_panel("human", seed=7)
    rng = np.random.default_rng(42)
    reads = []
    for amp, _total in amplicons.values():
        flank_l, flank_r = _random_seq_pair(200, rng)
        for allele in (amp, _mutate_allele(amp, K, rng)):
            contig = flank_l + allele + flank_r
            reads += tiling_reads(contig, 150, 24)
            reads += [_rc(r) for r in tiling_reads(contig, 150, 25)]
    path = tmp_path / "reads.fastq"
    write_fastq(path, add_errors(reads, 0.003, seed=77))
    stats = _both(tmp_path, monkeypatch, caplog, str(path), "human")
    assert sum(r["status"] == "success" for r in stats["pcr_results"]) >= 5
