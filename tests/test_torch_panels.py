"""The nine built-in primer panels through the port, against the JAX
package.

* The synthesizer (``tools/synth.py``) writes the original's reads byte
  for byte for three panels, and the amplicons it returns are the ones
  it embeds: the reference that ``chip_smoke.py`` holds deep runs to.
* Each panel's batched primer scan, built as ``warm_panel_scans`` builds
  it, on stores of ``synth_genome_for_panel(panel, seed=7)``'s tiling
  reads: the port's sorted ``prefix_scan_many`` equal to JAX's, and each
  request through the port's hash ``prefix_scan`` equal to JAX's,
  request by request. Insecta's scan is 2^20 wide; a small ``max_out``
  forces its retry.

The CLIs on these panels: ``tests/test_torch_panel_cli.py``.
"""

import functools
import gzip
import os
import types

import numpy as np
import pytest

from sharkmer_tpu.ops import KmerTable as JaxTable
from sharkmer_tpu.ops import ascii_to_codes, codes_to_batch
from sharkmer_tpu.ops.sorted_store import SortedKmerStore as JaxStore
from sharkmer_tpu_torch.ops import sorted_store
from sharkmer_tpu_torch.ops.hashtable import KmerTable
from sharkmer_tpu_torch.ops.sorted_store import SortedKmerStore
from sharkmer_tpu_torch.pcr.panels import get_panel
from sharkmer_tpu_torch.pcr.params import IUPAC
from sharkmer_tpu_torch.pcr.primers import warm_panel_scans
from sharkmer_tpu_torch.tools import synth

from test_gene_recovery import (
    PANELS,
    _rc,
    synth_genome_for_panel,
    tiling_reads,
)
from test_torch_entries import _one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 19
# the padded width of each panel's one batched scan at k=19
# (prefix_scan_many: the next power of two of its oligos, at least 64)
SCAN_WIDTH = {"insecta": 1 << 20, "c_elegans": 1 << 10}
RETRY_OUT = 8  # a max_out that insecta's matches on the tiling reads pass
# the synthetic cells' seeds (the grid's cnidaria 0, hydrozoa 1, metazoa 2)
SYNTH_SEEDS = {"angiospermae": 3, "bacteria": 4, "c_elegans": 5, "human": 6,
               "insecta": 7, "teleostei": 8}


def _reads(panel: str) -> list[str]:
    """``test_gene_recovery``'s tiling reads of the panel's genome: both
    strands, ~12x."""
    genome, _ = synth_genome_for_panel(panel, seed=7)
    return tiling_reads(genome, 150, 25) + [
        _rc(r) for r in tiling_reads(genome, 150, 37)]


@functools.cache
def _requests(panel: str) -> list:
    """The (oligos, length) requests of the panel's batched scan at k=19,
    as ``warm_panel_scans`` hands them to ``prefix_scan_many``."""
    requests = []

    def scan_many(batch):
        requests.extend(batch)
        return [None] * len(batch)

    counts = types.SimpleNamespace(
        k=K, table=types.SimpleNamespace(prefix_scan_many=scan_many),
        _scan_cache={})
    warm_panel_scans(counts, get_panel(panel))
    return requests


def _pairs(kmers, counts) -> list:
    return sorted(zip(np.asarray(kmers).tolist(),
                      np.asarray(counts).tolist()))


@functools.cache
def _stores(panel: str):
    """(JAX sorted store, port sorted store, JAX hash table, port hash
    table), each holding the panel's tiling reads."""
    reads = _reads(panel)
    codes = codes_to_batch([ascii_to_codes(r) for r in reads], width=150)
    jstore, tstore = JaxStore.create(K), SortedKmerStore(K, "cpu")
    jstore.ingest_codes(codes)
    tstore.ingest_codes(codes)
    jtable = JaxTable.create(K, 1 << 16).ingest_codes(codes)
    ttable = KmerTable.create(K, 1 << 16, "cpu").ingest_codes(codes)
    return jstore, tstore, jtable, ttable


# -- the synthesizer ---------------------------------------------------------


@pytest.mark.parametrize("panel", ["insecta", "c_elegans", "bacteria"])
def test_synth_reads_equal_the_original(tmp_path, monkeypatch, panel):
    """The port's FASTQ, byte for byte, equal to
    ``scripts/sharkmer_validate/synth.py``'s for a panel and seed."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "scripts"))
    from sharkmer_validate import synth as original

    path = os.path.join(ROOT, "sharkmer_tpu", "panels", f"{panel}.yaml")
    seed = SYNTH_SEEDS[panel]
    a = original.synthesize_panel_fastq(path, tmp_path / "a.fastq.gz",
                                        n_reads=1500, seed=seed)
    b = synth.synthesize_panel_fastq(path, tmp_path / "b.fastq.gz",
                                     n_reads=1500, seed=seed)
    with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
        ra, rb = fa.read(), fb.read()
    assert ra == rb and ra.count(b"\n") == 4 * 1500


@pytest.mark.parametrize("panel", ["insecta", "human"])
def test_synth_amplicons_lie_in_the_genome(panel):
    """``panel_amplicons`` returns each primer pair's amplicon: 8 copies
    of it in the synthesized genome, its primers' concrete forms at
    both ends, its expected length, one a gene of ``get_panel``."""
    path = os.path.join(ROOT, "sharkmer_tpu_torch", "panels", f"{panel}.yaml")
    seed = SYNTH_SEEDS[panel]
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=int(2e6), dtype=np.uint8)
    embedded = synth.embed_amplicons(path, genome, rng)
    assert synth.panel_amplicons(path, genome_mbp=2.0, seed=seed) == embedded
    text = np.frombuffer(b"ACGT", np.uint8)[genome].tobytes().decode()
    # the CLI's gene names: the panel's name before the file's
    params = {p.gene_name: p for p in get_panel(panel)}
    assert sorted(f"{panel}_{gene}" for gene in embedded) == sorted(params)
    for gene, amp in embedded.items():
        p = params[f"{panel}_{gene}"]
        assert text.count(amp) == 8, gene
        assert len(amp) == (p.expected_length
                            or (p.min_length + p.max_length) // 2)
        for primer, part in ((p.forward_seq, amp[:len(p.forward_seq)]),
                             (p.reverse_seq, _rc(amp)[:len(p.reverse_seq)])):
            assert all(b in IUPAC.get(c, c) for c, b in zip(primer, part))


# -- the batched primer scans --------------------------------------------------


@pytest.mark.parametrize("panel", PANELS)
def test_panel_scans_match_jax(panel):
    """The panel's requests through both sorted stores' one batched scan,
    and each through both hash tables' sweep: equal, request by
    request, with hits in most requests."""
    requests = _requests(panel)
    width = max(64, 1 << (sum(len(o) for o, _ in requests) - 1).bit_length())
    assert width == SCAN_WIDTH.get(panel, width)
    jstore, tstore, jtable, ttable = _stores(panel)
    got = tstore.prefix_scan_many(requests)
    want = jstore.prefix_scan_many(requests)
    assert len(got) == len(want) == len(requests)
    hit = 0
    for (gk, gc), (wk, wc), (oligos, olen) in zip(got, want, requests):
        pairs = _pairs(gk, gc)
        assert pairs == _pairs(wk, wc)
        assert _pairs(*ttable.prefix_scan(oligos, olen, 1)) == pairs
        assert _pairs(*jtable.prefix_scan(oligos, olen, 1)) == pairs
        hit += bool(pairs)
    assert hit


def test_insecta_scan_retries_past_max_out(monkeypatch):
    """Insecta's 2^20-wide scan at a ``max_out`` (RETRY_OUT) its matches
    pass: the port's ``panel_scan`` reruns at the next power of two, and
    every request still equals JAX's at the same ``max_out``."""
    requests = _requests("insecta")
    jstore, tstore, _, _ = _stores("insecta")
    calls = []
    scan = sorted_store.panel_scan

    def counted(*args):
        calls.append((args[5].shape[0], args[-1]))  # (width, max_out)
        return scan(*args)

    monkeypatch.setattr(sorted_store, "panel_scan", counted)
    got = tstore.prefix_scan_many(requests, max_out=RETRY_OUT)
    want = jstore.prefix_scan_many(requests, max_out=RETRY_OUT)
    assert calls[0] == (1 << 20, RETRY_OUT)
    assert len(calls) > len(tstore.parts)
    assert all(mo > RETRY_OUT for _, mo in calls[1:])
    for (gk, gc), (wk, wc) in zip(got, want, strict=True):
        assert _pairs(gk, gc) == _pairs(wk, wc)
    assert sum(len(k) for k, _ in got) > 2 * RETRY_OUT
