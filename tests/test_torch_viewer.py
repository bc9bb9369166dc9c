"""The port's viewer (``sharkmer_tpu_torch.viewer``, a copy of
``sharkmer_tpu.viewer``) against the original, on the committed chunked
spectra of the cnidaria cell (``oracles/``): the same parsed histogram,
peaks, genome-size estimates and report files."""

import os

import numpy as np

from sharkmer_tpu import viewer as jax_viewer
from sharkmer_tpu_torch import viewer

ORACLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "oracles", "cnidaria", "synthetic-seed0", "chunks10_250000")
SAMPLE = "synthetic-seed0_250000"
HISTO = os.path.join(ORACLE, f"{SAMPLE}.histo")
STATS = os.path.join(ORACLE, f"{SAMPLE}.stats.yaml")


def test_viewer_reads_the_chunked_oracle():
    counts, histos = viewer.load_histo(HISTO)
    want_counts, want_histos = jax_viewer.load_histo(HISTO)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(histos, want_histos)
    assert histos.shape == (10001, 10) and counts[0] == 1
    # each chunk's spectrum adds reads: the distinct k-mers grow
    distinct = histos.sum(axis=0)
    assert (np.diff(distinct) > 0).all()
    final_counts, final = viewer.load_histo(
        os.path.join(ORACLE, f"{SAMPLE}.final.histo"))
    np.testing.assert_array_equal(final_counts, counts)
    np.testing.assert_array_equal(final[:, 0], histos[:, -1])
    for c in range(histos.shape[1]):
        assert viewer.find_peaks(histos[:, c]) == \
            jax_viewer.find_peaks(histos[:, c])
        assert viewer.find_valleys(histos[:, c]) == \
            jax_viewer.find_valleys(histos[:, c])
    assert viewer.genome_size_estimates(histos) == \
        jax_viewer.genome_size_estimates(histos)


def test_viewer_report_equals_the_original(tmp_path, capsys):
    """``sharkmer-torch-viewer`` writes the original viewer's files byte
    for byte and prints the same lines. At 250k reads (under 2x genome
    coverage) the final spectrum has no coverage peak, so both write the
    spectrum page and no genome-size page."""
    outs = {}
    for name, module in (("jax", jax_viewer), ("torch", viewer)):
        out_dir = tmp_path / name
        out_dir.mkdir()
        assert module.main(["-d", HISTO, "-s", STATS, "-n", "cnidaria",
                            "-o", str(out_dir / "report")]) == 0
        outs[name] = (capsys.readouterr().out,
                      {f: (out_dir / f).read_bytes()
                       for f in sorted(os.listdir(out_dir))})
    assert outs["torch"] == outs["jax"]
    printed, files = outs["torch"]
    assert "No peaks found." in printed
    assert list(files) == ["report.html"]
    assert b"cnidaria" in files["report.html"]
