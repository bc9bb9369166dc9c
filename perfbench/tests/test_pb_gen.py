"""The generator: the same seed gives the same sample, in the layout the
port's native loader hands the engine."""

import numpy as np
import pytest

from perfbench import gen, spec

CFG = "cnidaria-8M-sorted"


@pytest.fixture
def cfg(root, small):
    bench = spec.load(root)
    c = spec.config(root, bench, CFG)
    c.update(small)
    return c


def test_same_seed_same_sample(cfg):
    a = gen.make_sample(cfg, 2**31 + 5, "cpu")
    b = gen.make_sample(cfg, 2**31 + 5, "cpu")
    c = gen.make_sample(cfg, 2**31 + 6, "cpu")
    assert np.array_equal(a.codes, b.codes)
    assert a.amplicons == b.amplicons
    assert not np.array_equal(a.codes, c.codes)
    assert a.amplicons != c.amplicons
    # every seed gives the same sizes
    assert [len(x) for x in a.amplicons] == [len(x) for x in c.amplicons]


def test_loader_layout(cfg):
    s = gen.make_sample(cfg, 7, "cpu")
    read_len = cfg["read_len"]
    assert s.codes.dtype == np.uint8 and s.lens.dtype == np.int64
    assert s.codes.shape == (cfg["n_reads"], 160)  # 150 up to 32's multiple
    assert (s.codes[:, :read_len] < 4).all()
    assert (s.codes[:, read_len:] == gen.CODE_PAD).all()
    assert (s.lens == read_len).all()
    sizes = [c.shape[0] for c, _ in s.batches]
    assert sizes[:-1] == [cfg["batch_reads"]] * (len(sizes) - 1)
    assert sum(sizes) == cfg["n_reads"]
    assert s.n_events == cfg["n_reads"] * (read_len - cfg["k"] + 1)


def test_amplicons_follow_the_panel(cfg):
    pairs = gen.panel_pairs(cfg["panel_file"])
    amps = gen.make_amplicons(pairs, 3)
    assert len(amps) == len(pairs) == 7
    for p, amp in zip(pairs, amps):
        assert len(amp) == p["expected_length"]
        fwd = amp[: len(p["forward_seq"])]
        assert all(b in gen.IUPAC[c] for b, c in zip(fwd, p["forward_seq"]))
        rev = amp[-len(p["reverse_seq"]):].translate(
            str.maketrans("ACGT", "TGCA"))[::-1]
        assert all(b in gen.IUPAC[c] for b, c in zip(rev, p["reverse_seq"]))


def test_amplicons_are_in_the_reads(cfg):
    """Each amplicon's middle is read many times, on either strand."""
    s = gen.make_sample(cfg, 11, "cpu")
    text = "\n".join("".join("ACGT"[b] for b in row[:cfg["read_len"]])
                     for row in s.codes)
    comp = str.maketrans("ACGT", "TGCA")
    for amp in s.amplicons:
        probe = amp[len(amp) // 2 : len(amp) // 2 + 25]
        assert probe in text or probe.translate(comp)[::-1] in text


def test_copies_must_fit(cfg):
    with pytest.raises(ValueError):
        gen.copy_positions(10_000, [3000, 500], copies=5)

