"""The benchmark's input: a synthetic sample made from a seed.

A rewrite of the method of the port's ``tools/synth.py`` (which it does
not call), at a configuration's own scale: a uniform random genome, one
amplicon per primer pair of the configuration's frozen panel embedded
``amplicon_copies`` times, ``n_reads`` reads of ``read_len`` bases drawn
uniformly from either strand, uniform substitutions at ``error_rate``.
The genome and the reads are made on ``device`` by a ``torch.Generator``
in a few large calls, then copied once to host memory, where a FASTQ
loader leaves its batches.

The batches are laid out as the port's native loader hands them to the
counting engine (``io/native.NativeFastqReader`` under
``PrefetchingBatches(batch_reads=1 << 17)``): ``[batch_reads, width]``
uint8 codes (A, C, G, T = 0..3), right-padded with the pad code 5 to a
multiple of 32 columns, and int64 read lengths. Every seed gives the same
sizes, amplicon lengths and positions; the seed changes the bases.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import yaml

CODE_PAD = 5  # the loader's right-padding code (no k-mer covers it)
WIDTH_BUCKET = 32  # the loader pads a read's width up to a multiple of this
SLAB_READS = 1 << 20  # reads made per device step (bounds temporaries)

# IUPAC nucleotide codes: the bases each stands for
IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T",
    "R": "AG", "Y": "CT", "S": "GC", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}
_COMP = str.maketrans("ACGT", "TGCA")
_CODE = {b: i for i, b in enumerate("ACGT")}


@dataclass
class Sample:
    codes: np.ndarray  # [n_reads, width] uint8
    lens: np.ndarray  # [n_reads] int64
    batch_reads: int
    k: int
    amplicons: list[str]  # one per primer pair, in panel order
    genome_bp: int

    @property
    def batches(self):
        """(codes, lens) views of ``batch_reads`` rows, the last shorter."""
        for lo in range(0, self.codes.shape[0], self.batch_reads):
            yield (self.codes[lo : lo + self.batch_reads],
                   self.lens[lo : lo + self.batch_reads])

    @property
    def n_reads(self) -> int:
        return int(self.codes.shape[0])

    @property
    def n_bases(self) -> int:
        return int(self.lens.sum())

    @property
    def n_events(self) -> int:
        """k-mer windows of the reads (every base is A, C, G or T)."""
        return int(np.maximum(self.lens - self.k + 1, 0).sum())


def seed_of(seed: int) -> int:
    """Any whole number as a seed both generators take."""
    return int(seed) % (1 << 63)


def panel_pairs(path: str) -> list[dict]:
    """The primer pairs of a panel file, in file order."""
    with open(path) as f:
        panel = yaml.safe_load(f)
    return [p for p in panel["primers"] if not p.get("deprecated")]


def realize(primer: str, rng) -> str:
    """One concrete sequence of a degenerate primer."""
    return "".join(c if c in "ACGT" else rng.choice(list(IUPAC[c]))
                   for c in primer.upper())


def make_amplicons(pairs: list[dict], seed: int) -> list[str]:
    """One amplicon per pair: the forward primer, a random insert, the
    reverse primer's reverse complement; degenerate bases and the insert
    drawn from ``seed``, the length the pair's expected length."""
    rng = np.random.default_rng(seed_of(seed))
    out = []
    for p in pairs:
        fwd = realize(p["forward_seq"], rng)
        rev = realize(p["reverse_seq"], rng)
        total = p.get("expected_length") or (p["min_length"]
                                             + p["max_length"]) // 2
        insert = "".join(rng.choice(list("ACGT"),
                                    size=total - len(fwd) - len(rev)))
        out.append(fwd + insert + rev.translate(_COMP)[::-1])
    return out


def copy_positions(genome_bp: int, lengths: list[int], copies: int):
    """Start of every embedded copy: the ``copies * len(lengths)`` copies
    spread evenly over the genome, pair after pair."""
    n = copies * len(lengths)
    stride = genome_bp // (n + 1)
    if stride <= max(lengths):
        raise ValueError(f"{n} amplicon copies do not fit {genome_bp} bp")
    return [(i + 1) * stride for i in range(n)]


def make_sample(cfg: dict, seed: int, device) -> Sample:
    """The configuration's sample from ``seed``, on the host."""
    device = torch.device(device)
    k, read_len = int(cfg["k"]), int(cfg["read_len"])
    genome_bp, n_reads = int(cfg["genome_bp"]), int(cfg["n_reads"])
    width = -(-read_len // WIDTH_BUCKET) * WIDTH_BUCKET
    gen = torch.Generator(device=device).manual_seed(seed_of(seed))

    genome = torch.randint(0, 4, (genome_bp,), dtype=torch.uint8,
                           device=device, generator=gen)
    amplicons = make_amplicons(panel_pairs(cfg["panel_file"]), seed)
    copies = int(cfg["amplicon_copies"])
    starts = copy_positions(genome_bp, [len(a) for a in amplicons], copies)
    pos, vals = [], []
    for i, amp in enumerate(amplicons):
        codes = np.array([_CODE[b] for b in amp], np.uint8)
        for s in starts[i * copies : (i + 1) * copies]:
            pos.append(np.arange(s, s + len(codes)))
            vals.append(codes)
    genome[torch.from_numpy(np.concatenate(pos)).to(device)] = (
        torch.from_numpy(np.concatenate(vals)).to(device))

    out = torch.full((n_reads, width), CODE_PAD, dtype=torch.uint8,
                     device=device)
    col = torch.arange(read_len, device=device)
    for lo in range(0, n_reads, SLAB_READS):
        n = min(SLAB_READS, n_reads - lo)
        first = torch.randint(0, genome_bp - read_len + 1, (n,),
                              device=device, generator=gen)
        reads = genome[first[:, None] + col[None, :]]
        wrong = torch.rand((n, read_len), device=device,
                           generator=gen) < float(cfg["error_rate"])
        shift = torch.randint(1, 4, (n, read_len), dtype=torch.uint8,
                              device=device, generator=gen)
        reads = torch.where(wrong, (reads + shift) & 3, reads)
        reverse = torch.rand((n,), device=device, generator=gen) < 0.5
        reads = torch.where(reverse[:, None], (3 - reads).flip(1), reads)
        out[lo : lo + n, :read_len] = reads
        del first, reads, wrong, shift, reverse
    del genome
    codes = out.cpu().numpy()
    del out
    return Sample(codes=codes, lens=np.full(n_reads, read_len, np.int64),
                  batch_reads=int(cfg["batch_reads"]), k=k,
                  amplicons=amplicons, genome_bp=genome_bp)
