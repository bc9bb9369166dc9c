"""The port's encode and its device totals, on the CPU.

* ``canonical_kmers`` (with and without totals) and
  ``canonical_kmers_plain`` on CPU tensors against the JAX package's
  ``canonical_kmers`` and a host count of the valid bases, at k from 1
  to 31 and widths from narrower than k to past a tile of the kernel.
* The kernel's arithmetic and indexing (``csrc/encode.cu``), which runs
  only on the card, as a numpy model that follows it step by step: the
  wrapper's segment plan, the staged words of 2-bit bases and bad bits,
  each thread's windows, the funnel shift and the bit-reversed reverse
  complement, and the counts each segment adds. The model must give the
  plain version's keys, every key written once, and the plain totals.
* ``kernels/encode.py`` imports with no ``nvcc`` or card and raises on
  what the kernel does not take.
* The engine's ``n_bases_ingested`` and ``n_kmers_ingested``, read from
  the device totals at ``consolidate()``, against host recounts.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkmer_tpu.ops import encoding as jax_encoding
from sharkmer_tpu_torch import engine as engine_module
from sharkmer_tpu_torch.engine import COUNT_SPANS, CountingEngine
from sharkmer_tpu_torch.kernels import build
from sharkmer_tpu_torch.kernels import encode as encode_kernel
from sharkmer_tpu_torch.ops import encoding
from sharkmer_tpu_torch.ops.keys import SENTINEL, keys_to_numpy
from sharkmer_tpu_torch.utils import phases

U64 = np.uint64
PAIR_LOW = U64(0x5555_5555_5555_5555)
THREADS = 256  # csrc/encode.cu's kThreads


def batch(n, width, seed, n_rate=0.02):
    """Codes with N runs and ragged pad tails."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, width), dtype=np.uint8)
    codes[rng.random((n, width)) < n_rate] = encoding.CODE_N
    if width > 4:  # a run of Ns in some rows
        rows = rng.random(n) < 0.2
        start = rng.integers(0, width - 3, size=n)
        for r in np.flatnonzero(rows):
            codes[r, start[r]:start[r] + 3] = encoding.CODE_N
    lens = rng.integers(max(width // 2, 0), width + 1, size=n)
    codes[np.arange(width)[None, :] >= lens[:, None]] = encoding.CODE_PAD
    return codes


def host_kmers(codes, k) -> int:
    """Windows of k codes that are all bases, counted on the host."""
    bad = np.concatenate([np.zeros((codes.shape[0], 1), np.int64),
                          np.cumsum(codes >= encoding.CODE_N, axis=1)],
                         axis=1)
    if codes.shape[1] < k:
        return 0
    return int(np.sum(bad[:, k:] - bad[:, :-k] == 0))


# k and width: widths 32 and 33 (a word of 16 codes and one past),
# narrower than k, the loader's 160, a whole row of one block (4096)
SHAPES = [(1, 1), (1, 33), (17, 8), (17, 32), (17, 160), (19, 18),
          (19, 160), (21, 33), (25, 24), (25, 4096), (27, 32), (31, 30),
          (31, 33), (31, 160)]


@pytest.mark.parametrize("k,width", SHAPES)
def test_plain_encode_and_totals_match_jax(k, width):
    codes = batch(37, width, seed=k * 1000 + width)
    want_k, want_v = jax_encoding.canonical_kmers(jnp.asarray(codes), k)
    want_keys = np.asarray(want_k).reshape(-1)
    got_k, got_v = encoding.canonical_kmers_plain(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(keys_to_numpy(got_k.reshape(-1)),
                                  want_keys)
    keys = encoding.canonical_kmers(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(keys_to_numpy(keys.reshape(-1)),
                                  want_keys)
    totals = torch.tensor([5, 7], dtype=torch.int64)  # adds to what is there
    keys = encoding.canonical_kmers(torch.from_numpy(codes), k, totals)
    np.testing.assert_array_equal(keys_to_numpy(keys.reshape(-1)),
                                  want_keys)
    assert totals.tolist() == [5 + int(np.asarray(want_v).sum()),
                               7 + int(np.sum(codes < encoding.CODE_N))]
    assert totals[0] - 5 == host_kmers(codes, k)


# -- a numpy model of csrc/encode.cu ----------------------------------------

_BYTE_REV = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)],
                     np.uint8)


def brev64(x):
    """``__brevll``: the 64 bits of each word in reverse order."""
    b = _BYTE_REV[x.astype(U64).view(np.uint8).reshape(-1, 8)][:, ::-1]
    return np.ascontiguousarray(b).view(U64).reshape(x.shape)


def funnel_l(lo, hi, shift):
    """``__funnelshift_l(lo, hi, shift)``, shift < 32."""
    return (((hi << U64(32)) | lo) << shift.astype(U64) >> U64(32)) \
        & U64(0xFFFF_FFFF)


def kernel_model(codes, k):
    """What the kernel writes and adds for ``codes`` at ``k``, block by
    block and thread by thread: (keys, writes of each key, k-mers,
    bases)."""
    n, width = codes.shape
    p = encode_kernel.plan(width, k)
    w = width - k + 1
    keys = np.zeros(n * max(w, 0), np.int64)
    writes = np.zeros(n * max(w, 0), np.int64)
    n_segs = n * p.n_tiles
    n_kmers = n_bases = 0
    m = np.arange(16)
    for block in range(-(-n_segs // p.seg_per_block)):  # the C launch's
        s0 = block * p.seg_per_block
        n_here = min(p.seg_per_block, n_segs - s0)
        assert n_here > 0
        # 1. stage
        g = np.arange(n_here * p.slot_words)
        i = g // p.slot_words
        first = (g - i * p.slot_words) * 16
        s = s0 + i
        row, t = s // p.n_tiles, s % p.n_tiles
        c0 = t * p.tile
        seg_codes = np.minimum(p.tile + k - 1, width - c0)
        own = np.where(t == p.n_tiles - 1, width - c0, p.tile)
        here = np.clip(seg_codes - first, 0, 16)
        col = c0[:, None] + first[:, None] + m
        inside = m < here[:, None]
        assert (col[inside] < width).all()
        c = np.where(inside, codes[row[:, None], np.minimum(col, width - 1)],
                     4).astype(U64)
        packed = ((c & U64(3)) << (30 - 2 * m).astype(U64)).sum(axis=1,
                                                                dtype=U64)
        bad = ((c >= 4).astype(U64) << (15 - m).astype(U64)).sum(axis=1,
                                                                 dtype=U64)
        own_n = np.clip(own - first, 0, 16)
        own_mask = (0xFFFF << (16 - own_n)) & 0xFFFF
        n_bases += sum(bin(int(x)).count("1")
                       for x in (~bad & U64(0xFFFF)) & own_mask.astype(U64))
        # 2. keys, each thread's loop as the kernel runs it
        if p.tile == 0:
            continue
        row0, t0 = s0 // p.n_tiles, s0 % p.n_tiles
        n_out = (min(p.tile, w - t0 * p.tile) if p.seg_per_block == 1
                 else n_here * p.tile)
        assert p.seg_per_block == 1 or p.n_tiles == 1
        base = row0 * w + t0 * p.tile
        di, dj = THREADS // p.tile, THREADS % p.tile
        tid = np.arange(THREADS)
        ti, tj = tid // p.tile, tid % p.tile
        for o0 in range(0, n_out, THREADS):
            o = o0 + tid
            live = o < n_out
            oi, oj, o = ti[live], tj[live], o[live]
            word = oi * p.slot_words + (oj >> 4)
            assert ((oj >> 4) + 2 < p.slot_words).all()  # in its slot
            off = (oj & 15).astype(U64)
            p0, p1, p2 = packed[word], packed[word + 1], packed[word + 2]
            x = (funnel_l(p1, p0, 2 * off) << U64(32)) | funnel_l(p2, p1,
                                                                 2 * off)
            v = ((bad[word] << U64(48)) | (bad[word + 1] << U64(32))
                 | (bad[word + 2] << U64(16)))
            ok = ((v << off) >> U64(64 - k)) == 0
            fwd = x >> U64(64 - 2 * k)
            r = brev64(~x)
            r = ((r >> U64(1)) & PAIR_LOW) | ((r & PAIR_LOW) << U64(1))
            rev = r & U64((1 << (2 * k)) - 1)
            key = np.where(ok, np.minimum(fwd, rev), U64(SENTINEL))
            keys[base + o] = key.astype(np.int64)
            writes[base + o] += 1
            n_kmers += int(ok.sum())
            ti, tj = ti + di, tj + dj
            wrap = tj >= p.tile
            tj[wrap] -= p.tile
            ti[wrap] += 1
    return keys.reshape(n, max(w, 0)), writes, n_kmers, n_bases


# (rows, width, k): the main path's width and several rows a block; 32
# and 33 codes; a batch narrower than k; a whole row of one block; rows
# past one block's codes, in two and three tiles that overlap by k - 1
# (one a single long read); width 1 at k = 1, past the shared-memory cap
MODEL_SHAPES = [(300, 160, 19), (70, 32, 31), (90, 33, 17), (40, 18, 19),
                (3, 4096, 21), (1, 9000, 25), (2, 8200, 31), (2, 4097, 1),
                (3000, 1, 1), (400, 40, 1)]


@pytest.mark.parametrize("n,width,k", MODEL_SHAPES)
def test_kernel_model_matches_plain(n, width, k):
    codes = batch(n, width, seed=n + width + k)
    if width > 1000:  # N runs across the tiles' seams
        codes[:, encode_kernel.LONG_TILE - 3:encode_kernel.LONG_TILE + 2] = 4
    want_k, want_v = encoding.canonical_kmers_plain(torch.from_numpy(codes),
                                                    k)
    keys, writes, n_kmers, n_bases = kernel_model(codes, k)
    assert (writes == 1).all()  # every key once, none twice
    np.testing.assert_array_equal(keys, want_k.numpy())
    assert n_kmers == int(want_v.sum()) == host_kmers(codes, k)
    assert n_bases == int(np.sum(codes < encoding.CODE_N))


@pytest.mark.parametrize("width,k", [(w, k) for _n, w, k in MODEL_SHAPES])
def test_plan_fits_the_kernel(width, k):
    p = encode_kernel.plan(width, k)
    w = width - k + 1
    # the C launch's dynamic shared memory: two words a slot word
    assert 2 * 4 * p.seg_per_block * p.slot_words <= encode_kernel.SMEM_CAP
    assert p.seg_per_block == 1 or p.n_tiles == 1
    if w > 0:
        assert p.n_tiles * p.tile >= w > (p.n_tiles - 1) * p.tile
        # a segment's codes fit the block's budget and its slot
        assert min(p.tile + k - 1, width) <= encode_kernel.BUDGET
        assert 16 * p.slot_words >= min(p.tile + k - 1, width)
    if (width, k) == (160, 19):  # the main path: 5243 blocks of 2200 B
        assert p == (142, 1, 25, 11)


# -- the wrapper without a card ----------------------------------------------


def test_wrapper_imports_without_nvcc_and_raises(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper built or loaded a kernel")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "nvcc", refuse)
    codes = torch.zeros((4, 160), dtype=torch.uint8)
    totals = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(TypeError, match="uint8"):
        encode_kernel.encode(codes.to(torch.int64), 19)
    with pytest.raises(ValueError, match="contiguous"):
        encode_kernel.encode(codes.reshape(-1), 19)
    with pytest.raises(ValueError, match="contiguous"):
        encode_kernel.encode(codes.reshape(2, 2, 160), 19)
    with pytest.raises(ValueError, match="contiguous"):
        encode_kernel.encode(torch.zeros((160, 4), dtype=torch.uint8).T, 19)
    for k in (0, 32):
        with pytest.raises(ValueError, match="k must be"):
            encode_kernel.encode(codes, k)
    with pytest.raises(TypeError, match="totals"):
        encode_kernel.encode(codes, 19, totals.to(torch.int32))
    with pytest.raises(TypeError, match="totals"):
        encode_kernel.encode(codes, 19, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="totals"):
        encode_kernel.encode(codes, 19,
                             torch.zeros((2, 2), dtype=torch.int64)[:, 0])
    with pytest.raises(ValueError, match="not a CUDA device"):
        encode_kernel.encode(codes, 19, totals)
    assert encode_kernel.encode.launches == 0
    # the CPU path runs the plain version, never the wrapper
    keys = encoding.canonical_kmers(codes, 19, totals)
    assert keys.shape == (4, 142) and totals.tolist() == [4 * 142, 4 * 160]
    assert encode_kernel.encode.launches == 0


# -- the engine's device totals ------------------------------------------------

K = 17


def engine_batches(n_batches, rows=500, width=64, seed=11):
    rng = np.random.default_rng(seed)
    return [batch(rows, width, seed=int(rng.integers(1 << 30)))
            for _ in range(n_batches)]


@pytest.mark.parametrize("backend", ["sorted", "hash"])
@pytest.mark.parametrize("case", ["chunks0", "chunks1", "chunks3",
                                  "max_reads", "bytes", "bytes_groups"])
def test_engine_totals_are_host_recounts(backend, case, monkeypatch):
    if case == "bytes_groups":  # ingest() encodes groups itself, outside
        # ingest.batch, before consolidate() takes the rest
        monkeypatch.setattr(engine_module, "DEVICE_BATCH_READS", 400)
    engine = CountingEngine(k=K, device="cpu", backend=backend,
                            n_chunks=3 if case == "chunks3" else
                            0 if case == "chunks0" else 1,
                            initial_capacity=1 << 12)
    batches = engine_batches(3)
    if case.startswith("bytes"):
        seqs = ["".join("ACGTN"[c] for c in row if c < 5).encode()
                for codes in batches for row in codes]
        engine.ingest(iter(seqs))
        ingested = [np.frombuffer(s, np.uint8) for s in seqs]
        bases = sum(int(np.sum(s != ord("N"))) for s in ingested)
        kmers = sum(host_kmers(encoding.ascii_to_codes(s)[None, :], K)
                    for s in seqs)
    else:
        max_reads = 1234 if case == "max_reads" else 0  # cuts batch 3
        for codes in batches:
            lens = np.sum(codes < encoding.CODE_PAD, axis=1)
            if engine.ingest_code_batch(codes, lens, max_reads):
                break
        codes = np.concatenate(batches)[:max_reads or None]
        bases = int(np.sum(codes < encoding.CODE_N))
        kmers = host_kmers(codes, K)
    assert engine.stats.n_bases_ingested == 0  # not read before consolidate
    engine.consolidate()
    record = phases.current()
    assert engine.stats.n_bases_ingested == bases
    assert engine.stats.n_kmers_ingested == kmers == engine.table.n_total()
    assert record.sites("consolidate")["kmers.total"][0] == 1
    encodes = record.counter("encode.kernel")
    assert encodes == record.total("ingest.encode").calls >= 1
    if case in ("chunks0", "chunks1", "max_reads"):
        assert encodes == record.total("ingest.batch").calls  # one a batch
    # the count trace line names the counter beside the spans
    assert re.search(rf"\bencode\.kernel {encodes}[,;]",
                     record.describe(*COUNT_SPANS))
