"""The counting engine: stream reads -> device count table -> spectra.

Torch port of ``sharkmer_tpu.engine`` on one device (``device``), with
the sorted backend (``ops/sorted_store.py``) or the hash backend
(``ops/hashtable.py``), each also sharded by owner over ``n_shards``
shards placed on a list of devices (``devices``, by default
``device.shard_devices``; ``parallel/``): the same round-robin chunk
routing, per-chunk tables, in-order consolidation and
count-conservation invariants.

Pipeline parity with the reference
(upstream sharkmer src/io.rs:366-595, 977-1161):

* Reads are assigned to incremental chunks round-robin in batches of
  1000 (io.rs:355-361).
* ``chunks == 0`` skips histograms ("plain merge" mode) but still
  counts into one internal chunk (io.rs:377-379).
* Consolidation processes chunks in order; after each chunk the
  running histogram is snapshotted (io.rs:1016-1027). The final
  histogram equals the single-pass histogram regardless of chunk count
  (chunk invariance, tests/spcr_18s.rs:438-528).
* Run invariants are asserted: total hashed count == k-mers ingested
  (io.rs:1042-1047), histogram totals match the table
  (io.rs:1120-1132).

Device shape: the reference merges per-chunk CPU hash maps into a
master map one entry at a time; here "merging chunk j" concatenates
chunk j's sorted runs onto the master and re-aggregates — the
per-chunk snapshot is a clipped bincount over the merged counts.
Chunked ingest STREAMS: each chunk
owns its own device table fed as reads arrive (host holds at most
``CHUNK_PENDING_READS`` reads per chunk, independent of the total read
count — reference parity with io.rs:355-361, which streams into
per-chunk tables), and consolidation folds the chunk tables into the
master in chunk order via ``merge_from``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Iterable, Iterator

import numpy as np
import torch

from .device import indexed, shard_devices
from .ops import encoding
from .ops.hashtable import KmerTable
from .ops.sorted_store import SortedKmerStore, _default_max_agg, _next_pow2
from .parallel.sharded_table import ShardedKmerTable
from .parallel.sorted_sharded import ShardedSortedStore
from .utils import phases

log = logging.getLogger("sharkmer")

N_READS_PER_BATCH = 1000  # round-robin chunk assignment granularity
DEVICE_BATCH_READS = 1 << 16  # reads per device ingest call
CHUNK_PENDING_READS = 1 << 13  # host-buffered reads per chunk (chunked mode)
WIDTH_BUCKET = 32  # read widths are padded up to a multiple of this
# the count stage's outermost spans (the CLI's ``count trace:`` line)
COUNT_SPANS = ("engine.create", "ingest.batch", "consolidate")


@dataclass
class IngestStats:
    n_reads_read: int = 0
    n_bases_read: int = 0
    n_reads_ingested: int = 0
    # valid (non-N) bases and k-mers: counted on the device, filled in by
    # consolidate() (its one read of the totals), so read after it
    n_bases_ingested: int = 0
    n_kmers_ingested: int = 0


@dataclass
class CountingEngine:
    k: int
    device: torch.device
    n_chunks: int = 0
    histo_max: int = 10000
    initial_capacity: int = 1 << 20  # the hash backend's first table
    n_shards: int = 1  # >1: the table sharded by owner (parallel/)
    # the devices of the shards (n_shards > 1; default shard_devices), or
    # [device]
    devices: list | None = None
    backend: str = "sorted"  # "sorted" (sort/scan runs) | "hash" (probe table)
    table: object = field(init=False)  # a store of ops/ or parallel/
    stats: IngestStats = field(init=False)
    _chunk_tables: list = field(init=False)
    _chunk_pending: list[list] = field(init=False)
    _pending_reads: list[int] = field(init=False)
    _stream_buffer: list[bytes] = field(init=False)
    # device int64 [2]: the valid k-mers and bases ingested
    _totals_dev: object = field(init=False, default=None)

    def __post_init__(self):
        phases.begin()  # one engine, one run record
        with phases.span("engine.create"):
            self._create()

    def _create(self):
        self.device = torch.device(self.device)
        if self.n_shards > 1:
            # as the JAX package shards over the devices that exist; the
            # results depend neither on the shard count nor on the
            # placement
            self.devices = [indexed(d) for d in self.devices or
                            shard_devices(self.n_shards, self.device)]
            local = max(1 << 10, self.initial_capacity // self.n_shards)
            self.table = self._sharded_table(1 << (local - 1).bit_length())
        else:
            self.devices = [self.device]
            if self.backend == "hash":
                self.table = KmerTable.create(self.k, self.initial_capacity,
                                              self.device)
            else:
                self.table = SortedKmerStore(self.k, self.device)
        self.stats = IngestStats()
        n = max(self.n_chunks, 1)
        self._chunk_tables = [None] * n
        self._chunk_pending = [[] for _ in range(n)]
        self._pending_reads = [0] * n
        self._stream_buffer = []

    # -- ingest -------------------------------------------------------------

    @property
    def _buffering(self) -> bool:
        # Per-chunk snapshots need chunk-ordered consolidation, so reads
        # stream into PER-CHUNK device tables when more than one chunk
        # exists (merged into the master, in order, at consolidate).
        return max(self.n_chunks, 1) > 1

    def _chunk_table(self, c: int):
        """The chunk's own device table (lazily created, reduced size so
        n_chunks tables fit the same footprint as one master)."""
        if self._chunk_tables[c] is None:
            n = max(self.n_chunks, 1)
            if self.n_shards > 1:
                local = max(1 << 8, (self.initial_capacity // self.n_shards) // n)
                self._chunk_tables[c] = self._sharded_table(
                    1 << (local - 1).bit_length())
            elif self.backend == "hash":
                cap = 1 << max(12, (self.initial_capacity // n - 1).bit_length())
                self._chunk_tables[c] = KmerTable.create(self.k, cap,
                                                         self.device)
            else:
                # each chunk's raw buffer gets a fair share of the drain
                # budget so all chunk buffers together cost one master's
                agg = _next_pow2(max(1 << 16,
                                     _default_max_agg(self.device) // n))
                self._chunk_tables[c] = SortedKmerStore(
                    self.k, self.device, max_agg=agg
                )
        return self._chunk_tables[c]

    def _sharded_table(self, local_capacity: int):
        """An empty sharded table of the engine's backend."""
        cls = (ShardedKmerTable if self.backend == "hash"
               else ShardedSortedStore)
        return cls.create(self.k, self.n_shards, local_capacity,
                          devices=self.devices)

    def _push_pending(self, c: int, item, n_reads: int) -> None:
        """Queue reads for chunk c; flush to its device table at the cap
        (host RAM stays bounded at n_chunks x CHUNK_PENDING_READS reads
        regardless of the total read count)."""
        self._chunk_pending[c].append(item)
        self._pending_reads[c] += n_reads
        if self._pending_reads[c] >= CHUNK_PENDING_READS:
            self._flush_pending(c)

    def _flush_pending(self, c: int) -> None:
        if not self._chunk_pending[c]:
            return
        seqs = self._chunk_pending[c]
        self._chunk_pending[c] = []
        self._pending_reads[c] = 0
        self._chunk_tables[c] = self._ingest_seqs(seqs, self._chunk_table(c))

    def ingest(self, sequences: Iterator[bytes], max_reads: int = 0) -> bool:
        """Consume sequences (ASCII bytes). Returns True if max_reads hit."""
        n_chunks = max(self.n_chunks, 1)
        for seq in sequences:
            batch_idx = self.stats.n_reads_read // N_READS_PER_BATCH
            chunk_id = batch_idx % n_chunks
            self.stats.n_reads_read += 1
            self.stats.n_bases_read += len(seq)
            if self._buffering:
                self._push_pending(chunk_id, seq, 1)
            else:
                self._stream_buffer.append(seq)
                if len(self._stream_buffer) >= DEVICE_BATCH_READS:
                    self.table = self._ingest_seqs(self._stream_buffer, self.table)
                    self._stream_buffer = []
            if max_reads > 0 and self.stats.n_reads_read >= max_reads:
                return True
        return False

    def ingest_code_batch(self, codes: np.ndarray, lens: np.ndarray,
                          max_reads: int = 0) -> bool:
        """Consume a pre-encoded [n, width] uint8 batch (native loader
        path). Returns True when max_reads is reached."""
        with phases.span("ingest.batch"):
            return self._ingest_code_batch(codes, lens, max_reads)

    def _ingest_code_batch(self, codes, lens, max_reads: int) -> bool:
        n_chunks = max(self.n_chunks, 1)
        n = codes.shape[0]
        if max_reads > 0:
            n = min(n, max_reads - self.stats.n_reads_read)
            if n <= 0:
                return True
            codes, lens = codes[:n], lens[:n]
        start = self.stats.n_reads_read
        self.stats.n_reads_read += n
        if self._buffering:
            with phases.span("ingest.host"):
                self.stats.n_bases_read += int(lens.sum())
                chunk_ids = ((np.arange(start, start + n) // N_READS_PER_BATCH)
                             % n_chunks)
            for c in np.unique(chunk_ids):
                with phases.span("ingest.host"):
                    rows = codes[chunk_ids == c]
                self._push_pending(int(c), rows, rows.shape[0])
        else:
            with phases.span("ingest.host"):
                self.stats.n_bases_read += int(lens.sum())
            self.table = self._ingest_codes_array(codes, self.table)
        return max_reads > 0 and self.stats.n_reads_read >= max_reads

    def _ingest_codes_array(self, codes: np.ndarray, table):
        """Insert the canonical k-mers of an encoded batch into `table`
        (returned updated; run stats accumulate on the engine)."""
        if codes.shape[0] == 0:
            return table
        n_rows = codes.shape[0]
        # a pageable copy: it waits for the stream
        with phases.span("ingest.upload"), phases.sync("codes.upload"):
            codes_dev = torch.from_numpy(
                np.ascontiguousarray(codes)).to(self.device)
        with phases.span("ingest.encode"):
            # the valid k-mers and bases accumulate ON DEVICE, in the
            # encode's one pass: reading a per-batch count on the host
            # would wait for the device every batch
            if self._totals_dev is None:
                self._totals_dev = torch.zeros(2, dtype=torch.int64,
                                               device=self.device)
            kmers = encoding.canonical_kmers(codes_dev, self.k,
                                             self._totals_dev)
            phases.count("encode.kernel")  # one kernel launch on the card
        with phases.span("ingest.insert"):
            table = table.insert_kmers(kmers.reshape(-1))
        self.stats.n_reads_ingested += n_rows
        return table

    def _ingest_seqs(self, seqs: list, table):
        """Encode a group of reads (bytes or pre-encoded arrays) and
        insert their canonical k-mers into `table` (returned updated)."""
        raw = [s for s in seqs if isinstance(s, (bytes, bytearray))]
        for batch in _width_batches(raw):
            table = self._ingest_codes_array(_encode_batch(batch), table)
        for item in seqs:
            if not isinstance(item, (bytes, bytearray)):
                table = self._ingest_codes_array(item, table)
        return table

    # -- consolidate ---------------------------------------------------------

    def consolidate(self) -> list[np.ndarray] | None:
        """Finish ingestion; returns per-chunk histogram snapshots (or None
        when chunks == 0). Asserts the reference's count-conservation
        invariants."""
        with phases.span("consolidate"):
            return self._consolidate()

    def _spectrum(self) -> np.ndarray:
        with phases.span("consolidate.spectrum"):
            return self.table.histogram(self.histo_max)

    def _consolidate(self) -> list[np.ndarray] | None:
        histo_vecs: list[np.ndarray] | None = None
        if self._buffering:
            histo_vecs = []
            for chunk_id in range(max(self.n_chunks, 1)):
                self._flush_pending(chunk_id)
                if self._chunk_tables[chunk_id] is not None:
                    self.table = self.table.merge_from(
                        self._chunk_tables[chunk_id]
                    )
                    self._chunk_tables[chunk_id] = None  # free device memory
                histo_vecs.append(self._spectrum())
        else:
            if self._stream_buffer:
                self.table = self._ingest_seqs(self._stream_buffer, self.table)
                self._stream_buffer = []
            if self.n_chunks > 0:  # chunks == 1: one snapshot
                histo_vecs = [self._spectrum()]

        # materialize the device-side totals (one sync per run)
        if self._totals_dev is not None:
            with phases.sync("kmers.total"):
                n_kmers, n_bases = self._totals_dev.tolist()
            self.stats.n_kmers_ingested = n_kmers
            self.stats.n_bases_ingested = n_bases
        n_hashed = self.table.n_total()
        if n_hashed != self.stats.n_kmers_ingested:
            raise AssertionError(
                f"The total count of hashed kmers ({n_hashed}) does not equal "
                f"the number of ingested kmers ({self.stats.n_kmers_ingested})"
            )
        if histo_vecs is not None:
            final = histo_vecs[-1]
            n_unique_histo = int(np.sum(final[1:]))
            n_unique_table = self.table.n_unique()
            if n_unique_histo != n_unique_table:
                raise AssertionError(
                    f"The total count of unique kmers in the histogram "
                    f"({n_unique_histo}) does not equal the total count of "
                    f"hashed kmers ({n_unique_table})"
                )
        return histo_vecs

    def n_singletons(self, histo_vecs: list[np.ndarray] | None) -> int | None:
        if not histo_vecs:
            return None
        return int(histo_vecs[-1][1])


def _width_batches(seqs: Iterable[bytes]) -> Iterator[list[bytes]]:
    """Split reads into device batches bucketed by padded width."""
    buckets: dict[int, list[bytes]] = {}
    for seq in seqs:
        w = max(WIDTH_BUCKET, -(-len(seq) // WIDTH_BUCKET) * WIDTH_BUCKET)
        b = buckets.setdefault(w, [])
        b.append(seq)
        if len(b) >= DEVICE_BATCH_READS:
            yield b
            buckets[w] = []
    for b in buckets.values():
        if b:
            yield b


def _encode_batch(seqs: list[bytes]) -> np.ndarray:
    width = max(WIDTH_BUCKET, -(-max(len(s) for s in seqs) // WIDTH_BUCKET) * WIDTH_BUCKET)
    out = np.full((len(seqs), width), encoding.CODE_PAD, dtype=np.uint8)
    for i, s in enumerate(seqs):
        codes = encoding.ascii_to_codes(s)
        out[i, : len(codes)] = codes
    return out
