"""Streaming FASTQ ingestion (host side).

Mirrors the reference's reader semantics
(upstream sharkmer src/io.rs:161-365):

* 4-line records; the first record is always validated, then every
  ``validate_every``-th (0 = first only).
* FASTA input is detected and rejected with a specific message.
* gzip is auto-detected by extension or magic bytes.
* Reads are batched in groups of ``N_READS_PER_BATCH`` and assigned to
  incremental chunks round-robin per batch (io.rs:355-361).
* Paired mode alternates R1/R2 records and warns on length mismatch
  (io.rs:630-697).

When the native C++ loader (sharkmer_tpu_torch.io.native) is available it is
used for the hot parse+encode loop; this pure-python path is the
reference implementation and the permanent cross-check.
"""

from __future__ import annotations

import gzip
import io
import logging
import os
from typing import BinaryIO, Iterator

log = logging.getLogger("sharkmer")

N_READS_PER_BATCH = 1000


class FastqFormatError(ValueError):
    pass


def open_fastq(path: str | os.PathLike) -> BinaryIO:
    """Open a FASTQ file with gzip auto-detection (io.rs:598-625)."""
    path = os.fspath(path)
    name = path.lower()
    f = open(path, "rb")
    if name.endswith(".gz") or name.endswith(".gzip"):
        return gzip.open(f, "rb")  # type: ignore[return-value]
    magic = f.peek(2)[:2] if hasattr(f, "peek") else b""
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")  # type: ignore[return-value]
    return f


def _validate_record(
    header: bytes, sequence: bytes, separator: bytes, quality: bytes, record_num: int
) -> None:
    """io.rs:161-198."""
    if header.startswith(b">"):
        raise FastqFormatError(
            f"Input appears to be FASTA format, not FASTQ (record "
            f"{record_num + 1} starts with '>'). sharkmer requires FASTQ "
            f"input with quality scores."
        )
    if not header.startswith(b"@"):
        got = chr(header[0]) if header else " "
        raise FastqFormatError(
            f"FASTQ record {record_num + 1} has invalid header "
            f"(expected '@', got '{got}'): {header.decode(errors='replace')}"
        )
    if not separator.startswith(b"+"):
        got = chr(separator[0]) if separator else " "
        raise FastqFormatError(
            f"FASTQ record {record_num + 1} has invalid separator line "
            f"(expected '+', got '{got}'): {separator.decode(errors='replace')}"
        )
    if len(quality) != len(sequence):
        raise FastqFormatError(
            f"FASTQ record {record_num + 1} has mismatched sequence "
            f"({len(sequence)}) and quality ({len(quality)}) lengths"
        )


def read_fastq_records(
    stream: BinaryIO,
    validate_every: int = 0,
    source_name: str = "<stream>",
    start_record: int = 0,
) -> Iterator[bytes]:
    """Yield sequence lines from a FASTQ stream, validating records.

    ``start_record`` continues the global record numbering across
    multiple input files (validation cadence is global, io.rs:321-331).
    """
    text = io.BufferedReader(stream) if not isinstance(stream, io.BufferedReader) else stream
    n = start_record
    while True:
        header = text.readline()
        if not header:
            return
        header = header.rstrip(b"\r\n")
        if n == 0 and header.startswith(b">"):
            # Fail fast on FASTA before demanding 4 lines (a 2-line FASTA
            # would otherwise report a confusing truncation error).
            _validate_record(header, b"", b"+", b"", n)
        sequence = text.readline()
        if not sequence:
            raise FastqFormatError(
                f"Truncated FASTQ record at record {n + 1} in {source_name}: "
                f"missing sequence line"
            )
        sequence = sequence.rstrip(b"\r\n")
        separator = text.readline()
        if not separator:
            raise FastqFormatError(
                f"Truncated FASTQ record at record {n + 1} in {source_name}: "
                f"missing separator line"
            )
        separator = separator.rstrip(b"\r\n")
        quality = text.readline()
        if not quality:
            raise FastqFormatError(
                f"Truncated FASTQ record at record {n + 1} in {source_name}: "
                f"missing quality line"
            )
        quality = quality.rstrip(b"\r\n")

        should_validate = n == 0 or (validate_every > 0 and n % validate_every == 0)
        if should_validate:
            _validate_record(header, sequence, separator, quality, n)
        n += 1
        yield sequence


def read_fastq_paired(
    stream1: BinaryIO,
    stream2: BinaryIO,
    validate_every: int = 0,
    name1: str = "R1",
    name2: str = "R2",
) -> Iterator[bytes]:
    """Alternate records from two FASTQ streams (R1, R2, R1, R2, ...).

    Warns when the inputs have unequal record counts (io.rs:688-694);
    extra records in the longer file are not yielded past the point
    where pairing breaks.
    """
    it1 = read_fastq_records(stream1, validate_every, name1)
    it2 = read_fastq_records(stream2, validate_every, name2, start_record=1)
    r1_records = r2_records = 0
    while True:
        try:
            s1 = next(it1)
        except StopIteration:
            extra = next(it2, None)
            if extra is not None:
                r2_records += 1
                _warn_pair_mismatch(name1, r1_records, name2, r2_records)
            return
        r1_records += 1
        yield s1
        try:
            s2 = next(it2)
        except StopIteration:
            _warn_pair_mismatch(name1, r1_records, name2, r2_records)
            return
        r2_records += 1
        yield s2


def _warn_pair_mismatch(name1: str, n1: int, name2: str, n2: int) -> None:
    if n1 != n2:
        log.warning(
            "Paired-end input length mismatch: %s has %d reads, %s has %d "
            "reads. Extra reads in the longer file were not processed.",
            name1,
            n1,
            name2,
            n2,
        )
