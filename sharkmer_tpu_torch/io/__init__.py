"""Host-side I/O: FASTQ streaming, ENA access, read cache, output writers."""

from .fastq import (  # noqa: F401
    FastqFormatError,
    N_READS_PER_BATCH,
    open_fastq,
    read_fastq_records,
    read_fastq_paired,
)
