"""Output writers: .histo, .final.histo, FASTA, stats.yaml.

File formats match the reference byte-for-byte where the formats are
defined (upstream sharkmer src/io.rs:1049-1094, io.rs:144-158,
src/stats.rs:186-193):

* ``{sample}.histo``: comment line, ``count\\tchunk_1..chunk_N``
  header, data rows for counts 1..histo_max+1.
* ``{sample}.final.histo``: comment line, ``count\\tfrequency``, rows
  1..histo_max+1.
* FASTA records wrap sequence lines at 80 columns.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence, TextIO

import numpy as np

from .. import __version__

log = logging.getLogger("sharkmer")

FASTA_LINE_WIDTH = 80


def warn_if_exists(path: str) -> None:
    if os.path.exists(path):
        log.warning("Overwriting existing file %s", path)


def histo_comment(k: int, chunks: int) -> str:
    return f"# sharkmer {__version__} k={k} chunks={chunks}"


def write_incremental_histo(
    path: str, histo_vecs: Sequence[np.ndarray], histo_max: int, k: int, chunks: int
) -> None:
    """Multi-column incremental histogram (io.rs:1049-1073)."""
    warn_if_exists(path)
    with open(path, "w") as f:
        f.write(histo_comment(k, chunks) + "\n")
        header = "\t".join(
            ["count"] + [f"chunk_{i + 1}" for i in range(len(histo_vecs))]
        )
        f.write(header + "\n")
        for i in range(1, histo_max + 2):
            row = "\t".join([str(i)] + [str(int(v[i])) for v in histo_vecs])
            f.write(row + "\n")


def write_final_histo(
    path: str, histo_vec: np.ndarray, histo_max: int, k: int, chunks: int
) -> None:
    """Two-column final histogram (io.rs:1079-1094)."""
    warn_if_exists(path)
    with open(path, "w") as f:
        f.write(histo_comment(k, chunks) + "\n")
        f.write("count\tfrequency\n")
        for i in range(1, histo_max + 2):
            f.write(f"{i}\t{int(histo_vec[i])}\n")


def write_fasta_record(f: TextIO, rec_id: str, desc: str | None, seq: str) -> None:
    """80-column wrapped FASTA record (io.rs:144-158)."""
    if desc:
        f.write(f">{rec_id} {desc}\n")
    else:
        f.write(f">{rec_id}\n")
    for i in range(0, len(seq), FASTA_LINE_WIDTH):
        f.write(seq[i : i + FASTA_LINE_WIDTH] + "\n")
