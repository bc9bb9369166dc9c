"""ENA (European Nucleotide Archive) access.

Reference: upstream sharkmer src/io.rs:63-134 — the filereport API
returns a TSV with fastq_ftp URLs (R1 first, then R2) and the
scientific_name used to derive a default sample name.
"""

from __future__ import annotations

import logging
import urllib.request
from dataclasses import dataclass

log = logging.getLogger("sharkmer")

ENA_FILEREPORT = (
    "https://www.ebi.ac.uk/ena/portal/api/filereport?accession={accession}"
    "&result=read_run&fields=run_accession,fastq_ftp,scientific_name"
)


@dataclass
class EnaResult:
    urls: list[str]
    scientific_name: str | None


def get_ena_fastq_urls(accession: str, timeout: float = 30.0) -> EnaResult:
    url = ENA_FILEREPORT.format(accession=accession)
    log.info("Querying ENA for accession %s...", accession)
    req = urllib.request.Request(url, headers={"User-Agent": "sharkmer-tpu"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read().decode()
    return parse_ena_filereport(body, accession)


def parse_ena_filereport(body: str, accession: str) -> EnaResult:
    """Parse the TSV response (header row + data rows)."""
    lines = body.splitlines()
    if len(lines) < 2:
        raise ValueError(
            f"ENA returned no results for accession '{accession}'. Check "
            f"that the accession is valid."
        )
    headers = lines[0].split("\t")
    try:
        ftp_idx = headers.index("fastq_ftp")
    except ValueError:
        raise ValueError("ENA response missing fastq_ftp column") from None
    sci_idx = headers.index("scientific_name") if "scientific_name" in headers else None

    fields = lines[1].split("\t")
    if ftp_idx >= len(fields) or not fields[ftp_idx]:
        raise ValueError(
            f"ENA returned no FASTQ URLs for accession '{accession}'. The "
            f"run may not have public FASTQ files."
        )
    urls = []
    for u in fields[ftp_idx].split(";"):
        if u.startswith("ftp://") or u.startswith("http"):
            urls.append(u)
        else:
            urls.append(f"http://{u}")

    scientific_name = None
    if sci_idx is not None and sci_idx < len(fields):
        name = fields[sci_idx].strip()
        if name:
            scientific_name = name

    log.info(
        "Found %d FASTQ file(s) for %s: %s", len(urls), accession, ", ".join(urls)
    )
    if scientific_name:
        log.info("Scientific name: %s", scientific_name)
    return EnaResult(urls=urls, scientific_name=scientific_name)
