"""PCR parameter model and validation.

Mirrors ``PCRParams`` and ``validate_pcr_params``
(upstream sharkmer src/pcr/mod.rs:148-399), including the schema-v2
panel fields (gene/region/index, metadata, deprecation) and the
hidden runtime tuning knobs.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

DEFAULT_MAX_DFS_STATES = 100_000
DEFAULT_MAX_PATHS_PER_PAIR = 20
DEFAULT_MAX_NODE_VISITS = 2
DEFAULT_MAX_NUM_PRIMER_KMERS = 40
DEFAULT_HIGH_COVERAGE_RATIO = 10.0
DEFAULT_TIP_COVERAGE_FRACTION = 0.1
DEFAULT_DEDUP_EDIT_THRESHOLD = 10

IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T",
    "R": "AG", "Y": "CT", "S": "GC", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}


def is_valid_nucleotide(c: str) -> bool:
    return c in IUPAC


@dataclass
class PCRParams:
    forward_seq: str = ""
    reverse_seq: str = ""
    min_length: int = 0
    max_length: int = 10000

    # schema v2 target identification
    gene_name: str = ""  # derived; never in YAML
    gene: str | None = None
    region: str | None = None
    index: int | None = None

    # schema v2 target metadata (provenance only)
    compartment: str | None = None
    gene_type: str | None = None
    copy_number: str | None = None

    # deprecation
    deprecated: bool = False
    deprecated_by: str | None = None
    deprecated_reason: str | None = None

    min_count: int = 2
    mismatches: int = 2
    trim: int = 15
    expected_length: int | None = None
    citation: str = ""
    notes: str = ""
    dedup_edit_threshold: int = DEFAULT_DEDUP_EDIT_THRESHOLD
    source: str = ""

    # runtime tuning (CLI-global, mod.rs:228-241)
    max_dfs_states: int = DEFAULT_MAX_DFS_STATES
    max_paths_per_pair: int = DEFAULT_MAX_PATHS_PER_PAIR
    max_node_visits: int = DEFAULT_MAX_NODE_VISITS
    max_primer_kmers: int = DEFAULT_MAX_NUM_PRIMER_KMERS
    high_coverage_ratio: float = DEFAULT_HIGH_COVERAGE_RATIO
    tip_coverage_fraction: float = DEFAULT_TIP_COVERAGE_FRACTION

    _YAML_FIELDS = {
        "forward_seq", "reverse_seq", "min_length", "max_length", "gene",
        "region", "index", "compartment", "gene_type", "copy_number",
        "deprecated", "deprecated_by", "deprecated_reason", "min_count",
        "mismatches", "trim", "expected_length", "citation", "notes",
        "dedup_edit_threshold",
    }

    @classmethod
    def from_yaml_dict(cls, d: dict, context: str = "") -> "PCRParams":
        """Build from a panel YAML primer mapping; deny unknown fields
        (preconfigured.rs uses serde deny_unknown_fields)."""
        unknown = set(d) - cls._YAML_FIELDS
        if unknown:
            raise ValueError(
                f"Unknown primer field(s) {sorted(unknown)}{context}"
            )
        kwargs = {k: v for k, v in d.items() if k in cls._YAML_FIELDS}
        for key in ("forward_seq", "reverse_seq"):
            if key in kwargs and kwargs[key] is not None:
                kwargs[key] = str(kwargs[key])
        return cls(**kwargs)


def validate_pcr_params(params: PCRParams) -> list[tuple[str, str]]:
    """Return (error, suggestion) pairs; empty list = valid (mod.rs:295-399)."""
    errors: list[tuple[str, str]] = []
    if len(params.forward_seq) < 2:
        errors.append((
            f"Forward primer sequence is too short: '{params.forward_seq}'",
            "Primer sequences must be at least 2 bases",
        ))
    if len(params.reverse_seq) < 2:
        errors.append((
            f"Reverse primer sequence is too short: '{params.reverse_seq}'",
            "Primer sequences must be at least 2 bases",
        ))
    for label, seq in [("forward", params.forward_seq), ("reverse", params.reverse_seq)]:
        if len(seq) >= 2:
            invalid = [c for c in seq if not is_valid_nucleotide(c)]
            if invalid:
                errors.append((
                    f"Invalid nucleotide(s) {', '.join(invalid)} in {label} primer {seq}",
                    "Valid characters: A C G T R Y W S M K B D H V N",
                ))
    if params.min_length > params.max_length:
        errors.append((
            f"min-length ({params.min_length}) is greater than max-length "
            f"({params.max_length})",
            "Swap the values or adjust the range",
        ))
    if params.min_count < 2:
        errors.append((
            f"min-count is {params.min_count}, must be at least 2",
            "Set min-count to at least 2",
        ))
    if params.max_length == 0:
        errors.append(("max-length is 0", "Set max-length to a positive value"))
    if not params.gene_name:
        errors.append((
            "Gene name is empty",
            "Provide a unique name for the primer pair via the 'name' field",
        ))
    if params.forward_seq == params.reverse_seq and len(params.forward_seq) >= 2:
        errors.append((
            f"Forward and reverse primers are identical: {params.forward_seq}",
            "Check that forward and reverse sequences are not swapped",
        ))
    return errors
