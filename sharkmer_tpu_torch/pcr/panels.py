"""Panel loading: built-in panels, panel files, panel URLs.

Reference: upstream sharkmer src/pcr/preconfigured.rs. Panels are schema
v2 YAML (see schemas/panel/v2.json): name, schema_version,
panel_version, clade, maintainers, changelog, references, validation.
Unknown fields are rejected at both panel and primer level
(deny_unknown_fields). Gene names derive as
``{gene}[-{region}][_{index}]`` and are prefixed with the panel name
(or gene_prefix) in output files.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import yaml

from .params import PCRParams

log = logging.getLogger("sharkmer")

MAX_PANEL_YAML_BYTES = 10 * 1024 * 1024

_PANEL_FIELDS = {
    "name", "schema_version", "panel_version", "description", "clade",
    "taxon_id", "gene_prefix", "status", "source_url", "license", "citation",
    "notes", "$schema", "maintainers", "changelog", "primers", "references",
    "validation",
}

_PANELS_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "panels")

BUILTIN_PANEL_NAMES = [
    "angiospermae", "bacteria", "c_elegans", "cnidaria", "human",
    "hydrozoa", "insecta", "metazoa", "teleostei",
]


@dataclass
class PanelFile:
    name: str
    description: str = ""
    schema_version: str | None = None
    panel_version: str | None = None
    clade: str | None = None
    gene_prefix: str | None = None
    status: str | None = None
    primers: list[PCRParams] = field(default_factory=list)
    raw: dict = field(default_factory=dict)


def parse_panel_yaml(yaml_str: str) -> PanelFile:
    try:
        d = yaml.safe_load(yaml_str)
    except yaml.YAMLError as e:
        raise ValueError(f"Failed to parse panel YAML: {e}") from e
    if not isinstance(d, dict):
        raise ValueError("Failed to parse panel YAML: not a mapping")
    unknown = set(d) - _PANEL_FIELDS
    if unknown:
        raise ValueError(f"Unknown panel field(s): {sorted(unknown)}")
    for required in ("name", "description", "primers"):
        if required not in d:
            raise ValueError(f"Panel YAML missing required field '{required}'")
    primers = [
        PCRParams.from_yaml_dict(p, context=f" in panel '{d['name']}'")
        for p in d["primers"]
    ]
    sv = d.get("schema_version")
    return PanelFile(
        name=str(d["name"]),
        description=str(d["description"]),
        schema_version=str(sv) if sv is not None else None,
        panel_version=(
            str(d["panel_version"]) if d.get("panel_version") is not None else None
        ),
        clade=d.get("clade"),
        gene_prefix=d.get("gene_prefix"),
        status=d.get("status"),
        primers=primers,
        raw=d,
    )


def derive_gene_name(gene: str, region: str | None, index: int | None) -> str:
    """{gene}[-{region}][_{index}] (preconfigured.rs:172-179)."""
    name = gene
    if region is not None:
        name = f"{gene}-{region}"
    if index is not None:
        name = f"{name}_{index}"
    return name


def validate_gene_chars(gene: str, has_region: bool) -> None:
    """preconfigured.rs:187-203."""
    if "_" in gene:
        raise ValueError(
            f"gene '{gene}' must not contain '_' (reserved as index "
            f"delimiter in output names)."
        )
    if has_region and "-" in gene:
        raise ValueError(
            f"gene '{gene}' must not contain '-' when a `region` is also "
            f"set, because the derived output name `{{gene}}-{{region}}` "
            f"would be ambiguous."
        )


def validate_region_chars(region: str) -> None:
    if "_" in region:
        raise ValueError(
            f"region '{region}' must not contain '_' (reserved as index "
            f"delimiter in output names)."
        )


def validate_primer_uniqueness(primers: list[PCRParams], panel_name: str) -> None:
    seen: dict[tuple, int] = {}
    for i, p in enumerate(primers):
        if p.gene is not None:
            key = (p.gene, p.region, p.index)
            if key in seen:
                raise ValueError(
                    f"Panel '{panel_name}': duplicate primer entries for "
                    f"(gene={key[0]!r}, region={key[1]!r}, index={key[2]!r}) "
                    f"at positions {seen[key]} and {i}. Add an `index:` "
                    f"field to distinguish them."
                )
            seen[key] = i


def resolve_primer_gene_names(primers: list[PCRParams], panel_name: str) -> None:
    for p in primers:
        if p.gene is not None:
            validate_gene_chars(p.gene, p.region is not None)
        if p.region is not None:
            validate_region_chars(p.region)
    validate_primer_uniqueness(primers, panel_name)
    for p in primers:
        if p.gene is not None:
            p.gene_name = derive_gene_name(p.gene, p.region, p.index)


def require_clade_for_v2(panel: PanelFile, source: str) -> None:
    if panel.schema_version == "2" and panel.clade is None:
        raise ValueError(
            f"Panel '{panel.name}' from {source} declares schema_version: "
            f'"2" but is missing the required `clade` field.'
        )


def log_panel_version(panel: PanelFile, source: str) -> None:
    if panel.status == "deprecated":
        log.warning(
            "Panel '%s' from %s has status 'deprecated'. Consider switching "
            "to a newer panel.", panel.name, source,
        )
    if panel.panel_version:
        log.info(
            "Loaded panel '%s' v%s from %s (%d primer pair(s))",
            panel.name, panel.panel_version, source, len(panel.primers),
        )
    else:
        log.warning(
            "Panel '%s' from %s has no `panel_version` field. Versioning is "
            "recommended for reproducibility.", panel.name, source,
        )


def filter_deprecated_primers(
    primers: list[PCRParams], panel_name: str
) -> list[PCRParams]:
    active = []
    for p in primers:
        if p.deprecated:
            msg = (
                f"Panel '{panel_name}': skipping deprecated primer "
                f"'{p.gene_name}'."
            )
            if p.deprecated_by:
                msg += f" Use '{p.deprecated_by}' instead."
            if p.deprecated_reason:
                msg += f" Reason: {p.deprecated_reason}"
            log.warning(msg)
        else:
            active.append(p)
    return active


def _finalize(panel: PanelFile, source: str) -> list[PCRParams]:
    log_panel_version(panel, source)
    require_clade_for_v2(panel, source)
    resolve_primer_gene_names(panel.primers, panel.name)
    prefix = panel.gene_prefix or panel.name
    for p in panel.primers:
        p.gene_name = f"{prefix}_{p.gene_name}"
    return filter_deprecated_primers(panel.primers, panel.name)


def is_url(source: str) -> bool:
    return source.startswith("http://") or source.startswith("https://")


def load_panel_file(path: str) -> list[PCRParams]:
    with open(path) as f:
        yaml_str = f.read()
    panel = parse_panel_yaml(yaml_str)
    return _finalize(panel, path)


def load_panel_url(url: str) -> list[PCRParams]:
    import urllib.request

    log.info("Downloading primer panel from %s", url)
    req = urllib.request.Request(url, headers={"User-Agent": "sharkmer-tpu"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        data = resp.read(MAX_PANEL_YAML_BYTES + 1)
    if len(data) > MAX_PANEL_YAML_BYTES:
        raise ValueError(
            f"Panel YAML at {url} exceeds maximum size of "
            f"{MAX_PANEL_YAML_BYTES} bytes"
        )
    panel = parse_panel_yaml(data.decode())
    return _finalize(panel, url)


def load_panel_source(source: str) -> list[PCRParams]:
    if is_url(source):
        return load_panel_url(source)
    return load_panel_file(source)


def _builtin_panel_path(name: str) -> str:
    return os.path.join(_PANELS_DIR, f"{name}.yaml")


def get_builtin_panels() -> list[PanelFile]:
    panels = []
    for name in BUILTIN_PANEL_NAMES:
        with open(_builtin_panel_path(name)) as f:
            panels.append(parse_panel_yaml(f.read()))
    panels.sort(key=lambda p: p.name)
    return panels


def get_panel(panel_name: str) -> list[PCRParams]:
    if panel_name not in BUILTIN_PANEL_NAMES:
        raise ValueError(
            f"Unknown panel '{panel_name}'. Available panels: "
            f"{', '.join(sorted(BUILTIN_PANEL_NAMES))}"
        )
    with open(_builtin_panel_path(panel_name)) as f:
        panel = parse_panel_yaml(f.read())
    return _finalize(panel, f"built-in panel '{panel_name}'")


def export_panel_yaml(panel_name: str) -> str:
    if panel_name not in BUILTIN_PANEL_NAMES:
        raise ValueError(
            f"Unknown panel '{panel_name}'. Available panels: "
            f"{', '.join(sorted(BUILTIN_PANEL_NAMES))}"
        )
    with open(_builtin_panel_path(panel_name)) as f:
        return f.read()


def print_pcr_panels() -> None:
    panels = get_builtin_panels()
    print("Available PCR panels (use --export-panel <name> for details):\n")
    for panel in panels:
        n = len(panel.primers)
        noun = "primer" if n == 1 else "primers"
        version = panel.panel_version or "unversioned"
        print(f"  {panel.name:<16} v{version:<8} {panel.description} ({n} {noun})")
