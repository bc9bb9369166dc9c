"""Markdown report generation from result dicts.

Uses the reference's three-position gene score code:
  position 1 — recovery:  `-` not recovered, `+` recovered
  position 2 — reference: `-` no ref for the gene, `+` ref for other
               species only, `*` ref for this species
  position 3 — BLAST:     `-` no same-gene hit, `+` same gene other
               species, `*` same gene same species
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path

SCORE_LEGEND = (
    "**Scoring** — three positions: recovery / reference availability / "
    "BLAST result.\n\n"
    "| code | meaning |\n|---|---|\n"
    "| `---` | not recovered, no references for this gene |\n"
    "| `-*-` | not recovered, reference exists for this species |\n"
    "| `+--` | recovered, no references for this gene |\n"
    "| `++-` | recovered, refs for other species, no same-gene hit |\n"
    "| `+++` | recovered, hit same gene in another species |\n"
    "| `+**` | recovered, confirmed same gene, same species |\n"
)


def gene_score(gene_entry: dict, has_ref_any: bool, has_ref_taxon: bool) -> str:
    recovered = "+" if gene_entry.get("status") == "success" else "-"
    if has_ref_taxon:
        ref = "*"
    elif has_ref_any:
        ref = "+"
    else:
        ref = "-"
    blast = "-"
    b = gene_entry.get("blast")
    if b and b.get("on_target"):
        blast = "*" if b.get("same_taxon") else "+"
    return f"{recovered}{ref}{blast}"


def _reference_index(panel_data: dict) -> dict[str, set[str]]:
    """gene -> set of taxa with references."""
    idx: dict[str, set[str]] = {}
    for ref_gene in panel_data.get("references") or []:
        taxa = idx.setdefault(ref_gene.get("gene"), set())
        for s in ref_gene.get("sequences", []):
            if s.get("taxon"):
                taxa.add(s["taxon"])
    return idx


def generate_report(result: dict, panel_data: dict) -> str:
    """Render a depth-focused markdown report."""
    ref_idx = _reference_index(panel_data)
    prefix = panel_data.get("gene_prefix") or panel_data.get("name", "")
    lines = [
        f"# {result['panel']} v{result['panel_version']} — "
        f"sharkmer-tpu {result['sharkmer_version']}",
        "",
        f"Date: {result.get('date', datetime.now().strftime('%Y-%m-%d'))}  ",
        f"Commit: {result.get('git_commit', 'unknown')}  ",
        f"BLAST mode: {result.get('blast_mode', 'none')}",
        "",
        SCORE_LEGEND,
        "",
    ]
    for sample in result.get("samples", []):
        lines.append(f"## {sample.get('taxon') or sample['accession']} "
                     f"({sample['accession']})")
        lines.append("")
        genes: list[str] = []
        for depth in sample.get("depths", []):
            for g in depth.get("genes", []):
                if g["gene"] not in genes:
                    genes.append(g["gene"])
        header = "| reads | " + " | ".join(genes) + " | wall (s) |"
        sep = "|---" * (len(genes) + 2) + "|"
        lines.append(header)
        lines.append(sep)
        for depth in sample.get("depths", []):
            cells = [f"{depth['max_reads']:,}"]
            by_gene = {g["gene"]: g for g in depth.get("genes", [])}
            for gene in genes:
                g = by_gene.get(gene)
                if g is None:
                    cells.append("—")
                    continue
                base = gene[len(prefix) + 1:] if gene.startswith(f"{prefix}_") else gene
                taxa = ref_idx.get(base, set())
                code = gene_score(
                    g, bool(taxa), sample.get("taxon") in taxa
                )
                detail = ""
                if g.get("status") == "success" and g.get("product_lengths"):
                    detail = f" {g['product_lengths'][0]}bp"
                    b = g.get("blast")
                    if b and b.get("identity") is not None:
                        detail += f" {b['identity'] * 100:.1f}%"
                cells.append(f"`{code}`{detail}")
            cells.append(str(depth.get("wall_time_seconds", "")))
            lines.append("| " + " | ".join(cells) + " |")
        lines.append("")
    return "\n".join(lines) + "\n"


def write_report(result: dict, panel_data: dict, out_path: Path) -> Path:
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(generate_report(result, panel_data))
    return out_path
