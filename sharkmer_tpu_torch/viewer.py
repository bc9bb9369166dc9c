"""sharkmer-torch-viewer: animated k-mer spectra + genome-size curves.

A copy of ``sharkmer_tpu.viewer`` (numpy and yaml only), kept in the
port because importing it from ``sharkmer_tpu`` pulls in jax; its code
must stay equal to the original's (``tests/test_torch_imports.py``).
It reads the ``{sample}.histo`` incremental histogram that either CLI
writes (comment + header format, or the legacy headerless TSV) and
``{sample}.stats.yaml``, and writes:

* ``{out}.html`` — an animated k-mer spectrum, one frame per chunk,
  with detected peaks/valleys marked (self-contained HTML + SVG +
  vanilla JS; no plotting libraries required).
* ``{out}_genome_size.html`` — heterozygous/homozygous genome-size
  estimates per chunk, from the classic spectrum integral method:
  genome_size = (non-error k-mers) / coverage-peak, halved for the
  heterozygous peak.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import yaml

PEAK_THRESHOLD = 1000
MAX_COVERAGE_PLOTTED = 100


def load_histo(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (counts [rows], histos [rows, n_chunks])."""
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f if l.strip()]
    if lines and lines[0].startswith("#"):
        lines = lines[1:]
    if lines and not lines[0].split("\t")[0].isdigit():
        lines = lines[1:]  # header row
    data = np.array([[int(v) for v in l.split("\t")] for l in lines],
                    dtype=np.float64)
    return data[:, 0], data[:, 1:]


def load_stats(path: str) -> dict:
    if path.endswith((".yaml", ".yml")):
        with open(path) as f:
            return yaml.safe_load(f)
    stats = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) >= 2:
                stats[parts[0]] = parts[1]
    return stats


def find_peaks(y: np.ndarray, threshold: float = PEAK_THRESHOLD) -> list[int]:
    """Indices of local maxima whose rise above both neighbours exceeds
    ``threshold`` (mirrors scipy.signal.find_peaks(threshold=...))."""
    peaks = []
    for i in range(1, len(y) - 1):
        if y[i] - y[i - 1] > threshold and y[i] - y[i + 1] > threshold:
            peaks.append(i)
    return peaks


def find_valleys(y: np.ndarray, threshold: float = PEAK_THRESHOLD) -> list[int]:
    return find_peaks(-np.asarray(y, dtype=np.float64), threshold)


def integrate_kmers(histo: np.ndarray, end: int) -> float:
    """Sum of count*frequency over bins [0, end) (coverage = index+1)."""
    idx = np.arange(1, min(end, len(histo)) + 1, dtype=np.float64)
    return float(np.sum(histo[: len(idx)] * idx))


def genome_size_estimates(histos: np.ndarray) -> list[dict]:
    """Per-chunk het/hom genome size estimates."""
    out = []
    for i in range(histos.shape[1]):
        y = histos[:MAX_COVERAGE_PLOTTED, i]
        peaks = [p for p in find_peaks(y) if p > 5]
        valleys = find_valleys(y)
        if not peaks or not valleys:
            continue
        first_valley = valleys[0]
        if first_valley >= peaks[0]:
            # valley must precede the first real peak to split error k-mers
            pre = [v for v in valleys if v < peaks[0]]
            if not pre:
                continue
            first_valley = pre[0]
        n_all = integrate_kmers(histos[:, i], histos.shape[0])
        n_err = integrate_kmers(histos[:, i], first_valley)
        n_kmers = n_all - n_err
        for j, peak in enumerate(peaks[:2]):
            coverage = peak + 1  # bin index 0 = coverage 1
            size = n_kmers / coverage
            if j == 0:
                out.append({
                    "sample": i, "first_valley": first_valley,
                    "peak_type": "heterozygous", "peak_coverage": coverage,
                    "genome_size": size / 2,
                })
            else:
                out.append({
                    "sample": i, "first_valley": first_valley,
                    "peak_type": "homozygous", "peak_coverage": coverage,
                    "genome_size": size,
                })
    return out


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ font-family: system-ui, sans-serif; margin: 2em; }}
svg {{ border: 1px solid #ccc; background: #fff; }}
.controls {{ margin: 0.6em 0; }}
button {{ font-size: 1em; padding: 0.3em 1.2em; }}
</style></head><body>
<h2>{title}</h2>
{body}
<script>{script}</script>
</body></html>
"""

_SPECTRUM_BODY = """
<div class="controls">
  <button id="play">Play</button>
  <input type="range" id="frame" min="0" max="{max_frame}" value="0" style="width:420px">
  <span id="label"></span>
</div>
<svg id="plot" width="860" height="460" viewBox="0 0 860 460"></svg>
"""

_SPECTRUM_JS = """
const DATA = %(data)s;
const X_LIMIT = %(x_limit)d, Y_LIMIT = %(y_limit)f;
const W = 860, H = 460, ML = 70, MB = 40;
const svg = document.getElementById('plot');
const slider = document.getElementById('frame');
const label = document.getElementById('label');
function sx(x) { return ML + (x / X_LIMIT) * (W - ML - 20); }
function sy(y) { return H - MB - (y / Y_LIMIT) * (H - MB - 20); }
function axis() {
  let s = `<line x1="${ML}" y1="${H-MB}" x2="${W-20}" y2="${H-MB}" stroke="#333"/>`;
  s += `<line x1="${ML}" y1="20" x2="${ML}" y2="${H-MB}" stroke="#333"/>`;
  for (let t = 0; t <= X_LIMIT; t += Math.max(1, Math.round(X_LIMIT/10))) {
    s += `<text x="${sx(t)}" y="${H-MB+16}" font-size="11" text-anchor="middle">${t}</text>`;
  }
  s += `<text x="${(W+ML)/2}" y="${H-4}" font-size="13" text-anchor="middle">Coverage</text>`;
  s += `<text x="14" y="${H/2}" font-size="13" transform="rotate(-90 14 ${H/2})" text-anchor="middle">Frequency</text>`;
  return s;
}
function render(i) {
  const ys = DATA.histos[i];
  let pts = [];
  for (let x = 1; x <= Math.min(X_LIMIT, ys.length); x++) {
    pts.push(`${sx(x)},${sy(Math.min(ys[x-1], Y_LIMIT))}`);
  }
  let s = axis();
  s += `<polyline points="${sx(1)},${sy(0)} ${pts.join(' ')} ${sx(Math.min(X_LIMIT, ys.length))},${sy(0)}"
        fill="rgba(86,180,233,0.45)" stroke="rgb(36,120,180)" stroke-width="1.5"/>`;
  for (const f of DATA.features.filter(f => f.sample === i)) {
    const cx = sx(f.coverage + 1), cy = sy(Math.min(f.frequency, Y_LIMIT));
    if (f.feature === 'peak')
      s += `<path d="M ${cx} ${cy-7} L ${cx-6} ${cy+4} L ${cx+6} ${cy+4} Z" fill="#d55e00"><title>peak cov=${f.coverage+1}</title></path>`;
    else
      s += `<circle cx="${cx}" cy="${cy}" r="4.5" fill="#009e73"><title>valley cov=${f.coverage+1}</title></circle>`;
  }
  svg.innerHTML = s;
  label.textContent = `chunk ${i+1}/${DATA.histos.length}`;
  slider.value = i;
}
let timer = null;
document.getElementById('play').onclick = () => {
  if (timer) { clearInterval(timer); timer = null; return; }
  let i = Number(slider.value);
  timer = setInterval(() => {
    i = (i + 1) %% DATA.histos.length;
    render(i);
    if (i === DATA.histos.length - 1) { clearInterval(timer); timer = null; }
  }, 120);
};
slider.oninput = () => render(Number(slider.value));
render(0);
"""

_SIZE_BODY = '<svg id="plot" width="860" height="460" viewBox="0 0 860 460"></svg>'

_SIZE_JS = """
const EST = %(data)s;
const W = 860, H = 460, ML = 80, MB = 40;
const svg = document.getElementById('plot');
const het = EST.filter(e => e.peak_type === 'heterozygous');
const hom = EST.filter(e => e.peak_type === 'homozygous');
const all = EST.map(e => e.genome_size / 1e6);
const ymax = Math.max(1, ...all) * 1.2;
const xmax = Math.max(1, ...EST.map(e => e.sample));
function sx(x) { return ML + (x / xmax) * (W - ML - 30); }
function sy(y) { return H - MB - (y / ymax) * (H - MB - 30); }
function line(pts, color) {
  if (!pts.length) return '';
  const str = pts.map(p => `${sx(p.sample)},${sy(p.genome_size/1e6)}`).join(' ');
  return `<polyline points="${str}" fill="none" stroke="${color}" stroke-width="2"/>` +
    pts.map(p => `<circle cx="${sx(p.sample)}" cy="${sy(p.genome_size/1e6)}" r="3.5" fill="${color}"><title>chunk ${p.sample+1}: ${(p.genome_size/1e6).toFixed(1)} Mb</title></circle>`).join('');
}
let s = `<line x1="${ML}" y1="${H-MB}" x2="${W-30}" y2="${H-MB}" stroke="#333"/>`;
s += `<line x1="${ML}" y1="30" x2="${ML}" y2="${H-MB}" stroke="#333"/>`;
for (let t = 0; t <= ymax; t += Math.max(1, Math.round(ymax/8))) {
  s += `<text x="${ML-8}" y="${sy(t)+4}" font-size="11" text-anchor="end">${t}</text>`;
}
s += `<text x="${(W+ML)/2}" y="${H-6}" font-size="13" text-anchor="middle">Chunk</text>`;
s += `<text x="16" y="${H/2}" font-size="13" transform="rotate(-90 16 ${H/2})" text-anchor="middle">Genome size (Mb)</text>`;
s += line(het, 'blue') + line(hom, 'red');
s += `<rect x="${W-280}" y="36" width="12" height="12" fill="blue"/><text x="${W-262}" y="47" font-size="12">heterozygous estimate</text>`;
s += `<rect x="${W-280}" y="56" width="12" height="12" fill="red"/><text x="${W-262}" y="67" font-size="12">homozygous estimate</text>`;
svg.innerHTML = s;
"""


def create_report(in_histo: str, in_stats: str, out_name: str, run_name: str,
                  genome_size: float | None = None) -> int:
    counts, histos = load_histo(in_histo)
    histos = histos[:MAX_COVERAGE_PLOTTED]
    stats = load_stats(in_stats)
    _ = stats.get("n_bases_read")

    final = histos[:, -1]
    peaks_final = [p for p in find_peaks(final) if p > 5]

    # plot limits (reference get_limits semantics)
    x_limit, y_limit = 100, 50.0
    y_max = None
    for i in range(histos.shape[1]):
        for p in find_peaks(histos[:, i]):
            if p > 5 and (y_max is None or histos[p, i] > y_max):
                y_max = float(histos[p, i])
                if i == histos.shape[1] - 1:
                    x_limit = (p + 1) * 3
    if peaks_final:
        x_limit = (max(peaks_final, key=lambda p: final[p]) + 1) * 3
    if y_max is not None:
        y_limit = y_max * 1.2

    features = []
    for i in range(histos.shape[1]):
        y = histos[:, i]
        for p in find_peaks(y):
            features.append({"sample": i, "coverage": int(p), "feature": "peak",
                             "frequency": float(y[p])})
        for v in find_valleys(y):
            features.append({"sample": i, "coverage": int(v),
                             "feature": "valley", "frequency": float(y[v])})

    data = {
        "histos": [histos[:, i].tolist() for i in range(histos.shape[1])],
        "features": features,
    }
    html = _PAGE.format(
        title=run_name or out_name,
        body=_SPECTRUM_BODY.format(max_frame=histos.shape[1] - 1),
        script=_SPECTRUM_JS % {
            "data": json.dumps(data),
            "x_limit": int(max(10, min(x_limit, MAX_COVERAGE_PLOTTED))),
            "y_limit": y_limit,
        },
    )
    with open(out_name + ".html", "w") as f:
        f.write(html)

    if not peaks_final:
        print("No peaks found.")
        return 0
    print(f"Number of peaks found: {len(peaks_final)}")
    print("We will assume that the first peak is the heterozygous peak.")
    if len(peaks_final) > 1:
        print("We will assume that the second peak is the homozygous peak.")

    estimates = genome_size_estimates(histos)
    for e in estimates:
        print(
            f"chunk {e['sample'] + 1}: {e['peak_type']} peak at coverage "
            f"{e['peak_coverage']} -> {e['genome_size'] / 1e6:.1f} Mb"
        )
    html = _PAGE.format(
        title=f"{run_name or out_name} genome size",
        body=_SIZE_BODY,
        script=_SIZE_JS % {"data": json.dumps(estimates)},
    )
    with open(out_name + "_genome_size.html", "w") as f:
        f.write(html)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="view sharkmer results")
    parser.add_argument("-d", "--histogram", required=True,
                        help="input histogram distribution file from sharkmer")
    parser.add_argument("-s", "--stats", required=True,
                        help="input stats file from sharkmer")
    parser.add_argument("-n", "--name", default="",
                        help="run name used in output files")
    parser.add_argument("-o", "--output", default="",
                        help="output file base name")
    parser.add_argument("-g", "--genome-size", type=float, default=None,
                        help="haploid genome size in megabases")
    args = parser.parse_args(argv)

    out_name = args.output or args.histogram.replace(".histo", "")
    return create_report(args.histogram, args.stats, out_name, args.name,
                         args.genome_size)


if __name__ == "__main__":
    sys.exit(main())
