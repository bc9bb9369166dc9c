"""The port's package boundary: no jax, no silent CPU, no drift.

* The port imports torch and never jax, so it runs where jax is absent.
* Asking for a CUDA device without one raises instead of falling back.
* The host layers are copies of the JAX package's (which cannot be
  imported without jax): each copy's code must equal its original
  apart from import statements and docstrings. Docstrings may differ
  because the copies describe the port, and comments are not code;
  neither is the timing around the code (``utils/phases``, the port's
  trace registry and no copy: its calls, the bodies of its ``with``
  blocks as they stand, and the clock reads only they used).
"""

import ast
import gzip
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (port module, JAX original) for every copied host module
COPIES = [
    (f"sharkmer_tpu_torch/{m}", f"sharkmer_tpu/{m}")
    for m in (
        "cli.py", "stats.py", "format.py", "__main__.py",
        "utils/__init__.py", "utils/levenshtein.py", "utils/progress.py",
        "io/__init__.py", "io/fastq.py", "io/native.py", "io/records.py",
        "io/writers.py", "io/cache.py", "io/ena.py",
        "pcr/__init__.py", "pcr/bubble.py", "pcr/counts.py", "pcr/graph.py",
        "pcr/panels.py", "pcr/params.py", "pcr/paths.py", "pcr/prefetch.py",
        "pcr/primers.py", "pcr/pruning.py", "pcr/read_filter.py",
        "pcr/spcr.py", "pcr/threading.py", "viewer.py",
    )
] + [(f"sharkmer_tpu_torch/tools/{m}",
       f"scripts/sharkmer_validate/{os.path.basename(m)}")
      for m in ("synth.py", "validate/results.py", "validate/report.py")]

# Top-level definitions a copy may change on purpose: the native loader
# builds the port's own copy of the loader's source (csrc/sharkio.cpp,
# held to the JAX package's by test_loader_source_has_not_drifted) into the
# port's build directory; the
# synthesizer returns the amplicons it embeds (its reads stay the
# original's byte for byte: test_synth_writes_the_same_reads and
# tests/test_torch_panels.py); the read filter encodes a slab of reads
# at once with numpy (it keeps the reads the JAX filter keeps:
# tests/test_torch_read_filter.py).
ALLOWED = {"sharkmer_tpu_torch/io/native.py": {"_NATIVE_DIR", "_SRC", "_LIB",
                                               "_build"},
           "sharkmer_tpu_torch/pcr/read_filter.py": {
               "PrimerReadFilter", "_CODES", "CELLS", "_slabs", "_windows"},
           "sharkmer_tpu_torch/tools/synth.py": {
               "synthesize_panel_fastq", "embed_amplicons",
               "panel_amplicons"}}


def _timing(node) -> bool:
    """A call into ``phases`` (``phases.add(...)``, ``phases.span(...)``)."""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "phases")


def _clock_reads(tree) -> set:
    """Names assigned a clock read (``t = time.monotonic()``) that no
    code reads."""
    loaded = {n.id for n in ast.walk(tree)
              if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
    return {n.targets[0].id for n in ast.walk(tree)
            if isinstance(n, ast.Assign) and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name)
            and isinstance(n.value, ast.Call)
            and isinstance(n.value.func, ast.Attribute)
            and n.value.func.attr in ("monotonic", "perf_counter")
            and n.targets[0].id not in loaded}


def _code(path: str, allowed: set[str]) -> str:
    """The module's AST without imports, docstrings, timing and
    ``allowed`` top-level definitions."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    unused = set()

    def strip(body):
        out = []
        for i, node in enumerate(body):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            if isinstance(node, ast.Expr) and _timing(node.value):
                continue
            if isinstance(node, ast.With) and all(
                    _timing(item.context_expr) for item in node.items):
                out.extend(strip(node.body))
                continue
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and getattr(node.targets[0], "id", None) in unused):
                continue
            if (i == 0 and isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                continue  # docstring
            for field in ("body", "orelse", "finalbody", "handlers"):
                if isinstance(getattr(node, field, None), list):
                    setattr(node, field, strip(getattr(node, field)))
            out.append(node)
        return out

    def name(node):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            return node.name
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            return getattr(node.targets[0], "id", None)
        return None

    tree.body = strip(tree.body)
    unused = _clock_reads(tree)  # read only by the timing just dropped
    tree.body = [n for n in strip(tree.body) if name(n) not in allowed]
    return ast.dump(tree)


@pytest.mark.parametrize("port,original", COPIES,
                         ids=[p for p, _ in COPIES])
def test_copied_module_has_not_drifted(port, original):
    allowed = ALLOWED.get(port, set())
    assert _code(port, allowed) == _code(original, allowed)


def test_every_panel_is_copied():
    src = os.path.join(ROOT, "sharkmer_tpu", "panels")
    dst = os.path.join(ROOT, "sharkmer_tpu_torch", "panels")
    assert sorted(os.listdir(src)) == sorted(os.listdir(dst))
    for name in os.listdir(src):
        with open(os.path.join(src, name), "rb") as a, \
                open(os.path.join(dst, name), "rb") as b:
            assert a.read() == b.read(), name


def test_native_loader_builds_into_build_dir():
    from sharkmer_tpu_torch.io import native
    from sharkmer_tpu_torch.kernels.build import BUILD_DIR

    assert os.path.dirname(native._LIB) == BUILD_DIR
    assert native._SRC == os.path.join(ROOT, "sharkmer_tpu_torch", "csrc",
                                       "sharkio.cpp")
    assert os.path.exists(native._SRC)


def test_loader_source_has_not_drifted():
    """The port's copy of the FASTQ loader's C++ source equals the JAX
    package's line for line, but for the header comment's line that names
    the Python binding."""
    def lines(path):
        with open(os.path.join(ROOT, path)) as f:
            return f.read().splitlines()

    port = lines("sharkmer_tpu_torch/csrc/sharkio.cpp")
    original = lines("native/sharkio.cpp")
    assert len(port) == len(original)
    differ = [i for i, (a, b) in enumerate(zip(port, original)) if a != b]
    assert differ == [next(i for i, line in enumerate(original)
                           if "sharkmer_tpu/io/native.py" in line)]
    line = differ[0]
    assert port[line].startswith("//") and original[line].startswith("//")
    assert all(text.startswith("//") for text in original[:line])
    assert port[line] == original[line].replace(
        "sharkmer_tpu/io/native.py", "sharkmer_tpu_torch/io/native.py")


def test_port_reads_nothing_of_native():
    """No module of the port and no part of chip_smoke.py names the JAX
    package's ``native/`` directory."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, files in os.walk(os.path.join(ROOT,
                                                   "sharkmer_tpu_torch")):
        paths += [os.path.join(base, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh", ".cpp"))]
    for path in paths:
        with open(path) as f:
            text = f.read()
        for needle in ("native/", '"native"', "'native'"):
            assert needle not in text, (os.path.relpath(path, ROOT), needle)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import sharkmer_tpu_torch.main, sharkmer_tpu_torch.engine\n"
        "import sharkmer_tpu_torch.ops.sorted_store\n"
        "import sharkmer_tpu_torch.ops.hashtable, sharkmer_tpu_torch.io.checkpoint\n"
        "import sharkmer_tpu_torch.pcr.spcr, sharkmer_tpu_torch.tools.synth\n"
        "import sharkmer_tpu_torch.parallel.sharded_reach\n"
        "import sharkmer_tpu_torch.viewer\n"
        "import sharkmer_tpu_torch.tools.run_grid, sharkmer_tpu_torch.tools.bench\n"
        "import sharkmer_tpu_torch.tools.validate.runner\n"
        "import sharkmer_tpu_torch.tools.ingest_phase\n"
        "import sharkmer_tpu_torch.tools.cold_start\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'sharkmer_tpu.')))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_no_jax_import_in_port_sources():
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT,
                                                      "sharkmer_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    tree = ast.parse(f.read())
                for node in ast.walk(tree):
                    mods = []
                    if isinstance(node, ast.Import):
                        mods = [a.name for a in node.names]
                    elif isinstance(node, ast.ImportFrom) and node.module:
                        mods = [node.module]
                    for m in mods:
                        assert m.split(".")[0] not in ("jax", "sharkmer_tpu"), (
                            name, m)


def test_cuda_without_a_gpu_raises(monkeypatch):
    from sharkmer_tpu_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(device.ENV, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.default_device()
    monkeypatch.delenv(device.ENV)
    with pytest.raises(RuntimeError):
        device.default_device()  # cuda is the default
    assert device.resolve("cpu") == torch.device("cpu")


def test_synth_writes_the_same_reads(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "scripts"))
    from sharkmer_tpu_torch.tools import synth
    from sharkmer_validate import synth as jax_synth

    panel = os.path.join(ROOT, "sharkmer_tpu", "panels", "cnidaria.yaml")
    a = jax_synth.synthesize_panel_fastq(panel, tmp_path / "a.fastq.gz",
                                         n_reads=2000, seed=0)
    b = synth.synthesize_panel_fastq(panel, tmp_path / "b.fastq.gz",
                                     n_reads=2000, seed=0)
    with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
        ra, rb = fa.read(), fb.read()
    assert ra == rb and ra.count(b"\n") == 4 * 2000
