"""The port's package boundary: no jax, no silent CPU, no drift.

* The port imports torch and never jax, so it runs where jax is absent.
* Asking for a CUDA device without one raises instead of falling back.
* The host layers are copies of the JAX package's (which cannot be
  imported without jax): each copy's code must equal its original
  apart from import statements and docstrings. Docstrings may differ
  because the copies describe the port, and comments are not code.
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
        "utils/__init__.py", "utils/levenshtein.py", "utils/phases.py",
        "utils/progress.py",
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
# builds its library into the port's build directory, not native/.
ALLOWED = {"sharkmer_tpu_torch/io/native.py": {"_LIB", "_build"}}


def _code(path: str, allowed: set[str]) -> str:
    """The module's AST without imports, docstrings and ``allowed``
    top-level definitions."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())

    def strip(body):
        out = []
        for i, node in enumerate(body):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
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
    assert os.path.dirname(native._SRC) == os.path.join(ROOT, "native")


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
