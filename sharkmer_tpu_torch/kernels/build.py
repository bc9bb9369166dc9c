"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` file has a plain C interface and is compiled
by ``nvcc`` for Hopper (``sm_90a``) into ``build/torch_kernels/`` at
the repository root on first use, then loaded with ``ctypes``. Nothing
here runs at import time, so the package imports on machines without
``nvcc`` or a GPU; a build failure raises.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


def _build(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    # a shared header (csrc/*.cuh), and a source it includes, count as
    # part of the source
    with open(src) as f:
        included = set(re.findall(r'#include "(\w+\.cu)"', f.read()))
    newest = max(os.path.getmtime(os.path.join(CSRC_DIR, f))
                 for f in os.listdir(CSRC_DIR)
                 if f == f"{name}.cu" or f.endswith(".cuh") or f in included)
    if os.path.exists(lib) and os.path.getmtime(lib) >= newest:
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def build_all(names) -> None:
    """Compile the named sources concurrently (one ``nvcc`` each), then
    load them. Raises on the first failed build."""
    names = list(names)
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        for future in [pool.submit(_build, name) for name in names]:
            future.result()
    for name in names:
        load(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built from ``csrc/<name>.cu`` if it
    is missing or older than its source."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_build(name))
            _libs[name] = lib
        return lib
