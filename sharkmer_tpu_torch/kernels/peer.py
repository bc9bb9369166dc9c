"""Kernels that read tensors on other devices: readability and ordering.

The reach closure, ``probe_rows`` and the pointer-table ``hash_lookup``
launch on one card and load shards that may live on other cards through
raw pointers (``PartTable``'s descriptors, the lookup's slot pointer
table). Two rules make that safe, and they live here so that a reader
can audit them in one place:

* ``check_readable``: a kernel on ``launch`` may read a tensor on
  ``other`` only when they are the same device, or when CUDA reports
  peer access between the two cards and it has been enabled
  (``csrc/peer.cu``). A pair without peer access raises: the port never
  copies behind the caller's back. Tensors on the CPU read only CPU
  tensors (the plain versions).
* ``wait_for_peers``: before such a launch, the launching card's
  current stream waits on every other card's current stream, so the
  kernel follows the work that wrote the peer tensors there. With a
  device list that repeats one card, all of it is one stream and the
  wait is a no-op.

The peer tensors themselves stay alive in their owners (the store's
shards and sidecars, the table's slot groups) for the whole launch: each
caller reads the launch's result on the host before it returns.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..device import indexed
from . import build

_lock = threading.Lock()
_enabled: set[tuple[int, int]] = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("peer")
    if not getattr(lib, "_shk_bound", False):
        lib.shk_enable_peer_access.argtypes = [ctypes.c_int]
        lib.shk_enable_peer_access.restype = ctypes.c_int
        lib._shk_bound = True
    return lib


def check_readable(launch, other) -> None:
    """Raise unless a kernel on ``launch`` can load from ``other``'s
    memory; enable peer access between two cards once, where CUDA
    reports it possible."""
    launch, other = indexed(launch), indexed(other)
    if launch == other:
        return
    if launch.type != "cuda" or other.type != "cuda":
        raise ValueError(f"a kernel on {launch} cannot read a tensor on "
                         f"{other}")
    pair = (launch.index, other.index)
    with _lock:
        if pair in _enabled:
            return
        # torch.cuda.can_device_access_peer(i, i) is False: the same card
        # returned above
        if not torch.cuda.can_device_access_peer(*pair):
            raise RuntimeError(f"{launch} has no peer access to {other}: a "
                               f"kernel there cannot read its shards")
        with torch.cuda.device(launch):
            rc = _lib().shk_enable_peer_access(other.index)
        if rc != 0:
            raise RuntimeError(f"enabling peer access {launch} -> {other} "
                               f"failed (cudaError {rc})")
        _enabled.add(pair)


def wait_for_peers(launch, devices) -> None:
    """Make the launching card's current stream wait on the current
    stream of every other CUDA device in ``devices``."""
    launch = indexed(launch)
    if launch.type != "cuda":
        return
    stream = torch.cuda.current_stream(launch)
    for other in dict.fromkeys(indexed(d) for d in devices):
        if other != launch:
            stream.wait_stream(torch.cuda.current_stream(other))
