"""Device selection.

``SHARKMER_TORCH_DEVICE`` names the torch device the count table and
the kernels run on (default ``cuda``); ``cpu`` runs every kernel's
plain PyTorch version instead, the counterpart of the JAX package's
``JAX_PLATFORMS=cpu``. Asking for a CUDA device on a machine without
one raises: the port never drops to the CPU on its own.
"""

from __future__ import annotations

import os

import torch

ENV = "SHARKMER_TORCH_DEVICE"


def default_device() -> torch.device:
    """The device named by ``SHARKMER_TORCH_DEVICE`` (default ``cuda``)."""
    return resolve(os.environ.get(ENV) or "cuda")


def resolve(name: str | torch.device) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for ({ENV}) but torch sees no "
            f"CUDA device; set {ENV}=cpu to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_peak_bytes(device: torch.device) -> int | None:
    """``torch.cuda.max_memory_allocated`` of a CUDA device; None on the
    CPU, which has no device allocator to read."""
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return None
