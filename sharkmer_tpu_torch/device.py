"""Device selection.

``SHARKMER_TORCH_DEVICE`` names the torch device the count table and
the kernels run on (default ``cuda``); ``cpu`` runs every kernel's
plain PyTorch version instead, the counterpart of the JAX package's
``JAX_PLATFORMS=cpu``. Asking for a CUDA device on a machine without
one raises: the port never drops to the CPU on its own.

``SHARKMER_TORCH_DEVICES`` places the owner shards of ``--n-shards S``
(``shard_devices``): a comma list of D <= S devices, repeats allowed,
shard ``s`` on ``devices[s * D // S]``. ``cuda:0,cuda:0`` puts two
shard groups in separate allocations on one card, the code path of two
cards; ``cpu,cpu`` does the same on the CPU.
"""

from __future__ import annotations

import os

import torch

ENV = "SHARKMER_TORCH_DEVICE"
DEVICES_ENV = "SHARKMER_TORCH_DEVICES"


def default_device() -> torch.device:
    """The device named by ``SHARKMER_TORCH_DEVICE`` (default ``cuda``)."""
    return resolve(os.environ.get(ENV) or "cuda")


def resolve(name: str | torch.device) -> torch.device:
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} was asked for ({ENV}) but torch sees "
                f"no CUDA device; set {ENV}=cpu to run the plain PyTorch "
                f"path"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} does not exist: torch sees "
                f"{torch.cuda.device_count()} CUDA device(s)"
            )
    return dev


def indexed(device) -> torch.device:
    """``device`` with its card's index (``cuda`` -> ``cuda:<current>``),
    so that two names of one card compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def device_list(devices) -> list[torch.device]:
    """A list of device names or devices as ``indexed`` devices; one name
    alone raises (a string is not a list of devices)."""
    if isinstance(devices, (str, torch.device)):
        raise TypeError(f"expected a list of devices, got {devices!r}")
    return [indexed(d) for d in devices]


def shard_devices(n_shards: int, device) -> list[torch.device]:
    """The D devices that hold the ``n_shards`` owner shards (the
    counterpart of the JAX package's ``make_mesh``, ``jax.devices()[:n]``):
    ``SHARKMER_TORCH_DEVICES`` when it is set; else the first ``min(S,
    torch.cuda.device_count())`` cards for a CUDA ``device``; else
    ``[device]``. Shard ``s`` lives on ``devices[s * D // S]``
    (``shard_groups``). A card that does not exist, a list that mixes
    the CPU and CUDA, and more devices than shards raise."""
    names = os.environ.get(DEVICES_ENV)
    if names is None or not names.strip():
        device = resolve(device)
        if device.type == "cuda":
            n = min(n_shards, torch.cuda.device_count())
            return [torch.device("cuda", i) for i in range(n)]
        return [device]
    devices = [indexed(resolve(name.strip())) for name in names.split(",")]
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"{DEVICES_ENV}={names!r} mixes CPU and CUDA devices")
    if len(devices) > n_shards:
        raise ValueError(f"{DEVICES_ENV}={names!r} names {len(devices)} "
                         f"devices for {n_shards} shards: at most one a shard")
    return devices


def shard_groups(n_shards: int, n_devices: int) -> list[tuple[int, int]]:
    """Each device's contiguous shard range ``[lo, hi)``: the shards
    ``s`` with ``s * D // S == d`` (S = 8 over D = 3: 3, 3 and 2)."""
    if not 1 <= n_devices <= n_shards:
        raise ValueError(f"{n_devices} devices for {n_shards} shards")
    return [(-(-d * n_shards // n_devices),
             -(-(d + 1) * n_shards // n_devices)) for d in range(n_devices)]


def synchronize(*devices: torch.device) -> None:
    """Wait for the queued work of every CUDA device given (a no-op on
    the CPU)."""
    for device in dict.fromkeys(indexed(d) for d in devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def device_peak_bytes(device: torch.device) -> int | None:
    """``torch.cuda.max_memory_allocated`` of a CUDA device; None on the
    CPU, which has no device allocator to read."""
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return None
