"""Row stitch of drain v2: ``stitch_rows``.

It replaces the Pallas TPU kernel of the JAX package,
``sharkmer_tpu/ops/pallas_kernels.py`` ``stitch_rows`` (``_stitch_call``,
``_make_stitch_kernel``). Drain v2 sorts the packed raw buffer as
``[R, W]`` rows, each row's survivors (live words, then ghost padding up
to a multiple of ``GHOST_Q``) front-compacted; ``stitch_rows``
concatenates the rows' kept prefixes into one flat array.

``rows`` is ``[R, W]`` int64, ``offsets`` ``[R]`` int32 the exclusive
prefix sum of the kept lengths (``offsets[0] == 0``, each length at most
``W``). Row ``r``'s first ``offsets[r+1] - offsets[r]`` elements go to
``out[offsets[r]:]``; the last row writes all ``W``; everything behind
is ``fill``. The result is ``[R * W]`` int64.

On a CPU tensor the wrapper runs the plain PyTorch version (the CPU
path and the test oracle); on a CUDA tensor it launches the
hand-written kernel in ``csrc/stitch_rows.cu`` (a copy of every kept
element in any order, plus a fill of the tail; see the source) on the
current stream, or raises. ``stitch_rows.launches`` counts the
wrapper's kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MAX_ROWS = 65535  # the kernel's grid.y


def stitch_rows_plain(rows, offsets, fill: int) -> torch.Tensor:
    """Boolean-mask row-major gather of each row's kept prefix."""
    n_rows, width = rows.shape
    offs = offsets.to(torch.int64)
    lens = torch.cat([offs[1:] - offs[:-1],
                      torch.full((1,), width, dtype=torch.int64,
                                 device=rows.device)])
    cols = torch.arange(width, dtype=torch.int64, device=rows.device)
    kept = rows[cols[None, :] < lens[:, None]]
    out = torch.full((n_rows * width,), fill, dtype=rows.dtype,
                     device=rows.device)
    out[: kept.shape[0]] = kept
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("stitch_rows")
    if not getattr(lib, "_shk_bound", False):
        lib.shk_stitch_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.shk_stitch_rows.restype = ctypes.c_int
        lib._shk_bound = True
    return lib


def stitch_rows(rows, offsets, fill: int) -> torch.Tensor:
    """Each row's kept prefix, concatenated at ``offsets``; ``fill``
    behind (int64 ``[R * W]``)."""
    if rows.device.type == "cpu":
        return stitch_rows_plain(rows, offsets, fill)
    if rows.device.type != "cuda":
        raise ValueError(f"stitch_rows: unsupported device {rows.device}")
    if rows.dtype != torch.int64 or offsets.dtype != torch.int32:
        raise TypeError(f"stitch_rows: rows must be int64 and offsets int32, "
                        f"got {rows.dtype} and {offsets.dtype}")
    if rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError("stitch_rows: rows must be a contiguous [R, W] tensor")
    n_rows, width = rows.shape
    if offsets.shape != (n_rows,) or not offsets.is_contiguous():
        raise ValueError(f"stitch_rows: offsets must be contiguous [{n_rows}]")
    if offsets.device != rows.device:
        raise ValueError("stitch_rows: rows and offsets on different devices")
    if n_rows > MAX_ROWS or n_rows * width >= 1 << 31:
        raise ValueError(f"stitch_rows: [{n_rows}, {width}] is too large "
                         f"(at most {MAX_ROWS} rows, int32 offsets)")
    lib = _lib()
    out = torch.empty(n_rows * width, dtype=torch.int64, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shk_stitch_rows(rows.data_ptr(), offsets.data_ptr(),
                                 out.data_ptr(), int(fill), n_rows, width,
                                 stream)
    if rc != 0:
        raise RuntimeError(f"stitch_rows: CUDA launch failed (cudaError {rc})")
    if out.shape[0]:  # an empty input launches nothing
        stitch_rows.launches += 1
    return out


stitch_rows.launches = 0
