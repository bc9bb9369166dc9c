"""ctypes bindings for the native C++ FASTQ loader (csrc/sharkio.cpp).

Builds the shared library on first use (g++ -O3, linked against zlib)
from the port's own copy of the loader, ``csrc/sharkio.cpp`` (the JAX
package's loader source but for the comment that names its binding),
into the port's build directory (``build/torch_kernels/``,
beside the CUDA kernels). When the toolchain or zlib is
missing the import still succeeds and ``available()`` returns False —
callers fall back to the pure-python reader, which is also the
permanent differential-test oracle for this loader.
"""

from __future__ import annotations

import ctypes
import logging
import os
import queue
import subprocess
import threading

import numpy as np

from ..kernels.build import BUILD_DIR, CSRC_DIR

log = logging.getLogger("sharkmer")

_SRC = os.path.join(CSRC_DIR, "sharkio.cpp")
_LIB = os.path.join(BUILD_DIR, "libsharkio.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False


def _build() -> bool:
    # compile to a private name and rename into place, so that a
    # concurrent process never loads a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp, "-lz",
    ]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (subprocess.CalledProcessError, OSError,
            subprocess.TimeoutExpired) as e:
        detail = getattr(e, "stderr", b"")
        log.debug("native loader build failed: %s %s", e, detail)
        return False


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_LIB) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        ):
            if not _build():
                _build_failed = True
                return None
        lib = ctypes.CDLL(_LIB)
        lib.shk_open.restype = ctypes.c_void_p
        lib.shk_open.argtypes = [ctypes.c_char_p]
        lib.shk_close.argtypes = [ctypes.c_void_p]
        lib.shk_error.restype = ctypes.c_char_p
        lib.shk_error.argtypes = [ctypes.c_void_p]
        lib.shk_read_batch.restype = ctypes.c_long
        lib.shk_read_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


class NativeFastqReader:
    """Batch reader: yields (codes [n, width] uint8, seq_lens [n]) arrays.

    ``width`` starts at one WIDTH_BUCKET (32) and self-widens to the
    smallest multiple of 32 that fits the reads actually seen (the
    C++ side reports the required width and the partial batch is
    flushed before re-reading). Every pad column is upload + encode +
    drain traffic downstream (the old fixed 512 cost 3.4x the bytes
    of 160-wide rows for 150 bp reads, and dominated peak device
    memory). The other two ingest levers are the PrefetchingBatches
    producer thread and large (2^17-read) device batches."""

    def __init__(self, path: str, validate_every: int = 0, width: int = 32):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._handle = lib.shk_open(os.fspath(path).encode())
        if not self._handle:
            raise OSError(f"Failed to open file: {path}")
        self._validate_every = validate_every
        self._width = width
        self._closed = False

    def close(self):
        if not self._closed:
            self._lib.shk_close(self._handle)
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_batch(self, max_reads: int):
        """Returns (codes, lens) or None at EOF. Raises on format errors."""
        while True:
            codes = np.empty((max_reads, self._width), dtype=np.uint8)
            lens = np.empty(max_reads, dtype=np.int64)
            n_out = ctypes.c_long(0)
            req_width = ctypes.c_long(0)
            rc = self._lib.shk_read_batch(
                self._handle,
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                max_reads,
                self._width,
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                self._validate_every,
                ctypes.byref(n_out),
                ctypes.byref(req_width),
            )
            if rc == -1:
                from .fastq import FastqFormatError

                raise FastqFormatError(
                    self._lib.shk_error(self._handle).decode()
                )
            if rc == -2:
                # an overlong read was buffered; flush what we have (if
                # anything) and widen for the next call
                n = int(n_out.value)
                # widen to a multiple of the engine's WIDTH_BUCKET (32):
                # pow2 widening would pad 150 bp reads to 256 columns,
                # and every pad column is encode+drain traffic
                new_width = -(-int(req_width.value) // 32) * 32
                if n > 0:
                    out = codes[:n], lens[:n]
                    self._width = new_width
                    return out
                self._width = new_width
                continue
            n = int(rc)
            if n == 0:
                return None
            return codes[:n], lens[:n]

    def __iter__(self):
        while True:
            batch = self.read_batch(1 << 14)
            if batch is None:
                return
            yield batch


class PrefetchingBatches:
    """Background-thread batch pump over a NativeFastqReader.

    The ctypes read (gzip inflate + FASTQ parse) releases the GIL, so
    ONE producer thread overlaps file decode with the consumer's
    device uploads and dispatches — the ingest loop was previously
    strictly serial (read, then upload, then read ...). Bounded queue
    preserves order and caps read-ahead memory; ``__exit__`` stops and
    joins the producer BEFORE the reader may be closed (the C handle
    must not be freed under a live read)."""

    def __init__(self, reader: NativeFastqReader,
                 batch_reads: int = 1 << 14, depth: int = 4):
        self._reader = reader
        self._n = batch_reads
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = False
        self._thread = threading.Thread(target=self._pump, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def _pump(self):
        try:
            while not self._stop:
                item = self._reader.read_batch(self._n)
                self._put(item)
                if item is None:
                    return
        except BaseException as e:  # forwarded to the consumer
            self._put(e)

    def _put(self, item) -> None:
        while not self._stop:
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def __exit__(self, *exc):
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)
        return False
