"""Insert into and probe the hash backend's table: ``hash_insert`` and
``hash_lookup``.

They replace XLA programs of the JAX package, not Pallas kernels:
``sharkmer_tpu/ops/hashtable.py`` ``_insert_kernel`` and ``_rehash_kernel``
(claim/probe rounds of masked scatters in a ``lax.while_loop``), and
``_lookup_kernel`` and ``_lookup_directional_kernel`` (the probe loop).
torch has no op that does either.

The table is two ``[cap]`` tensors (``cap`` a power of two): int64
``keys``, ``SENTINEL`` (INT64_MAX) for an empty slot, and int32
``counts`` holding the u32 count's bit pattern. A key's home slot is
``mix64(key) & (cap - 1)``, the SplitMix64 finalizer; collisions probe
linearly. Counts add modulo 2^32, and a count at or above
``SAT_THRESHOLD`` takes no further add (the JAX table's freeze rule).

On a CPU tensor each wrapper runs its plain PyTorch version (the CPU
path and the test oracle): ``insert_plain`` is the JAX claim/probe round
loop, ``lookup_plain`` the JAX probe loop. On a CUDA tensor it launches
the hand-written kernel in ``csrc/hash_table.cu`` on the current stream,
or raises. ``<wrapper>.launches`` counts the wrapper's kernel launches.
The kernel's claims race, so its slot layout may differ from the plain
version's; the table's contents (each key and its count) do not.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.histogram import revcomp
from ..ops.keys import SENTINEL
from . import build

SAT_THRESHOLD = 0xE000_0000
U32 = 0xFFFF_FFFF
# the SplitMix64 multipliers as int64 bit patterns (torch's int64
# multiply wraps, as the uint64 one does)
_M1 = 0xFF51_AFD7_ED55_8CCD - (1 << 64)
_M2 = 0xC4CE_B9FE_1A85_EC53 - (1 << 64)
_LOW31 = (1 << 31) - 1
_LOW24 = (1 << 24) - 1


def mix64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64 finalizer on int64 bit patterns: ``>> 33`` is made
    logical by masking away the sign extension."""
    x = x ^ ((x >> 33) & _LOW31)
    x = x * _M1
    x = x ^ ((x >> 33) & _LOW31)
    x = x * _M2
    return x ^ ((x >> 33) & _LOW31)


def owner(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The shard of ``n_shards`` that owns each key: the JAX package's
    u64 ``(mix64(k) >> 40) % n_shards`` (``parallel/sharded_table.py``
    ``_owner``), the high hash bits, so that the owner and a shard's
    home slot (the low bits) stay independent. The mask makes the int64
    ``>> 40`` logical. ``csrc/mix64.cuh`` has the device form."""
    return ((mix64(keys) >> 40) & _LOW24) % n_shards


def as_u32(counts: torch.Tensor) -> torch.Tensor:
    """int32 count bit patterns -> their u32 values as int64."""
    return counts.to(torch.int64) & U32


def as_i32(values: torch.Tensor) -> torch.Tensor:
    """u32 values (int64, in [0, 2^32)) -> int32 bit patterns."""
    return (values - ((values >> 31) << 32)).to(torch.int32)


def _freeze_add(counts, slots, amounts) -> None:
    """The JAX round's scatter-add: each slot takes the u32 sum of its
    entries' amounts, unless its count (read before the add) is at or
    above SAT_THRESHOLD."""
    if not slots.numel():
        return
    uniq, inv = torch.unique(slots, return_inverse=True)
    total = torch.zeros(uniq.shape, dtype=torch.int64, device=slots.device)
    total.index_add_(0, inv, amounts)
    old = as_u32(counts[uniq])
    new = torch.where(old >= SAT_THRESHOLD, old, (old + total) & U32)
    counts[uniq] = as_i32(new)


def insert_plain(keys, counts, kmers, amounts=None) -> None:
    """The JAX claim/probe rounds, in place. A round: pending entries
    that find their key add; those at an empty slot claim it
    (``index_put_``: one claimant of a slot wins) and, re-reading the
    slot, the winners add; the rest step one slot on."""
    cap = keys.shape[0]
    live = kmers != SENTINEL
    km = kmers[live]
    if amounts is None:
        amt = torch.ones(km.shape, dtype=torch.int64, device=km.device)
    else:
        amt = as_u32(amounts[live])
    slot = mix64(km) & (cap - 1)
    for _ in range(cap):
        if not km.numel():
            return
        cur = keys[slot]
        hit = cur == km
        _freeze_add(counts, slot[hit], amt[hit])
        rest = ~hit
        km, amt, slot, cur = km[rest], amt[rest], slot[rest], cur[rest]
        empty = cur == SENTINEL
        keys[slot[empty]] = km[empty]
        claimed = empty & (keys[slot] == km)
        _freeze_add(counts, slot[claimed], amt[claimed])
        rest = ~claimed
        km, amt = km[rest], amt[rest]
        slot = (slot[rest] + 1) & (cap - 1)
    if km.numel():
        raise RuntimeError(f"hash_insert: {km.numel()} entries found no slot "
                           f"in {cap} probes (table full)")


def lookup_plain(keys, counts, queries, k: int = 0) -> torch.Tensor:
    """The JAX probe loop: each query's count (int32 bit pattern), 0
    when absent or SENTINEL; ``k > 0`` canonicalizes the queries first."""
    cap = keys.shape[0]
    if k:
        queries = torch.minimum(queries, revcomp(queries, k))
    out = torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
    idx = torch.nonzero(queries != SENTINEL).reshape(-1)
    q = queries[idx]
    slot = mix64(q) & (cap - 1)
    for _ in range(cap):
        if not idx.numel():
            break
        cur = keys[slot]
        found = cur == q
        out[idx[found]] = counts[slot[found]]
        go = ~found & (cur != SENTINEL)
        idx, q, slot = idx[go], q[go], (slot[go] + 1) & (cap - 1)
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("hash_table")
    if not getattr(lib, "_shk_bound", False):
        lib.shk_hash_insert.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.shk_hash_insert.restype = ctypes.c_int
        lib.shk_hash_lookup.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.shk_hash_lookup.restype = ctypes.c_int
        lib._shk_bound = True
    return lib


def _check_table(entry: str, keys, counts) -> int:
    cap = keys.shape[0]
    if keys.dtype != torch.int64 or counts.dtype != torch.int32:
        raise TypeError(f"{entry}: keys must be int64 and counts int32, got "
                        f"{keys.dtype} and {counts.dtype}")
    if (keys.dim() != 1 or counts.shape != keys.shape
            or not keys.is_contiguous() or not counts.is_contiguous()):
        raise ValueError(f"{entry}: keys and counts must be contiguous [cap]")
    if cap == 0 or cap & (cap - 1):
        raise ValueError(f"{entry}: capacity {cap} is not a power of two")
    return cap


def _check_input(entry: str, keys, name: str, t, dtype) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{entry}: {name} must be a contiguous 1-D {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")
    if t.device != keys.device:
        raise ValueError(f"{entry}: {name} is on {t.device}, the table on "
                         f"{keys.device}")


def hash_insert(keys, counts, kmers, amounts=None) -> None:
    """Add ``kmers`` (int64, SENTINEL skipped) into the table in place,
    each with its ``amounts`` entry (int32 u32 bit patterns) or 1."""
    if keys.device.type == "cpu":
        insert_plain(keys, counts, kmers, amounts)
        return
    if keys.device.type != "cuda":
        raise ValueError(f"hash_insert: unsupported device {keys.device}")
    cap = _check_table("hash_insert", keys, counts)
    _check_input("hash_insert", keys, "kmers", kmers, torch.int64)
    if amounts is not None:
        _check_input("hash_insert", keys, "amounts", amounts, torch.int32)
        if amounts.shape != kmers.shape:
            raise ValueError("hash_insert: amounts and kmers differ in shape")
    n = kmers.shape[0]
    if not n:
        return
    lib = _lib()
    overflow = torch.zeros(1, dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shk_hash_insert(
            keys.data_ptr(), counts.data_ptr(), cap, kmers.data_ptr(),
            None if amounts is None else amounts.data_ptr(), n,
            overflow.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hash_insert: CUDA launch failed (cudaError {rc})")
    hash_insert.launches += 1
    if int(overflow):
        raise RuntimeError(f"hash_insert: an entry found no slot in {cap} "
                           f"probes (table full)")


def hash_lookup(keys, counts, queries, k: int = 0) -> torch.Tensor:
    """Counts (int32 u32 bit patterns) of int64 ``queries``, 0 when
    absent or SENTINEL; ``k > 0`` looks up each query's canonical form
    (directional lookup)."""
    if keys.device.type == "cpu":
        return lookup_plain(keys, counts, queries, k)
    if keys.device.type != "cuda":
        raise ValueError(f"hash_lookup: unsupported device {keys.device}")
    cap = _check_table("hash_lookup", keys, counts)
    _check_input("hash_lookup", keys, "queries", queries, torch.int64)
    if not 0 <= k <= 31:
        raise ValueError(f"hash_lookup: k={k} out of range")
    n = queries.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=keys.device)
    if not n:
        return out
    lib = _lib()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shk_hash_lookup(keys.data_ptr(), counts.data_ptr(), cap,
                                 queries.data_ptr(), n, k, out.data_ptr(),
                                 stream)
    if rc != 0:
        raise RuntimeError(f"hash_lookup: CUDA launch failed (cudaError {rc})")
    hash_lookup.launches += 1
    return out


hash_insert.launches = 0
hash_lookup.launches = 0
