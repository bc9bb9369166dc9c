"""Insert into and probe the hash backend's table: ``hash_insert`` and
``hash_lookup``.

They replace XLA programs of the JAX package, not Pallas kernels:
``sharkmer_tpu/ops/hashtable.py`` ``_insert_kernel`` and ``_rehash_kernel``
(claim/probe rounds of masked scatters in a ``lax.while_loop``), and
``_lookup_kernel`` and ``_lookup_directional_kernel`` (the probe loop);
and, over S owner shards, the gather-mask-insert and mask-lookup-psum
bodies of ``sharkmer_tpu/parallel/sharded_table.py``. torch has no op
that does either.

The table is one int64 tensor of 16 B slots (``new_slots``): ``[cap, 2]``
for one table, ``[S, cap, 2]`` for S owner shards (``cap`` a power of
two); shards placed on several devices are groups ``[n_d, cap, 2]`` of
contiguous shards, one a device (``parallel/sharded_table.py``). A slot
holds the int64 key at byte 0 (``SENTINEL``, INT64_MAX, when
empty), the u32 count at byte 8 and 4 B of zeros; ``slot_keys`` and
``slot_counts`` are the int64 key view and the int32 count view (the
u32's bit pattern), each with a 16 B stride. A key lives in shard
``owner(key, S)``, the high bits of the SplitMix64 hash; its home slot
there is ``mix64(key) & (cap - 1)``, the low bits; collisions probe
linearly. Counts add modulo 2^32, and a count at or above
``SAT_THRESHOLD`` takes no further add (the JAX table's freeze rule).
An insert also counts the slots it claims into ``claims`` (int64, one
per shard), so a table's occupancy is read without a sweep. An insert
into one group of shards takes the group's window ``(shard_lo,
n_shards)`` of the S-way route and skips the entries other groups own;
a lookup over groups reads each shard through a pointer table
(``slot_pointers``), one launch on the querying device.

On a CPU tensor each wrapper runs its plain PyTorch version (the CPU
path and the test oracle), on the same layout and the same routing:
``insert_plain`` is the JAX claim/probe round loop, ``lookup_plain`` the
JAX probe loop. On a CUDA tensor it launches the hand-written kernel in
``csrc/hash_table.cu`` on the current stream, or raises; a sharded call
is one launch (an insert into groups: one a group).
``<wrapper>.launches`` counts the wrapper's kernel launches. The
kernel's claims race, so its slot layout may differ from the plain
version's; the table's contents (each key and its count) and
its claim counts do not.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.histogram import revcomp
from ..ops.keys import SENTINEL
from . import build, peer

SAT_THRESHOLD = 0xE000_0000
U32 = 0xFFFF_FFFF
MAX_SHARDS = 4096  # the insert kernel's per-block claim counters
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


def _owner_of_hash(h: torch.Tensor, n_shards: int) -> torch.Tensor:
    return ((h >> 40) & _LOW24) % n_shards


def owner(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The shard of ``n_shards`` that owns each key: the JAX package's
    u64 ``(mix64(k) >> 40) % n_shards`` (``parallel/sharded_table.py``
    ``_owner``), the high hash bits, so that the owner and a shard's
    home slot (the low bits) stay independent. The mask makes the int64
    ``>> 40`` logical. ``csrc/mix64.cuh`` has the device form."""
    return _owner_of_hash(mix64(keys), n_shards)


def as_u32(counts: torch.Tensor) -> torch.Tensor:
    """int32 count bit patterns -> their u32 values as int64."""
    return counts.to(torch.int64) & U32


def as_i32(values: torch.Tensor) -> torch.Tensor:
    """u32 values (int64, in [0, 2^32)) -> int32 bit patterns."""
    return (values - ((values >> 31) << 32)).to(torch.int32)


# -- the slot layout ----------------------------------------------------------


def new_slots(shape, device) -> torch.Tensor:
    """Empty slots: int64 ``[*shape, 2]``, each key SENTINEL, each count
    and pad word 0."""
    slots = torch.zeros((*shape, 2), dtype=torch.int64, device=device)
    slots[..., 0] = SENTINEL
    return slots


def slot_keys(slots: torch.Tensor) -> torch.Tensor:
    """The int64 keys of ``[..., 2]`` slots (a view, 16 B stride)."""
    return slots[..., 0]


def slot_counts(slots: torch.Tensor) -> torch.Tensor:
    """The int32 counts of ``[..., 2]`` slots: the word at byte 8 (a
    view, 16 B stride)."""
    return slots.view(torch.int32)[..., 2]


def _geometry(slots: torch.Tensor) -> tuple[int, int]:
    """(n_shards, slots a shard) of a ``[cap, 2]`` or ``[S, cap, 2]``
    table."""
    if slots.dim() == 2:
        return 1, slots.shape[0]
    return slots.shape[0], slots.shape[1]


def _window(entry: str, slots, shard_lo: int, n_shards) -> tuple[int, int]:
    """(n_shards of the route, cap) of a table that holds the shards
    ``[shard_lo, shard_lo + n_local)`` of it (by default all of them)."""
    n_local, cap = _geometry(slots)
    n_shards = n_local if n_shards is None else int(n_shards)
    if not (0 <= shard_lo and shard_lo + n_local <= n_shards <= MAX_SHARDS):
        raise ValueError(f"{entry}: shards [{shard_lo}, {shard_lo + n_local})"
                         f" are not a window of {n_shards} (at most "
                         f"{MAX_SHARDS})")
    return n_shards, cap


def _homes(keys, n_shards: int, shard_lo: int, n_local: int, cap: int):
    """Each key's local shard in the window and home slot in its shard,
    and whether the window owns it."""
    h = mix64(keys)
    local = _owner_of_hash(h, n_shards) - shard_lo
    return local, h & (cap - 1), (local >= 0) & (local < n_local)


# -- plain versions -----------------------------------------------------------


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


def _entries(kmers, amounts):
    """(keys, amounts as int64 u32 values) of an insert's entries:
    ``kmers`` [n] with ``amounts`` [n] or None (each adds 1), or another
    table's ``[n, 2]`` slots."""
    if kmers.dim() == 2:
        return slot_keys(kmers), as_u32(slot_counts(kmers))
    if amounts is None:
        return kmers, torch.ones(kmers.shape, dtype=torch.int64,
                                 device=kmers.device)
    return kmers, as_u32(amounts)


def insert_plain(slots, claims, kmers, amounts=None, shard_lo: int = 0,
                 n_shards=None) -> None:
    """The JAX claim/probe rounds, in place, each entry in its owner's
    shard; an entry whose owner lies outside the window ``[shard_lo,
    shard_lo + n_local)`` of the ``n_shards``-way route is skipped (the
    JAX mask). A round: pending entries that find their key add; those at
    an empty slot claim it (``index_put_``: one claimant of a slot wins;
    each newly claimed slot counts in its shard's ``claims``) and,
    re-reading the slot, the winners add; the rest step one slot on in
    their shard."""
    n_shards, cap = _window("hash_insert", slots, shard_lo, n_shards)
    keys = slot_keys(slots).view(-1)
    counts = slot_counts(slots).view(-1)
    km, amt = _entries(kmers, amounts)
    live = km != SENTINEL
    km, amt = km[live], amt[live]
    local, slot, mine = _homes(km, n_shards, shard_lo, _geometry(slots)[0],
                               cap)
    km, amt, slot, base = km[mine], amt[mine], slot[mine], local[mine] * cap
    for _ in range(cap):
        if not km.numel():
            return
        flat = base + slot
        cur = keys[flat]
        hit = cur == km
        _freeze_add(counts, flat[hit], amt[hit])
        rest = ~hit
        km, amt, cur, flat = km[rest], amt[rest], cur[rest], flat[rest]
        base, slot = base[rest], slot[rest]
        empty = cur == SENTINEL
        fresh = torch.unique(flat[empty])
        claims.index_add_(0, fresh // cap, torch.ones_like(fresh))
        keys[flat[empty]] = km[empty]
        claimed = empty & (keys[flat] == km)
        _freeze_add(counts, flat[claimed], amt[claimed])
        rest = ~claimed
        km, amt, base = km[rest], amt[rest], base[rest]
        slot = (slot[rest] + 1) & (cap - 1)
    if km.numel():
        raise RuntimeError(f"hash_insert: {km.numel()} entries found no slot "
                           f"in {cap} probes (table full)")


def lookup_plain(slots, queries, k: int = 0) -> torch.Tensor:
    """The JAX probe loop, each query in its owner's shard: its count
    (int32 bit pattern), 0 when absent or SENTINEL; ``k > 0``
    canonicalizes the queries first. ``slots`` is one table or a list of
    groups of shards (``hash_lookup``): over groups, each group answers
    the queries in its window on its device, and the answers (one
    nonzero at most a query) are summed on the queries' device, the JAX
    mask and psum."""
    if isinstance(slots, torch.Tensor):
        return _lookup_window(slots, queries, k)
    n_shards = sum(g.shape[0] for g in slots)
    out = torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
    lo = 0
    for group in slots:
        out += _lookup_window(group, queries.to(group.device), k, lo,
                              n_shards).to(queries.device)
        lo += group.shape[0]
    return out


def _lookup_window(slots, queries, k: int, shard_lo: int = 0,
                   n_shards=None) -> torch.Tensor:
    """``lookup_plain`` on one tensor of shards, the window ``[shard_lo,
    shard_lo + n_local)`` of an ``n_shards``-way route: a query owned
    outside it answers 0."""
    n_shards, cap = _window("hash_lookup", slots, shard_lo, n_shards)
    keys = slot_keys(slots).reshape(-1)
    counts = slot_counts(slots).reshape(-1)
    if k:
        queries = torch.minimum(queries, revcomp(queries, k))
    out = torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
    idx = torch.nonzero(queries != SENTINEL).reshape(-1)
    local, slot, mine = _homes(queries[idx], n_shards, shard_lo,
                               _geometry(slots)[0], cap)
    idx = idx[mine]
    q = queries[idx]
    flat = local[mine] * cap + slot[mine]
    for _ in range(cap):
        if not idx.numel():
            break
        cur = keys[flat]
        found = cur == q
        out[idx[found]] = counts[flat[found]]
        go = ~found & (cur != SENTINEL)
        idx, q, flat = idx[go], q[go], flat[go]
        # the next slot of the same shard
        flat = flat - (flat & (cap - 1)) + ((flat + 1) & (cap - 1))
    return out


# -- the kernels --------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = build.load("hash_table")
    if not getattr(lib, "_shk_bound", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.shk_hash_insert.argtypes = [p, i64, i32, i32, i32, p, p, p, p,
                                        i64, p, p]
        lib.shk_hash_insert.restype = ctypes.c_int
        lib.shk_hash_lookup.argtypes = [p, p, i64, i32, p, i64, i32, p, p]
        lib.shk_hash_lookup.restype = ctypes.c_int
        lib._shk_bound = True
    return lib


def _check_slots(entry: str, slots) -> tuple[int, int]:
    if (slots.dtype != torch.int64 or slots.dim() not in (2, 3)
            or slots.shape[-1] != 2 or not slots.is_contiguous()
            or slots.data_ptr() % 16):
        raise ValueError(f"{entry}: slots must be a contiguous, 16 B aligned "
                         f"int64 [cap, 2] or [S, cap, 2] tensor, got "
                         f"{slots.dtype} {tuple(slots.shape)}")
    n_shards, cap = _geometry(slots)
    if cap == 0 or cap & (cap - 1):
        raise ValueError(f"{entry}: capacity {cap} is not a power of two")
    if not 1 <= n_shards <= MAX_SHARDS:
        raise ValueError(f"{entry}: {n_shards} shards, at most {MAX_SHARDS}")
    return n_shards, cap


def _check_input(entry: str, slots, name: str, t, dtype, dim=1) -> None:
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{entry}: {name} must be a contiguous {dim}-D "
                         f"{dtype} tensor, got {t.dtype} {tuple(t.shape)}")
    if t.device != slots.device:
        raise ValueError(f"{entry}: {name} is on {t.device}, the table on "
                         f"{slots.device}")


def slot_pointers(groups, device) -> torch.Tensor:
    """The pointer table of ``hash_lookup`` over ``groups`` (tensors
    ``[n_d, cap, 2]``, the shards in order): int64 ``[S]`` on ``device``,
    the address of each shard's slot 0. Valid while the groups live."""
    rows = [g.data_ptr() + j * g.shape[1] * 16
            for g in groups for j in range(g.shape[0])]
    return torch.tensor(rows, dtype=torch.int64).to(device)


def hash_insert(slots, claims, kmers, amounts=None, shard_lo: int = 0,
                n_shards=None) -> None:
    """Add entries into the table ``slots`` in place, each in its owner's
    shard, and count the slots claimed into ``claims`` (int64, one per
    shard). The entries are ``kmers`` (int64 [n], SENTINEL skipped), each
    with its ``amounts`` entry (int32 u32 bit patterns) or 1; or another
    table's slots (int64 [n, 2], empty slots skipped: a rehash or a
    merge). ``slots`` may hold only the shards ``[shard_lo, shard_lo +
    n_local)`` of an ``n_shards``-way route (one group of a table on
    several devices): entries owned outside that window are skipped."""
    if slots.device.type == "cpu":
        insert_plain(slots, claims, kmers, amounts, shard_lo, n_shards)
        return
    if slots.device.type != "cuda":
        raise ValueError(f"hash_insert: unsupported device {slots.device}")
    n_local, cap = _check_slots("hash_insert", slots)
    n_shards, _ = _window("hash_insert", slots, shard_lo, n_shards)
    _check_input("hash_insert", slots, "claims", claims, torch.int64)
    if claims.shape[0] != n_local:
        raise ValueError(f"hash_insert: {claims.shape[0]} claim counters for "
                         f"{n_local} shards")
    src = None
    if kmers.dim() == 2:
        _check_input("hash_insert", slots, "source slots", kmers, torch.int64,
                     2)
        if kmers.shape[1] != 2 or kmers.data_ptr() % 16 or amounts is not None:
            raise ValueError("hash_insert: source slots must be a 16 B "
                             "aligned [n, 2] tensor, without amounts")
        src, kmers = kmers, None
    else:
        _check_input("hash_insert", slots, "kmers", kmers, torch.int64)
        if amounts is not None:
            _check_input("hash_insert", slots, "amounts", amounts, torch.int32)
            if amounts.shape != kmers.shape:
                raise ValueError("hash_insert: amounts and kmers differ in "
                                 "shape")
    n = (kmers if src is None else src).shape[0]
    if not n:
        return
    lib = _lib()
    overflow = torch.zeros(1, dtype=torch.int32, device=slots.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(slots.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shk_hash_insert(
            slots.data_ptr(), cap, n_local, shard_lo, n_shards,
            claims.data_ptr(), ptr(kmers), ptr(amounts), ptr(src), n,
            overflow.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hash_insert: CUDA launch failed (cudaError {rc})")
    hash_insert.launches += 1
    if int(overflow):
        raise RuntimeError(f"hash_insert: an entry found no slot in {cap} "
                           f"probes (table full)")


def hash_lookup(slots, queries, k: int = 0, pointers=None) -> torch.Tensor:
    """Counts (int32 u32 bit patterns) of int64 ``queries``, each in its
    owner's shard, 0 when absent or SENTINEL; ``k > 0`` looks up each
    query's canonical form (directional lookup). ``slots`` is one table
    (``[cap, 2]`` or ``[S, cap, 2]``), or a list of groups ``[n_d, cap,
    2]`` whose shards in order are the S shards, each group on any device
    the queries' device can read (``peer.check_readable``): one launch on
    the queries' device reads each shard through ``pointers``
    (``slot_pointers`` of the groups on that device; made here when not
    given)."""
    groups = [slots] if isinstance(slots, torch.Tensor) else list(slots)
    if queries.device.type == "cpu":
        for group in groups:
            peer.check_readable(queries.device, group.device)
        return lookup_plain(slots, queries, k)
    if queries.device.type != "cuda":
        raise ValueError(f"hash_lookup: unsupported device {queries.device}")
    caps = set()
    for group in groups:
        caps.add(_check_slots("hash_lookup", group)[1])
        peer.check_readable(queries.device, group.device)
    if len(caps) != 1:
        raise ValueError(f"hash_lookup: groups of capacities {sorted(caps)}")
    n_shards, cap = sum(_geometry(g)[0] for g in groups), caps.pop()
    if queries.dtype != torch.int64 or queries.dim() != 1 \
            or not queries.is_contiguous():
        raise ValueError("hash_lookup: queries must be contiguous 1-D int64")
    if not 0 <= k <= 31:
        raise ValueError(f"hash_lookup: k={k} out of range")
    if isinstance(slots, torch.Tensor):
        base, pointers = slots, None
    else:
        base = None
        if pointers is None:
            pointers = slot_pointers(groups, queries.device)
        if (pointers.dtype != torch.int64 or pointers.device != queries.device
                or tuple(pointers.shape) != (n_shards,)):
            raise ValueError(f"hash_lookup: the pointer table must be int64 "
                             f"[{n_shards}] on {queries.device}")
    n = queries.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=queries.device)
    if not n:
        return out
    lib = _lib()
    peer.wait_for_peers(queries.device, [g.device for g in groups])
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shk_hash_lookup(
            None if base is None else base.data_ptr(),
            None if pointers is None else pointers.data_ptr(), cap, n_shards,
            queries.data_ptr(), n, k, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hash_lookup: CUDA launch failed (cudaError {rc})")
    hash_lookup.launches += 1
    return out


hash_insert.launches = 0
hash_lookup.launches = 0
