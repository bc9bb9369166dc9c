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
empty), the u32 count at byte 8 and a 4 B pad word at byte 12 (0 in an
empty slot; the kernel keeps an insert's epoch there, the plain version
leaves it 0, and no reader takes it for part of a count); ``slot_keys``
and ``slot_counts`` are the int64 key view and the int32 count view (the
u32's bit pattern), each with a 16 B stride. A key lives in shard
``owner(key, S)``, the high bits of the SplitMix64 hash; its home slot
there is ``mix64(key) & (cap - 1)``, the low bits; collisions probe
linearly. Counts add modulo 2^32 under the JAX table's freeze rule,
read once a key a batch: a batch adds its sum for a key to a count that
was below ``SAT_THRESHOLD`` before the batch, and nothing to one at or
above it.
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
is one launch (an insert into groups: one a group). The insert kernel
runs a thread an entry: a hit is one load and one add, a claim one 16 B
compare-and-swap that writes the key, its count and the batch's epoch
together. The epoch (``new_epoch``: nonzero, never repeated in a
process) is how the kernel reads the freeze once a batch: the first add
of a batch to a key that was in the table before it is a 64-bit
compare-and-swap that writes the count and the epoch at once, and the
later ones see the epoch and add. Each launch draws its own epoch: a
batch split over groups writes each slot from one launch only (a group
takes just the keys its window owns), so no slot meets two epochs of one
batch.
``<wrapper>.launches`` counts the wrapper's kernel launches. The
kernel's claims race, so its slot layout may differ from the plain
version's; the table's contents (each key and its count) and
its claim counts do not; neither does the count of any key, on any
launch.

``LookupWaves`` is the lookup as the sPCR graph extension issues it, a
wave at a time from several gene threads: numpy uint64 queries in,
numpy uint32 counts out. The queries are copied into the calling
thread's pinned staging buffer, one foreign call
(``shk_hash_lookup_wave``, without the GIL) launches ``hash_lookup``'s
kernel on the thread's own stream and waits for that stream alone, and
the counts are copied out of the staging buffer: two numpy copies of
cached buffers, where handing the caller's arrays to ctypes would build
an object for each address. The wave is zero copy: the kernel reads and
writes the pinned buffers across the host link. Both sentinels
(``SENTINEL`` and the JAX package's all-ones ``KMER_SENTINEL``) answer 0
in the kernel, so the queries need no translation. A wave launches once
and counts into ``hash_lookup.launches``. Its stream does
not follow torch's: a table's ``WriteFence`` records an event after
each write, and a thread's stream waits on it before its first wave
after the write.
"""

from __future__ import annotations

import ctypes
import itertools
import threading
import weakref

import numpy as np
import torch

from ..device import indexed
from ..ops.histogram import revcomp
from ..ops.keys import SENTINEL, keys_to_device
from ..utils import phases
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
_epochs = itertools.count(1)


def new_epoch() -> int:
    """A batch's epoch for ``hash_insert``: in [1, 2^32), a new one each
    call (2^32 - 1 batches a process before one repeats)."""
    return (next(_epochs) - 1) % U32 + 1


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
                                        i64, ctypes.c_uint32, p, p]
        lib.shk_hash_insert.restype = ctypes.c_int
        lib.shk_hash_lookup.argtypes = [p, p, i64, i32, p, i64, i32, p, p]
        lib.shk_hash_lookup.restype = ctypes.c_int
        lib.shk_hash_lookup_wave.argtypes = [i32, p, p, i64, i32, i32, i64,
                                             p, p, p]
        lib.shk_hash_lookup_wave.restype = ctypes.c_int
        lib.shk_mapped_pointer.argtypes = [p, ctypes.POINTER(p)]
        lib.shk_mapped_pointer.restype = ctypes.c_int
        lib.shk_stream_create.argtypes = [i32, ctypes.POINTER(p)]
        lib.shk_stream_create.restype = ctypes.c_int
        lib.shk_stream_destroy.argtypes = [p]
        lib.shk_stream_destroy.restype = ctypes.c_int
        lib.shk_stream_wait_event.argtypes = [i32, p, p]
        lib.shk_stream_wait_event.restype = ctypes.c_int
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
    with phases.sync("pointers.upload"):
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
            new_epoch(), overflow.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hash_insert: CUDA launch failed (cudaError {rc})")
    hash_insert.launches += 1
    with phases.sync("insert.overflow"):
        overflow = int(overflow)
    if overflow:
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


# -- the wave path ------------------------------------------------------------

_generations = itertools.count(1)
_launches_lock = threading.Lock()
_threads = threading.local()


class WriteFence:
    """Orders a table's lookup waves after its writes. Each wave
    thread's stream runs beside torch's streams, on which a table's
    writes (the slots' fill, inserts, merges, grows, the pointer table)
    are queued: ``written`` records an event on the current stream of
    each of the table's CUDA devices and takes a new generation, and a
    thread waits on the events before its first wave of a generation it
    has not seen (``LookupWaves``)."""

    def __init__(self, devices):
        self.events = ()
        self.generation = 0
        self.written(devices)

    def written(self, devices) -> None:
        """Mark the table on ``devices`` as written by the work queued so
        far on their current streams."""
        events = []
        for device in dict.fromkeys(indexed(d) for d in devices):
            if device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(device))
                events.append(event)
        self.events = tuple(events)
        self.generation = next(_generations)


def _mapped(lib, t: torch.Tensor) -> int:
    """The device address of pinned tensor ``t``; raises when the
    memory is not mapped into the card's address space."""
    address = ctypes.c_void_p()
    rc = lib.shk_mapped_pointer(t.data_ptr(), ctypes.byref(address))
    if rc != 0:
        raise RuntimeError(f"hash_lookup: pinned memory at {t.data_ptr():#x} "
                           f"is not mapped for the card (rc {rc})")
    return address.value


class _WaveStream:
    """One thread's stream on one card and its pinned staging of
    queries and counts (``q``, ``out``: numpy views; the kernel reads and
    writes them through their device addresses), grown to the largest
    wave seen."""

    def __init__(self, lib, device: torch.device):
        self.device = device
        handle = ctypes.c_void_p()
        rc = lib.shk_stream_create(device.index, ctypes.byref(handle))
        if rc != 0:
            raise RuntimeError(f"hash_lookup: no stream on {device} "
                               f"(cudaError {rc})")
        self.stream = handle.value
        weakref.finalize(self, lib.shk_stream_destroy, self.stream)
        self.generation = None
        self.staged = 0

    def follow(self, lib, fence: WriteFence) -> None:
        """Order this stream's next waves after the fence's writes."""
        generation = fence.generation
        for event in fence.events:
            rc = lib.shk_stream_wait_event(self.device.index, self.stream,
                                           event.cuda_event)
            if rc != 0:
                raise RuntimeError(f"hash_lookup: waiting on a table write "
                                   f"failed (cudaError {rc})")
        self.generation = generation

    def stage(self, lib, n: int) -> None:
        """Grow the staging to hold a wave of ``n`` queries."""
        if n > self.staged:
            size = 1 << max(12, (n - 1).bit_length())
            stage_q = torch.empty(size, dtype=torch.int64, pin_memory=True)
            stage_out = torch.empty(size, dtype=torch.int32, pin_memory=True)
            self.q = stage_q.numpy().view(np.uint64)
            self.out = stage_out.numpy().view(np.uint32)
            self.mapped = (_mapped(lib, stage_q), _mapped(lib, stage_out))
            self.staged, self.pinned = size, (stage_q, stage_out)


def _wave_stream(lib, device: torch.device) -> _WaveStream:
    """The calling thread's ``_WaveStream`` on ``device``."""
    streams = getattr(_threads, "streams", None)
    if streams is None:
        streams = _threads.streams = {}
    state = streams.get(device.index)
    if state is None:
        state = streams[device.index] = _WaveStream(lib, device)
    return state


class LookupWaves:
    """``hash_lookup`` a wave at a time, numpy in and numpy out, on one
    table: ``slots`` as ``hash_lookup`` takes it (one tensor, or a list of
    groups read through their pointer table), launched on ``device``,
    ordered after the writes ``fence`` records. Made once a table (and
    again when a grow replaces its slots); the checks run here, not a
    wave. On the CPU each wave runs ``lookup_plain`` on the codec's keys."""

    def __init__(self, slots, device, fence: WriteFence):
        self.slots, self.fence = slots, fence
        self.device = indexed(device)
        groups = [slots] if isinstance(slots, torch.Tensor) else list(slots)
        for group in groups:
            peer.check_readable(self.device, group.device)
        if self.device.type == "cpu":
            return
        if self.device.type != "cuda":
            raise ValueError(f"hash_lookup: unsupported device {self.device}")
        caps = {_check_slots("hash_lookup", g)[1] for g in groups}
        if len(caps) != 1:
            raise ValueError(f"hash_lookup: groups of capacities "
                             f"{sorted(caps)}")
        n_shards = sum(_geometry(g)[0] for g in groups)
        self.lib = _lib()
        if isinstance(slots, torch.Tensor):
            self.pointers, table = None, (slots.data_ptr(), None)
        else:
            self.pointers = slot_pointers(groups, self.device)
            table = (None, self.pointers.data_ptr())
            # the pointer table's copy is a write the waves must follow
            fence.written([self.device])
        self.table = (*table, caps.pop(), n_shards)

    def __call__(self, queries, k: int = 0) -> np.ndarray:
        """Counts (uint32) of ``queries`` (numpy uint64, or int64 bit
        patterns, a CPU tensor too; either sentinel answers 0), each
        looked up in its canonical form when ``k > 0``."""
        q = np.asarray(queries, dtype=np.uint64).reshape(-1)
        if not 0 <= k <= 31:
            raise ValueError(f"hash_lookup: k={k} out of range")
        if self.device.type == "cpu":
            return lookup_plain(self.slots, keys_to_device(q, "cpu"),
                                k).numpy().view(np.uint32)
        n = q.shape[0]
        if not n:
            return np.empty(0, dtype=np.uint32)
        lib = self.lib
        state = _wave_stream(lib, self.device)
        if state.generation != self.fence.generation:
            state.follow(lib, self.fence)
        state.stage(lib, n)
        state.q[:n] = q
        # the foreign call synchronises its stream before it returns
        with phases.sync("lookup.wave"):
            rc = lib.shk_hash_lookup_wave(self.device.index, *self.table, k,
                                          n, *state.mapped, state.stream)
        if rc != 0:
            raise RuntimeError(f"hash_lookup: the wave failed (cudaError "
                               f"{rc})")
        with _launches_lock:
            hash_lookup.launches += 1
        return state.out[:n].copy()
