// Open-addressed k-mer count table of the hash backend, for Hopper (sm_90a):
// hash_insert and hash_lookup.
//
// The table is one array of 16 B slots, `cap` of them a table (a power of
// two): the int64 key at byte 0 (INT64_MAX, the port's SENTINEL, for an empty
// slot), the uint32 count at byte 8, and a 4 B pad word at byte 12: the
// epoch of the last insert that added to the slot (below), 0 in an empty
// slot, never part of a count. A sharded table is S such tables, in one
// [S, cap] allocation or in groups of them, and each key lives in the shard
// owner(key, S) (mix64.cuh: the high bits of mix64).
// A key's home slot is mix64(key) & (cap - 1) in its shard, the SplitMix64
// finalizer's low bits; collisions probe linearly. A slot goes from empty to
// a key once and never changes again.
//
// They replace the XLA programs of sharkmer_tpu/ops/hashtable.py (no Pallas
// kernel there: torch has no op that inserts into or probes a hash table):
//   * hash_insert: _insert_kernel (:69-121, claim/probe rounds of masked
//     scatters in a lax.while_loop) and _rehash_kernel (:308-315, the same
//     insert fed with the old table's slots); with S shards, the shard_map
//     bodies of sharkmer_tpu/parallel/sharded_table.py (all_gather the batch,
//     mask each shard's keys, insert locally), in one launch;
//   * hash_lookup: _lookup_kernel (:199-222, the probe loop) and
//     _lookup_directional_kernel (:301-305, revcomp, min, probe); with S
//     shards, the masked lookups and their psum.
//
// What bounds them: random 32 B sectors of device memory. A 2^27-slot table is
// 2 GiB, far past the 50 MB L2, so every entry's first probe misses to DRAM,
// and the work is the number of sectors touched, not the bytes streamed. The
// design spends one sector and as few atomics an entry as it can:
//   * a slot holds its key and its count in one 16 B load (ld.global.cg: L2,
//     the point of coherence of the atomics, never a stale L1 line). A hit
//     adds to the sector it just loaded; a claim swaps the whole slot, key
//     and count, in one 16 B compare-and-swap of that same sector, already
//     in L2. The two-array layout this replaces paid a key sector and a
//     count sector an entry;
//   * owner routing inside the kernel: each entry's shard comes from the hash
//     it needs for its home slot anyway, so a sharded insert or lookup reads
//     its batch once, in one launch, where S launches on S masked copies
//     read it S times. Shards placed on several cards (parallel/) are D
//     groups of contiguous shards: an insert launches once per group on the
//     group's card with the group's window [shard_lo, shard_lo + n_local)
//     and skips the entries another group owns (the JAX all-gather and
//     mask, done from the hash the kernel computes anyway), so every write
//     stays on its owner's card: remote atomics over NVLink would add to
//     a kernel that atomics and dependent misses bound already. A lookup
//     reads each shard through a per-shard pointer table, so one launch on
//     the querying card answers every query from its owner's slots,
//     wherever they live (JAX masks each shard and psums: D launches);
//   * a claim counter: the slots an insert claims are counted into a device
//     int64 per shard (per warp a __ballot_sync, then __match_any_sync on the
//     shard and __popc; per block in shared memory; one global atomicAdd per
//     block and shard), so the table's occupancy is one number to read
//     instead of a sweep of the table.
// The rehash of a grow and a merge feed the insert another table's slots
// ([n, 2] int64): key and count in one 16 B load, empty slots skipped. A
// sharded grow is one launch: the owner does not depend on the capacity, so
// every key routes to the shard it came from. That order is already near the
// destination's address order: a source key's home in a table of cap_d slots
// is its slot in the source (within its probe run) plus a multiple of cap_s.
//
// hash_insert, per entry: load the slot; if it holds the entry's key, add
// under the freeze rule below; if it is empty, claim it with one 16 B
// compare-and-swap of the whole slot: the key, the amount as its count and
// the launch's epoch as its pad (atom.global.cas.b128, sm_90; an empty
// slot's count and pad words are 0). A thread that finds its own key there
// adds as on a hit, one that finds another key steps to the next slot. One
// atomic a new key, where a CAS of the key word and then an add took two.
// All entries of one key follow the same probe sequence and find the same
// slot, whatever order they run in. Probes are capped at `cap`; a thread
// that runs out sets *overflow, and the wrapper raises on it (the growth
// rule keeps the load at 0.7).
//
// The freeze is the JAX table's: it reads `count >= SAT_THRESHOLD`
// (0xE0000000) once a claim/probe round, and all entries of a key land in
// the same round, so a batch computes new = old + (old < T ? the batch's
// sum for the key : 0), modulo 2^32 as its u32 scatter-add. A thread
// cannot see `old` once other entries of its key have added, so the
// batch's first add marks the slot: a launch gets a nonzero epoch that no
// earlier launch had (kernels/hash.py; a batch split over groups writes each
// slot from one launch only), and an add decides on the
// 8 B count word (count and pad) it loaded with the slot. A pad equal to
// the epoch means an entry of this batch has added, which it did only
// below T: add, a 32-bit atomicAdd (a hit is then a load and one add). A
// stale pad means the count is still `old`: at or above T it is frozen and
// nothing is added; below T one 64-bit compare-and-swap writes old +
// amount and the epoch at once, and on a race retries with the word it
// found. A key that was in the table before the batch pays one CAS; the
// result is the same on every launch. Hot keys still serialise their
// atomicAdds on one address, and a batch in the reads' order sends a warp's
// 32 loads to 32 unrelated sectors: a partition of the batch into home
// windows, with each key's amounts summed in shared memory before one
// insert, was built and timed against this kernel and lost at every shape
// but an all-hits batch (PERF.md).
//
// hash_lookup, per query: answer 0 to either sentinel (the port's SENTINEL,
// and KMER_SENTINEL, all ones, the JAX package's pad: no key is >= 4^31, so
// neither is a key, and the host needs no translation), canonicalize when
// k > 0 (min of the key and its reverse complement), route, then probe with
// one 16 B load a step until the key (its count is in the same load) or an
// empty slot. On the card, a wave of a few hundred to a few thousand queries
// is one dependent chain of ~2.5 us: the query, then its slot sector from
// DRAM.
//
// A wave of the sPCR graph extension starts and ends on the host, as numpy,
// so what bounds it is the host around that chain: the launch, the link's
// latency, the synchronisation, and whatever the host does between them (a
// dozen torch calls, a pageable copy each way and, on a stream shared by
// the gene threads, a wait on every other thread's work: ~0.1 ms a wave
// through the tensor wrapper, PERF.md). The wave path does the least the
// card needs: a numpy copy into the calling thread's pinned staging buffer,
// one foreign call (shk_hash_lookup_wave, which ctypes makes without the
// GIL) that launches on the thread's own stream and waits for that stream
// alone, and a numpy copy of the counts out. The wave is zero copy: the
// kernel loads its queries from the pinned buffer across the host link and
// stores its counts there (mapped memory under unified addressing), one
// link round trip in place of two copies. Copying a wave in and out of
// device buffers lost at every size timed, up to 2^20 queries, where the
// host's copies into and out of the staging buffers outweigh either. What
// is left is the launch and the synchronisation, ~13-15 us of a ~20 us
// wave (PERF.md).
//
// Neither kernel multiplies matrices, and a TMA tile does not help single
// scattered sectors: no wgmma, no TMA here.
//
// Plain C interface, bound with ctypes: shk_hash_insert and shk_hash_lookup
// launch on the given stream, do not synchronise, allocate nothing, and
// return cudaGetLastError() after their launch (0 = success).
// shk_hash_lookup_wave also synchronises its stream before it returns; the
// caller allocates its buffers and streams (kernels/hash.py).

#include <cstdint>

#include <cuda_runtime.h>

#include "mix64.cuh"

namespace {

using u64 = unsigned long long;
using shk::mix64;

constexpr u64 kEmpty = 0x7FFFFFFFFFFFFFFFull;  // ops/keys.py SENTINEL
constexpr u64 kAllOnes = ~0ull;                 // KMER_SENTINEL
constexpr unsigned int kSat = 0xE0000000u;      // SAT_THRESHOLD
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// Reverse complement of a k-mer of k 2-bit bases (< 4^k): complement is NOT,
// base reversal swaps 2-bit groups, nibbles, bytes, half-words and words,
// and a shift lands the k bases in the low 2k bits (ops/histogram.revcomp).
__device__ __forceinline__ u64 revcomp(u64 key, int k) {
  u64 x = ~key;
  x = ((x & 0x3333333333333333ull) << 2) | ((x >> 2) & 0x3333333333333333ull);
  x = ((x & 0x0F0F0F0F0F0F0F0Full) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0Full);
  x = ((x & 0x00FF00FF00FF00FFull) << 8) | ((x >> 8) & 0x00FF00FF00FF00FFull);
  x = ((x & 0x0000FFFF0000FFFFull) << 16) |
      ((x >> 16) & 0x0000FFFF0000FFFFull);
  x = (x << 32) | (x >> 32);
  return x >> (64 - 2 * k);
}

// One slot, key and count word, in one 16 B load through L2.
__device__ __forceinline__ void load_slot(const u64* p, u64& key, u64& word) {
  asm volatile("ld.global.cg.v2.u64 {%0, %1}, [%2];"
               : "=l"(key), "=l"(word)
               : "l"(p)
               : "memory");
}

// One 16 B slot of a table that does not change during the call.
__device__ __forceinline__ void load_slot_nc(const u64* p, u64& key,
                                             u64& word) {
  asm("ld.global.nc.v2.u64 {%0, %1}, [%2];"
      : "=l"(key), "=l"(word)
      : "l"(p));
}

// Add `amount` to slot p's count under the freeze rule, from `word`, the
// slot's count word (the u32 count, the pad above it) as this thread loaded
// it: a pad of this batch's `epoch` adds; a stale pad skips a frozen count
// and swaps old + amount and the epoch into a live one.
__device__ __forceinline__ void add_count(u64* p, u64 word,
                                          unsigned int amount,
                                          unsigned int epoch) {
  if (amount == 0u) return;
  for (;;) {
    const unsigned int count = static_cast<unsigned int>(word);
    if (static_cast<unsigned int>(word >> 32) == epoch) {
      atomicAdd(reinterpret_cast<unsigned int*>(p + 1), amount);
      return;
    }
    if (count >= kSat) return;  // frozen before this batch
    const u64 marked =
        (static_cast<u64>(epoch) << 32) | static_cast<u64>(count + amount);
    const u64 seen = atomicCAS(p + 1, word, marked);
    if (seen == word) return;
    word = seen;
  }
}

// The shard of a key from its hash (mix64.cuh owner, without hashing twice).
__device__ __forceinline__ int shard_of(u64 h, int n_shards) {
  return n_shards > 1 ? shk::owner_of_hash(h, n_shards) : 0;
}

// Claim the empty slot p for `key` with `amount` as its count and `epoch`
// as its pad, in one 16 B compare-and-swap (sm_90; an empty slot's count
// and pad words are 0): true when this thread claimed it; else `prev` holds
// the key found there, and when that is `key`, the amount is added as on a
// hit.
__device__ __forceinline__ bool claim(u64* p, u64 key, unsigned int amount,
                                      unsigned int epoch, u64& prev) {
  u64 word;
  asm volatile(
      "{\n\t.reg .b128 d, b, c;\n\t"
      "mov.b128 b, {%2, %3};\n\t"
      "mov.b128 c, {%4, %5};\n\t"
      "atom.global.cas.b128 d, [%6], b, c;\n\t"
      "mov.b128 {%0, %1}, d;\n\t}"
      : "=l"(prev), "=l"(word)
      : "l"(kEmpty), "l"(0ull), "l"(key),
        "l"((static_cast<u64>(epoch) << 32) | static_cast<u64>(amount)),
        "l"(p)
      : "memory");
  if (prev == kEmpty) return true;
  if (prev == key) add_count(p, word, amount, epoch);
  return false;
}

// Insert one entry whose key hashes to `h`; returns true when this thread
// claimed an empty slot.
__device__ __forceinline__ bool insert_one(u64* table, u64 mask, int64_t cap,
                                           u64 h, u64 key,
                                           unsigned int amount,
                                           unsigned int epoch,
                                           int* overflow) {
  u64 slot = h & mask;
  for (int64_t probes = 0;; ++probes) {
    if (probes == cap) {
      atomicExch(overflow, 1);
      return false;
    }
    u64* p = table + 2 * slot;
    u64 cur, word;
    load_slot(p, cur, word);
    if (cur == key) {
      add_count(p, word, amount, epoch);
      return false;
    }
    if (cur == kEmpty) {
      u64 prev;
      if (claim(p, key, amount, epoch, prev)) return true;
      if (prev == key) return false;
    }
    slot = (slot + 1) & mask;
  }
}

__global__ void __launch_bounds__(kThreads)
hash_insert_kernel(u64* __restrict__ slots, int64_t cap, int n_local,
                   int shard_lo, int n_shards, u64* __restrict__ claims,
                   const u64* __restrict__ kmers,
                   const unsigned int* __restrict__ amounts,
                   const u64* __restrict__ src, int64_t n,
                   unsigned int epoch, int* __restrict__ overflow) {
  extern __shared__ u64 block_claims[];  // [n_local]
  for (int s = threadIdx.x; s < n_local; s += kThreads) block_claims[s] = 0;
  __syncthreads();

  const u64 mask = static_cast<u64>(cap) - 1;
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // warp-uniform trip count, so that every lane reaches the ballot
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads +
                      (threadIdx.x & ~31);
       base < n; base += stride) {
    const int64_t i = base + lane;
    bool claimed = false;
    int local = 0;
    if (i < n) {
      u64 key;
      unsigned int amount;
      if (src != nullptr) {  // another table's slot: key and count at once
        u64 word;
        load_slot_nc(src + 2 * i, key, word);
        amount = static_cast<unsigned int>(word);  // not the source's pad
      } else {
        key = kmers[i];
        amount = amounts == nullptr ? 1u : amounts[i];
      }
      if (key != kEmpty) {
        const u64 h = mix64(key);
        local = shard_of(h, n_shards) - shard_lo;
        // the window: an entry another group owns is that group's
        if (local >= 0 && local < n_local) {
          claimed = insert_one(slots + 2 * static_cast<u64>(local) * cap,
                               mask, cap, h, key, amount, epoch,
                               overflow);
        }
      }
    }
    const unsigned int who = __ballot_sync(0xFFFFFFFFu, claimed);
    if (claimed) {
      const unsigned int peers =
          n_local > 1 ? __match_any_sync(who, local) : who;
      if (lane == __ffs(peers) - 1) {
        atomicAdd(&block_claims[local], static_cast<u64>(__popc(peers)));
      }
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n_local; s += kThreads) {
    if (block_claims[s] != 0) atomicAdd(&claims[s], block_claims[s]);
  }
}

__global__ void __launch_bounds__(kThreads)
hash_lookup_kernel(const u64* __restrict__ slots,
                   const int64_t* __restrict__ shard_slots, int64_t cap,
                   int n_shards, const u64* __restrict__ queries, int64_t n,
                   int k, unsigned int* __restrict__ out) {
  const u64 mask = static_cast<u64>(cap) - 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    u64 key = queries[i];
    unsigned int result = 0;
    if (key != kEmpty && key != kAllOnes) {
      if (k > 0) {
        const u64 rc = revcomp(key, k);
        key = rc < key ? rc : key;
      }
      const u64 h = mix64(key);
      const int shard = shard_of(h, n_shards);
      // the owner's slots: through the pointer table when the shards live
      // in separate allocations (on this card or a peer), else in one
      const u64* table =
          shard_slots != nullptr
              ? reinterpret_cast<const u64*>(__ldg(shard_slots + shard))
              : slots + 2 * static_cast<u64>(shard) * cap;
      u64 slot = h & mask;
      for (int64_t probes = 0; probes < cap; ++probes) {
        u64 cur, word;
        load_slot_nc(table + 2 * slot, cur, word);
        if (cur == key) {
          result = static_cast<unsigned int>(word);
          break;
        }
        if (cur == kEmpty) break;
        slot = (slot + 1) & mask;
      }
    }
    out[i] = result;
  }
}

int blocks_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" {

// slots: n_local tables of `cap` 16 B slots, [n_local, cap, 2] int64, 16 B
// aligned: shards [shard_lo, shard_lo + n_local) of an n_shards-way owner
// route (shard_lo 0 and n_local == n_shards: the whole table); claims:
// [n_local] int64, each local shard's count of claimed slots, incremented
// here. Entries: either kmers [n] int64 (SENTINEL skipped) with amounts [n]
// uint32 or NULL (each entry adds 1), or src [n, 2] int64, another table's
// slots (kmers and amounts NULL; empty slots skipped). Entries owned by a
// shard outside the window are skipped. epoch: the launch's, nonzero and
// never one an earlier launch wrote into these slots (the freeze rule; 0 is
// refused). overflow: one int, set to 1 when an
// entry found no slot in `cap` probes.
int shk_hash_insert(int64_t* slots, int64_t cap, int n_local, int shard_lo,
                    int n_shards, int64_t* claims, const int64_t* kmers,
                    const int* amounts, const int64_t* src, int64_t n,
                    unsigned int epoch, int* overflow, cudaStream_t stream) {
  if (epoch == 0u) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  hash_insert_kernel<<<blocks_for(n), kThreads, n_local * sizeof(u64),
                       stream>>>(
      reinterpret_cast<u64*>(slots), cap, n_local, shard_lo, n_shards,
      reinterpret_cast<u64*>(claims), reinterpret_cast<const u64*>(kmers),
      reinterpret_cast<const unsigned int*>(amounts),
      reinterpret_cast<const u64*>(src), n, epoch, overflow);
  return static_cast<int>(cudaGetLastError());
}

// queries [n] int64 (SENTINEL and all ones answer 0), each answered by its
// owner shard of n_shards; k > 0 canonicalizes each query first
// (directional lookup); out [n] uint32 counts, 0 when absent. The shards
// are either one [n_shards, cap, 2] allocation at `slots` (shard_slots
// NULL), or anywhere this card can read: shard_slots [n_shards] int64 on
// this card holds the address of each shard's slot 0 (slots unused).
int shk_hash_lookup(const int64_t* slots, const int64_t* shard_slots,
                    int64_t cap, int n_shards, const int64_t* queries,
                    int64_t n, int k, int* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  hash_lookup_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      reinterpret_cast<const u64*>(slots), shard_slots, cap, n_shards,
      reinterpret_cast<const u64*>(queries), n, k,
      reinterpret_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One lookup wave on `stream` of card `device` (made current for the call,
// and the caller's card restored): the kernel reads the wave's n int64
// queries at `q` and writes their uint32 counts at `out`, the device
// addresses of the caller's pinned staging buffers (zero copy: it loads and
// stores across the host link). SENTINEL and all ones answer 0. The table
// arguments are shk_hash_lookup's. Returns after the stream has ended its
// work (the buffers free again, the counts in place), 0 on success, else the
// first cudaError.
int shk_hash_lookup_wave(int device, const int64_t* slots,
                         const int64_t* shard_slots, int64_t cap,
                         int n_shards, int k, int64_t n, const int64_t* q,
                         int* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  int caller = device;
  cudaError_t rc = cudaGetDevice(&caller);
  if (rc == cudaSuccess && caller != device) rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  hash_lookup_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      reinterpret_cast<const u64*>(slots), shard_slots, cap, n_shards,
      reinterpret_cast<const u64*>(q), n, k,
      reinterpret_cast<unsigned int*>(out));
  rc = cudaGetLastError();
  // wait even after a failure: nothing may still use the buffers
  const cudaError_t done = cudaStreamSynchronize(stream);
  if (rc == cudaSuccess) rc = done;
  if (caller != device) cudaSetDevice(caller);
  return static_cast<int>(rc);
}

// The device address of pinned host memory at `host` (torch's pinned
// memory): 0 and *device set when the memory is
// page-locked host memory mapped into the card's address space, -1 when it
// is not, else the cudaError.
int shk_mapped_pointer(const void* host, void** device) {
  cudaPointerAttributes attr;
  const cudaError_t rc = cudaPointerGetAttributes(&attr, host);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr) {
    return -1;
  }
  *device = attr.devicePointer;
  return 0;
}

// A stream of its own on card `device` for one thread's waves: it does not
// wait on the legacy default stream, on which torch queues the table's
// writes, so shk_stream_wait_event orders a wave after them.
int shk_stream_create(int device, cudaStream_t* stream) {
  int caller = device;
  cudaError_t rc = cudaGetDevice(&caller);
  if (rc == cudaSuccess) rc = cudaSetDevice(device);
  if (rc == cudaSuccess) {
    rc = cudaStreamCreateWithFlags(stream, cudaStreamNonBlocking);
    cudaSetDevice(caller);
  }
  return static_cast<int>(rc);
}

int shk_stream_destroy(cudaStream_t stream) {
  return static_cast<int>(cudaStreamDestroy(stream));
}

// Make `stream` (on card `device`) wait for `event`, recorded on any card.
int shk_stream_wait_event(int device, cudaStream_t stream, cudaEvent_t event) {
  int caller = device;
  cudaError_t rc = cudaGetDevice(&caller);
  if (rc == cudaSuccess && caller != device) rc = cudaSetDevice(device);
  if (rc == cudaSuccess) rc = cudaStreamWaitEvent(stream, event, 0);
  if (caller != device) cudaSetDevice(caller);
  return static_cast<int>(rc);
}

}  // extern "C"
