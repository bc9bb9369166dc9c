// Open-addressed k-mer count table of the hash backend, for Hopper (sm_90a):
// hash_insert and hash_lookup.
//
// The table is one array of 16 B slots, `cap` of them a table (a power of
// two): the int64 key at byte 0 (INT64_MAX, the port's SENTINEL, for an empty
// slot), the uint32 count at byte 8, and 4 B of zero padding. A sharded table
// is S such tables in one [S, cap] allocation, and each key lives in the shard
// owner(key, S) (mix64.cuh: the high bits of mix64). A key's home slot is
// mix64(key) & (cap - 1) in its shard, the SplitMix64 finalizer's low bits;
// collisions probe linearly. A slot goes from empty to a key once and never
// changes again.
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
// design spends one sector an entry where it can:
//   * a slot holds its key and its count in one 16 B load (ld.global.cg: L2,
//     the point of coherence of the atomics, never a stale L1 line). A hit
//     adds to the sector it just loaded; a claim CASes the key word and adds
//     to the count word of that same sector, already in L2. The two-array
//     layout this replaces paid a key sector and a count sector an entry;
//   * owner routing inside the kernel: each entry's shard comes from the hash
//     it needs for its home slot anyway, so a sharded insert or lookup reads
//     its batch once, in one launch, where S launches on S masked copies
//     read it S times;
//   * a claim counter: the slots an insert claims are counted into a device
//     int64 per shard (per warp a __ballot_sync, then __match_any_sync on the
//     shard and __popc; per block in shared memory; one global atomicAdd per
//     block and shard), so the table's occupancy is one number to read
//     instead of a sweep of the table.
// The rehash of a grow and a merge feed the insert another table's slots
// ([n, 2] int64): key and count in one 16 B load, empty slots skipped. A
// sharded grow is one launch: the owner does not depend on the capacity, so
// every key routes to the shard it came from.
//
// hash_insert, per entry: load the slot; if it holds the entry's key, add
// (unless the loaded count is at or above SAT_THRESHOLD, 0xE0000000: the JAX
// table's freeze, read per entry where JAX reads it per round; the two agree
// unless one batch carries a count across the threshold, ~3.76e9 adds); if it
// is empty, CAS the key word: a thread that claims the slot adds to its zero
// count, one that finds its own key there re-reads the count (an L2 hit) and
// adds as on a hit; any other key steps to the next slot. All entries of one
// key follow the same probe sequence and find the same slot, whatever order
// they run in. The add is a 32-bit atomicAdd, modulo 2^32 as JAX's u32
// scatter-add. Probes are capped at `cap`; a thread that runs out sets
// *overflow, and the wrapper raises on it (the growth rule keeps the load
// at 0.7). Hot keys still serialise their atomicAdds on one address.
//
// hash_lookup, per query: canonicalize when k > 0 (min of the key and its
// reverse complement), route, then probe with one 16 B load a step until the
// key (its count is in the same load) or an empty slot. A wave of a few
// thousand queries is one dependent chain: the query, then its slot sector
// from DRAM.
//
// Neither kernel multiplies matrices, and a TMA tile does not help single
// scattered sectors: no wgmma, no TMA here.
//
// Plain C interface, bound with ctypes: each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after its launch (0 = success).

#include <cstdint>

#include <cuda_runtime.h>

#include "mix64.cuh"

namespace {

using u64 = unsigned long long;
using shk::mix64;

constexpr u64 kEmpty = 0x7FFFFFFFFFFFFFFFull;  // ops/keys.py SENTINEL
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

// The slot's count alone, through L2 (after a lost claim race).
__device__ __forceinline__ unsigned int load_count(const u64* p) {
  unsigned int c;
  asm volatile("ld.global.cg.u32 %0, [%1];" : "=r"(c) : "l"(p + 1) : "memory");
  return c;
}

// One 16 B slot of a table that does not change during the call.
__device__ __forceinline__ void load_slot_nc(const u64* p, u64& key,
                                             u64& word) {
  asm("ld.global.nc.v2.u64 {%0, %1}, [%2];"
      : "=l"(key), "=l"(word)
      : "l"(p));
}

__device__ __forceinline__ void add_count(u64* p, unsigned int count,
                                          unsigned int amount) {
  if (amount != 0u && count < kSat) {
    atomicAdd(reinterpret_cast<unsigned int*>(p + 1), amount);
  }
}

// The shard of a key from its hash (mix64.cuh owner, without hashing twice).
__device__ __forceinline__ int shard_of(u64 h, int n_shards) {
  return n_shards > 1 ? shk::owner_of_hash(h, n_shards) : 0;
}

// Insert one entry; returns true when this thread claimed an empty slot.
__device__ __forceinline__ bool insert_one(u64* table, u64 mask, int64_t cap,
                                           u64 h, u64 key,
                                           unsigned int amount,
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
      add_count(p, static_cast<unsigned int>(word), amount);
      return false;
    }
    if (cur == kEmpty) {
      const u64 prev = atomicCAS(p, kEmpty, key);
      if (prev == kEmpty) {  // claimed: the count is 0
        add_count(p, 0u, amount);
        return true;
      }
      if (prev == key) {
        add_count(p, load_count(p), amount);
        return false;
      }
    }
    slot = (slot + 1) & mask;
  }
}

__global__ void __launch_bounds__(kThreads)
hash_insert_kernel(u64* __restrict__ slots, int64_t cap, int n_shards,
                   u64* __restrict__ claims, const u64* __restrict__ kmers,
                   const unsigned int* __restrict__ amounts,
                   const u64* __restrict__ src, int64_t n,
                   int* __restrict__ overflow) {
  extern __shared__ u64 block_claims[];  // [max(n_shards, 1)]
  const int n_counters = n_shards > 1 ? n_shards : 1;
  for (int s = threadIdx.x; s < n_counters; s += kThreads) block_claims[s] = 0;
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
    int shard = 0;
    if (i < n) {
      u64 key;
      unsigned int amount;
      if (src != nullptr) {  // another table's slot: key and count at once
        u64 word;
        load_slot_nc(src + 2 * i, key, word);
        amount = static_cast<unsigned int>(word);
      } else {
        key = kmers[i];
        amount = amounts == nullptr ? 1u : amounts[i];
      }
      if (key != kEmpty) {
        const u64 h = mix64(key);
        shard = shard_of(h, n_shards);
        claimed = insert_one(slots + 2 * static_cast<u64>(shard) * cap, mask,
                             cap, h, key, amount, overflow);
      }
    }
    const unsigned int who = __ballot_sync(0xFFFFFFFFu, claimed);
    if (claimed) {
      const unsigned int peers =
          n_shards > 1 ? __match_any_sync(who, shard) : who;
      if (lane == __ffs(peers) - 1) {
        atomicAdd(&block_claims[shard], static_cast<u64>(__popc(peers)));
      }
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n_counters; s += kThreads) {
    if (block_claims[s] != 0) atomicAdd(&claims[s], block_claims[s]);
  }
}

__global__ void __launch_bounds__(kThreads)
hash_lookup_kernel(const u64* __restrict__ slots, int64_t cap, int n_shards,
                   const u64* __restrict__ queries, int64_t n, int k,
                   unsigned int* __restrict__ out) {
  const u64 mask = static_cast<u64>(cap) - 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    u64 key = queries[i];
    unsigned int result = 0;
    if (key != kEmpty) {
      if (k > 0) {
        const u64 rc = revcomp(key, k);
        key = rc < key ? rc : key;
      }
      const u64 h = mix64(key);
      const u64* table =
          slots + 2 * static_cast<u64>(shard_of(h, n_shards)) * cap;
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

// slots: n_shards (0 or 1: one table) tables of `cap` 16 B slots, [S, cap, 2]
// int64, 16 B aligned; claims: [max(n_shards, 1)] int64, each shard's count of
// claimed slots, incremented here. Entries: either kmers [n] int64 (SENTINEL
// skipped) with amounts [n] uint32 or NULL (each entry adds 1), or src [n, 2]
// int64, another table's slots (kmers and amounts NULL; empty slots skipped).
// overflow: one int, set to 1 when an entry found no slot in `cap` probes.
int shk_hash_insert(int64_t* slots, int64_t cap, int n_shards, int64_t* claims,
                    const int64_t* kmers, const int* amounts,
                    const int64_t* src, int64_t n, int* overflow,
                    cudaStream_t stream) {
  if (n <= 0) return 0;
  const int n_counters = n_shards > 1 ? n_shards : 1;
  hash_insert_kernel<<<blocks_for(n), kThreads, n_counters * sizeof(u64),
                       stream>>>(
      reinterpret_cast<u64*>(slots), cap, n_shards,
      reinterpret_cast<u64*>(claims), reinterpret_cast<const u64*>(kmers),
      reinterpret_cast<const unsigned int*>(amounts),
      reinterpret_cast<const u64*>(src), n, overflow);
  return static_cast<int>(cudaGetLastError());
}

// queries [n] int64 (SENTINEL answers 0), each answered by its owner shard;
// k > 0 canonicalizes each query first (directional lookup); out [n] uint32
// counts, 0 when absent.
int shk_hash_lookup(const int64_t* slots, int64_t cap, int n_shards,
                    const int64_t* queries, int64_t n, int k, int* out,
                    cudaStream_t stream) {
  if (n <= 0) return 0;
  hash_lookup_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      reinterpret_cast<const u64*>(slots), cap, n_shards,
      reinterpret_cast<const u64*>(queries), n, k,
      reinterpret_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
