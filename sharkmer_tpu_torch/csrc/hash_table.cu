// Open-addressed k-mer count table of the hash backend, for Hopper (sm_90a):
// hash_insert and hash_lookup.
//
// The table is two flat arrays of `cap` slots (a power of two): int64 keys,
// INT64_MAX (the port's SENTINEL) for an empty slot, and uint32 counts kept
// as the bit pattern of an int32 tensor. A key's home slot is
// mix64(key) & (cap - 1), the SplitMix64 finalizer (mix64.cuh, shared with
// the owner route of a sharded table); collisions probe linearly. A slot
// goes from empty to a key once and never changes again.
//
// They replace the XLA programs of sharkmer_tpu/ops/hashtable.py (no Pallas
// kernel there: torch has no op that inserts into or probes a hash table):
//   * hash_insert: _insert_kernel (claim/probe rounds of masked scatters in a
//     lax.while_loop) and _rehash_kernel (the same insert fed with the old
//     table's slots);
//   * hash_lookup: _lookup_kernel (the probe loop) and
//     _lookup_directional_kernel (revcomp, min, probe).
//
// hash_insert: one thread per input entry, grid-stride. SENTINEL entries (the
// padding of a batch, the empty slots of a merged or rehashed table) are
// skipped. At each slot the thread loads the key (a relaxed load through L2);
// if it is the entry's key, it adds; if the slot is empty, it claims it with
// a 64-bit atomicCAS and adds when the CAS returned EMPTY or its own key;
// otherwise it steps to the next slot. All entries of one key follow the same
// probe sequence and find the same slot, whatever order they run in: a slot
// a thread steps over holds another key for good. The add is a 32-bit
// atomicAdd (modulo 2^32, as JAX's u32 scatter-add), taken only when the
// loaded count is below SAT_THRESHOLD (0xE0000000): the freeze rule of the
// JAX table, read per entry where JAX reads it per round. The two agree
// unless one batch carries a count across the threshold (~3.76e9 adds).
// Probes are capped at `cap`; a thread that runs out sets *overflow, and the
// wrapper raises on it (the table's growth rule keeps the load at 0.7).
//
// hash_lookup: one thread per query; with k > 0 the query is canonicalized
// in the kernel (min of the key and its reverse complement). It probes until
// the key or an empty slot and writes the count, or 0 when the key is absent
// or the query is SENTINEL.
//
// Bound: device memory bytes. hash_insert reads 8 B an entry (4 B more with
// explicit amounts) and reads and writes each 32 B sector of keys (4 slots)
// and of counts (8 slots) that comes to hold a key (chip_smoke.py counts
// those sectors in the filled table). Random sectors, not streaming bytes,
// are the real cost, and the atomics serialise on hot slots: a k-mer seen
// thousands of times in a batch is thousands of atomicAdds on one address.
// hash_lookup moves 8 B in, a key sector, a count sector and 4 B out per
// query; a wave of a few thousand queries is one dependent
// chain (load the key, compare, load the count), so its bound is the load
// latency of csrc/chase.cu, not bytes. Left for later: warp-cooperative
// probing (a warp loads 32 neighbouring slots at once, one sector per probe
// step instead of one per thread) and pre-aggregating hot keys in shared
// memory before the global atomics.
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

// Relaxed loads: through L2 (the point of coherence of the atomics), never a
// stale L1 line.
__device__ __forceinline__ u64 load_key(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

__device__ __forceinline__ unsigned int load_count(const unsigned int* p) {
  return *reinterpret_cast<const volatile unsigned int*>(p);
}

__global__ void __launch_bounds__(kThreads)
hash_insert_kernel(u64* __restrict__ keys, unsigned int* __restrict__ counts,
                   int64_t cap, const u64* __restrict__ kmers,
                   const unsigned int* __restrict__ amounts, int64_t n,
                   int* __restrict__ overflow) {
  const u64 mask = static_cast<u64>(cap) - 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const u64 key = kmers[i];
    if (key == kEmpty) continue;
    const unsigned int amount = amounts == nullptr ? 1u : amounts[i];
    u64 slot = mix64(key) & mask;
    for (int64_t probes = 0;; ++probes) {
      if (probes == cap) {
        atomicExch(overflow, 1);
        break;
      }
      u64 cur = load_key(keys + slot);
      if (cur == kEmpty) {
        cur = atomicCAS(keys + slot, kEmpty, key);
        if (cur == kEmpty) cur = key;  // this thread claimed the slot
      }
      if (cur == key) {
        if (amount != 0u && load_count(counts + slot) < kSat) {
          atomicAdd(counts + slot, amount);
        }
        break;
      }
      slot = (slot + 1) & mask;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hash_lookup_kernel(const u64* __restrict__ keys,
                   const unsigned int* __restrict__ counts, int64_t cap,
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
      u64 slot = mix64(key) & mask;
      for (int64_t probes = 0; probes < cap; ++probes) {
        const u64 cur = __ldg(keys + slot);
        if (cur == key) {
          result = __ldg(counts + slot);
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

// keys/counts: the table's [cap] slots; kmers [n] int64 (SENTINEL skipped);
// amounts [n] uint32 or NULL (each entry adds 1); overflow: one int, set to 1
// when an entry found no slot in `cap` probes.
int shk_hash_insert(int64_t* keys, int* counts, int64_t cap,
                    const int64_t* kmers, const int* amounts, int64_t n,
                    int* overflow, cudaStream_t stream) {
  if (n <= 0) return 0;
  hash_insert_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      reinterpret_cast<u64*>(keys), reinterpret_cast<unsigned int*>(counts),
      cap, reinterpret_cast<const u64*>(kmers),
      reinterpret_cast<const unsigned int*>(amounts), n, overflow);
  return static_cast<int>(cudaGetLastError());
}

// queries [n] int64 (SENTINEL answers 0); k > 0 canonicalizes each query
// first (directional lookup); out [n] uint32 counts, 0 when absent.
int shk_hash_lookup(const int64_t* keys, const int* counts, int64_t cap,
                    const int64_t* queries, int64_t n, int k, int* out,
                    cudaStream_t stream) {
  if (n <= 0) return 0;
  hash_lookup_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      reinterpret_cast<const u64*>(keys),
      reinterpret_cast<const unsigned int*>(counts), cap,
      reinterpret_cast<const u64*>(queries), n, k,
      reinterpret_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
