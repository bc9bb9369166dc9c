// The SplitMix64 finalizer and the owner route of a sharded table, shared by
// hash_table.cu (a key's home slot is mix64(key) & (cap - 1)) and
// probe_rows.cuh (a key's shard is owner(key, n_shards)), so the slot and the
// route cannot drift apart. Their Python counterparts are kernels/hash.py
// mix64 and owner; the JAX package's are sharkmer_tpu/ops/hashtable.py _mix64
// and sharkmer_tpu/parallel/sharded_table.py _owner.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace shk {

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDull;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ull;
  x ^= x >> 33;
  return x;
}

// The shard of n_shards that owns a key whose mix64 is `h`: its high bits, so
// that the owner and a shard's home slot (the low bits) stay independent.
__device__ __forceinline__ int owner_of_hash(uint64_t h, int n_shards) {
  return static_cast<int>((h >> 40) % static_cast<uint64_t>(n_shards));
}

// The shard of n_shards that owns `key`.
__device__ __forceinline__ int owner(uint64_t key, int n_shards) {
  return owner_of_hash(mix64(key), n_shards);
}

}  // namespace shk
