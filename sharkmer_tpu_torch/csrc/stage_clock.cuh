// Stage clocks of the reach closure's measurement build
// (csrc/reach_closure_stages.cu: csrc/reach_closure.cu built with
// SHK_STAGE_CLOCKS). One thread stamps the 32-bit clock() after each stage
// of a level and sums the laps into an int64 array that
// tools/closure_stages.py reads. Nothing here runs in the program's build.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace shk {

// the stages of a level, in order
enum Stage {
  kFrontier,  // the walker's key and reverse complement
  kRoute,     // the partition's descriptor
  kLut,       // lut[b], lut[b + 1]
  kRows,      // the bucket's rows, keys and counts
  kClaim,     // bitmap atomicOr, slot, frontier and log stores
  kBarrier,   // barriers and the state update, the wait for the slowest
  kStages
};

// the clock array: a split per kind of level (kStages laps, then levels,
// level cycles, rounds), each round's cycles of the wide levels by index,
// and the whole kernel in cycles and in globaltimer ns
constexpr int kNarrowSplit = 0;
constexpr int kWideSplit = 10;
constexpr int kRoundBase = 20;
constexpr int kMaxRounds = 64;
constexpr int kTotalCycles = kRoundBase + kMaxRounds;
constexpr int kTotalNs = kTotalCycles + 1;
constexpr int kClockWords = kTotalNs + 1;

// Add the cycles since `t` to `lap` once `v` is ready, and restart `t` (32
// bits: a level is far shorter than 2^32 cycles, and fewer registers
// keep the measurement build from spilling). A
// predicated trap on a compare of v (never true: no key, row or mask takes
// that value) makes the thread wait for the load or arithmetic that
// produced v before it reads the clock; an asm that only names v would not,
// since a load's latency is paid where its register is first read.
template <typename T>
__device__ __forceinline__ void stamp_after(unsigned& lap, unsigned& t, T v) {
  const uint64_t x = static_cast<uint64_t>(v);
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.eq.u64 p, %0, 0x5EED5EED5EED5EED;\n\t"
      "@p trap;\n\t}" ::"l"(x)
      : "memory");
  const unsigned now = static_cast<unsigned>(clock());
  lap += now - t;
  t = now;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

}  // namespace shk
