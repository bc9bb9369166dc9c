// The sPCR reach closure, fused: one launch runs a whole closure call (every
// BFS level, both phases) on the device, for Hopper (sm_90a).
//
// It is the port's counterpart of the TPU kernel probe_rows
// (sharkmer_tpu/ops/pallas_kernels.py) inside the JAX closure loop
// (sharkmer_tpu/ops/reach.py _closure_run, a lax.while_loop whose every level
// calls lookup_pallas). The torch loop it replaces (kernels/closure.py
// closure_plain, the CPU path and the test oracle) dispatched ~56 small
// launches and a host sync per level.
//
// One launch = one attempt of ops/reach._reach_call at one (f_cap, f_narrow):
//   * prologue: set the visited bits of the warm-start rows (pre_ids, from
//     one routed probe_rows launch);
//   * root level from c0: canonicalise each key against its reverse
//     complement;
//   * each level: expand every live walker to its 8 de Bruijn neighbours
//     (4 suffix, then 4 prefix shifts), carrying the reverse complements by
//     shifts; route each canonical candidate to the partition whose key range
//     holds it, or in a sharded table to its owner shard; probe that
//     partition's bucket (probe_rows.cuh, the code of the probe_rows kernel);
//     claim the row with atomicOr on the visited bitmap (a clear old bit is a
//     first visit, so a row is claimed once per call, however many candidates
//     reach it); a counter gives each claim its slot in the next frontier and
//     appends its id to the log;
//   * the phase logic of closure_plain exactly: a wide loop at f_cap while
//     it <= depth, not done, no overflow and more than f_narrow live walkers;
//     then the narrow loop at f_narrow in bodies of 4 levels with the
//     condition tested once per body (levels run on an empty frontier count
//     in `it`, as in JAX); one level per test when f_narrow >= f_cap;
//   * more claims in a level than its width raise overflow: the level keeps
//     the `width` smallest row ids and gives the others back (their bits are
//     cleared), as closure_plain's sort keeps them, so even an overflowed
//     call ends in closure_plain's state; _drive_closure discards it and
//     retries wider.
// The visited set, n_vis, iters, overflow, done and the boundary set equal
// the torch loop's and the JAX package's; only the order of the ids inside a
// level's log block and of the boundary differ, and nothing downstream reads
// it (_reach_call sorts the log, _drive_closure keeps the boundary's unique
// keys).
//
// Design, from the level split of the earlier one-block design (PERF.md
// section 6: a level was a chain of dependent steps, each an L2 or
// TLB-missing DRAM round trip or a barrier, and a wide level ran its
// candidates as rounds of 128 on one SM, one round's chain after another):
//   * one memory round trip a probe step: the LUT pair in one load, then
//     every row of the bucket, keys and counts together, as unrolled
//     predicated loads (probe_rows.cuh); a count no longer waits on its key;
//   * the level on chip: the frontiers, the claim counters and the
//     partitions' descriptors (for routing) live in shared memory; one
//     barrier a level, with the claim counter rotated over three words so
//     that the next level's counter is cleared before its barrier;
//   * wide levels on a thread-block cluster of up to 16 CTAs of 512 threads,
//     one SM each, 8 lanes a candidate: 64 candidates a CTA, 1024 a round on
//     16. Each CTA takes an interleaved share of the candidates, reads the
//     walkers from the leader CTA's frontier and claims into it through
//     distributed shared memory (one counter atomic a warp, the row's
//     atomicOr on the bitmap deciding between CTAs), and the CTAs meet at
//     one cluster barrier a level;
//   * narrow levels of at most 128 candidates (f_narrow <= 16) run on the
//     leader CTA alone, the others leave after the wide phase: a block
//     barrier and local shared memory are cheaper than the cluster's. There
//     a row's claim needs no L2 atomic round trip: the bucket's visited
//     words are loaded beside its rows, a shared set of the level's first
//     visits settles ties, and the bit is set without waiting;
//   * a frontier wider than kSmemWidth (retry widths past 4096) lives in
//     global scratch instead, read and written through L2 (.cg), so that a
//     CTA never reads another's writes from a stale L1 line; the entry point
//     picks the place from f_cap;
//   * claims past a level's width go to global spill scratch, read only
//     when the level overflowed.
// Peer shards on other cards are read through their pointers; the partition
// table copies their LUTs onto the launching card (kernels/probe.py), so a
// probe's first load stays local.
//
// Plain C interface, bound with ctypes: the entry point launches on the given
// stream, does not synchronise, allocates nothing (the wrapper passes zeroed
// bitmap, INF-filled log and the other scratch), and returns
// cudaGetLastError() after its launch (0 = success). A build with
// SHK_STAGE_CLOCKS (csrc/reach_closure_stages.cu, measurement only) adds
// shk_reach_closure_clocked, which also stamps each level's stages into a
// `clocks` array (stage_clock.cuh).

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "probe_rows.cuh"
#ifdef SHK_STAGE_CLOCKS
#include "stage_clock.cuh"
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kGroup = 8;                   // lanes per candidate probe
constexpr int kPerWarp = 32 / kGroup;       // candidates per warp per round
constexpr int kPerCta = kThreads / kGroup;  // candidates per CTA per round
constexpr int kMaxCluster = 16;             // non-portable on Hopper
constexpr int kSoloCand = 128;  // solo: narrow levels of at most this many
constexpr int kSmemParts = 256;             // descriptors copied to shared
constexpr int kSmemWidth = 4096;            // widest shared frontier
constexpr int kSeenSlots = 512;             // first visits of a solo level

struct Closure {
  const shk::PartDesc* parts;
  int n_parts;
  int n_shards;  // 0: key-range routing; > 0: owner routing over n_parts
  const int64_t* c0;  // root keys, directional, sentinel-padded
  int n_c0;
  const int* pre_ids;  // warm-start global row ids, INT32_MAX-padded
  int n_pre;
  int64_t min_count;
  int k, depth, f_cap, f_narrow;
  int front_in_smem;  // the frontiers in the leader CTA's shared memory
  unsigned* bitmap;   // visited bit per global row id, zeroed
  int64_t* front;     // [2][f_cap][2] global frontiers (!front_in_smem)
  int* log;           // first-visit ids in visit order, INT32_MAX-filled
  int64_t* boundary;  // [f_cap] walkers live at exit, sentinel-padded
  int64_t* state;     // n_vis, iters, overflow, done
  int64_t* spill;     // [n_spill][2] (key, rc), then [n_spill] ids
  int n_spill;        // the most candidates of a level
  long long* clocks;  // stage clocks (SHK_STAGE_CLOCKS builds only)
};

// The leader CTA's control words, at the start of its shared memory.
struct Ctl {
  int cnt[3];    // claims of level L in cnt[L % 3]
  int below[3];  // keep_smallest: ids at or below the probe, by step % 3
  int fix;       // keep_smallest: positions of the kept claims
  int pad;
  // a solo level's first visits: (level + 1) << 32 | id, open addressing;
  // an entry of another level counts as free, so nothing is cleared
  unsigned long long seen[kSeenSlots];
};
constexpr int kCtlBytes = sizeof(Ctl);
static_assert(kCtlBytes % 16 == 0, "the descriptors after Ctl stay aligned");
constexpr size_t kMaxSmemBytes =
    kCtlBytes + kSmemParts * 48 + 32 * static_cast<size_t>(kSmemWidth);

// Where a thread finds the level's shared state.
struct View {
  Ctl* ctl;                     // the leader's (distributed) control words
  int64_t* front0;              // the leader's frontiers, or the global ones
  int64_t* front1;
  const shk::PartDesc* parts;   // this CTA's shared copy, or global
  int rank;                     // this CTA in the cluster
  int n_cta;                    // CTAs that run the level
};

// A thread's copy of the closure state; every thread of the launch computes
// the same values from the same counters after each barrier.
struct Walk {
  int n_live;  // walkers in the current frontier
  int it;
  int n_vis;
  int overflow;
  int done;
  int cur;  // the frontier that holds the walkers
};

__device__ __forceinline__ uint64_t revcomp(uint64_t x, int k) {
  x = ~x;  // complement: 3 - b == b ^ 3 for a 2-bit base
  x = ((x & 0x3333333333333333ull) << 2) | ((x >> 2) & 0x3333333333333333ull);
  x = ((x & 0x0F0F0F0F0F0F0F0Full) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0Full);
  x = ((x & 0x00FF00FF00FF00FFull) << 8) | ((x >> 8) & 0x00FF00FF00FF00FFull);
  x = ((x & 0x0000FFFF0000FFFFull) << 16) | ((x >> 16) & 0x0000FFFF0000FFFFull);
  x = (x << 32) | (x >> 32);
  return x >> (64 - 2 * k);
}

// A word another CTA or level wrote, read through L2.
__device__ __forceinline__ int64_t load_cg(const int64_t* p) {
  return __ldcg(reinterpret_cast<const long long*>(p));
}

// A walker of a frontier in global scratch (kGlobal: through L2) or in
// (distributed) shared memory.
template <bool kGlobal>
__device__ __forceinline__ longlong2 load_walker(const int64_t* f, int w) {
  const longlong2* p = reinterpret_cast<const longlong2*>(f) + w;
  if constexpr (kGlobal) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

template <bool kGlobal>
__device__ __forceinline__ void store_walker(int64_t* f, int w, int64_t key,
                                             int64_t key_rc) {
  longlong2* p = reinterpret_cast<longlong2*>(f) + w;
  const longlong2 val = make_longlong2(key, key_rc);
  if constexpr (kGlobal) {
    __stcg(p, val);
  } else {
    *p = val;
  }
}

// The first claim of `id` in the level tagged `tag` (level + 1), against
// the solo level's shared set: a shared CAS, not an L2 atomic.
__device__ __forceinline__ bool claim_seen(Ctl* ctl, unsigned tag,
                                           unsigned id) {
  const unsigned long long mine =
      (static_cast<unsigned long long>(tag) << 32) | id;
  unsigned h = (id * 0x9E3779B1u) & (kSeenSlots - 1);
  for (;;) {
    unsigned long long cur =
        *reinterpret_cast<volatile unsigned long long*>(&ctl->seen[h]);
    if ((cur >> 32) != tag) {
      const unsigned long long old = atomicCAS(&ctl->seen[h], cur, mine);
      if (old == cur) return true;
      cur = old;  // this level's entry, written just now
    }
    if (cur == mine) return false;
    if ((cur >> 32) == tag) h = (h + 1) & (kSeenSlots - 1);
  }
}

template <bool kCluster>
__device__ __forceinline__ void level_barrier() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();  // release/acquire at cluster scope
  } else {
    __syncthreads();
  }
}

// An overflowed level (n claims > width): keep the `width` smallest ids, as
// closure_plain's sort does, and clear the others' bits. The leader CTA
// gathers every claim into the spill scratch, bisects for the width-th
// smallest id (ids are unique: one claim a row), then writes the kept
// claims to the frontier and the log block. Runs only on overflow.
template <bool kCluster, bool kGlobal>
__device__ void keep_smallest(const Closure& a, const View& v, int64_t* dst,
                              int log_pos, int n, int width) {
  if (v.rank == 0) {
    const int tid = threadIdx.x;
    Ctl* ctl = v.ctl;
    int64_t* kr = a.spill;
    int64_t* ids = a.spill + 2 * static_cast<int64_t>(a.n_spill);
    for (int j = tid; j < width; j += kThreads) {
      const longlong2 w = load_walker<kGlobal>(dst, j);
      kr[2 * j] = w.x;
      kr[2 * j + 1] = w.y;
      ids[j] = __ldcg(a.log + log_pos + j);
    }
    if (tid == 0) {
      ctl->below[0] = 0;
      ctl->fix = 0;
    }
    __syncthreads();
    int lo = 0, hi = shk::kInf - 1;  // the answer lies in [lo, hi]
    for (int step = 0; lo < hi; ++step) {
      const int mid = lo + (hi - lo) / 2;
      if (tid == 0) ctl->below[(step + 1) % 3] = 0;
      int c = 0;
      for (int j = tid; j < n; j += kThreads) c += load_cg(ids + j) <= mid;
      c = __reduce_add_sync(shk::kFullMask, c);
      if ((tid & 31) == 0 && c) atomicAdd(&ctl->below[step % 3], c);
      __syncthreads();
      if (ctl->below[step % 3] >= width) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    for (int j = tid; j < n; j += kThreads) {
      const int id = static_cast<int>(load_cg(ids + j));
      if (id <= lo) {
        const int pos = atomicAdd(&ctl->fix, 1);
        store_walker<kGlobal>(dst, pos, load_cg(kr + 2 * j),
                              load_cg(kr + 2 * j + 1));
        a.log[log_pos + pos] = id;
      } else {
        atomicAnd(a.bitmap + (id >> 5), ~(1u << (id & 31)));
      }
    }
  }
  level_barrier<kCluster>();
}

#ifdef SHK_STAGE_CLOCKS
#define SHK_STAMP(stage, value) shk::stamp_after(lap[shk::stage], t, value)
#else
#define SHK_STAMP(stage, value) ((void)0)
#endif

// One BFS level: candidates from the walkers of frontier w.cur (the root
// keys c0 when root), first visits claimed into the other frontier, up to
// `width` of them. `level` counts the levels run, for the counters.
// kGlobal: the frontiers are in global scratch.
template <bool kCluster, bool kGlobal>
__device__ __forceinline__ void run_level(const Closure& a, const View& v,
                                          Walk& w, int level, bool root,
                                          int width) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int glane = lane % kGroup;
  const int n_cand = root ? a.n_c0 : 8 * w.n_live;
  const int log_pos = w.n_vis;
  const uint64_t kmask = (1ull << (2 * a.k)) - 1;
  const int top = 2 * (a.k - 1);
  int* cnt = &v.ctl->cnt[level % 3];
  const int64_t* src = w.cur ? v.front1 : v.front0;
  int64_t* dst = w.cur ? v.front0 : v.front1;
  // level + 1's counter was last read after level - 2's barrier
  if (v.rank == 0 && tid == 0) v.ctl->cnt[(level + 1) % 3] = 0;
#ifdef SHK_STAGE_CLOCKS
  unsigned t = static_cast<unsigned>(clock());
  const unsigned t_level = t;
  unsigned lap[shk::kStages] = {};
  int round = 0;
#endif
  // interleaved over the cluster: CTA r takes every n_cta-th warp's worth
  // of candidates; the rounds are warp-uniform (group_max, ballot)
  const int warp = (tid >> 5) * (kCluster ? v.n_cta : 1) + v.rank;
  const int stride = (kCluster ? v.n_cta : 1) * kPerCta;
  for (int first = warp * kPerWarp; first < n_cand; first += stride) {
#ifdef SHK_STAGE_CLOCKS
    const unsigned t_round = static_cast<unsigned>(clock());
#endif
    const int i = first + lane / kGroup;
    int64_t key = shk::kSentinel;
    int64_t key_rc = shk::kSentinel;
    if (i < n_cand) {
      uint64_t c = 0, c_rc = 0;
      bool live = true;
      if (root) {
        const int64_t r = a.c0[i];
        live = r != shk::kSentinel;
        c = static_cast<uint64_t>(r);
        c_rc = revcomp(c, a.k);
      } else {
        const longlong2 fr = load_walker<kGlobal>(src, i >> 3);
        const uint64_t f = static_cast<uint64_t>(fr.x);
        const uint64_t r = static_cast<uint64_t>(fr.y);
        const uint64_t b = i & 3;
        if ((i & 7) < 4) {  // suffix shift: append b
          c = ((f << 2) | b) & kmask;
          c_rc = ((3 - b) << top) | (r >> 2);
        } else {  // prefix shift: prepend b
          c = (b << top) | (f >> 2);
          c_rc = ((r << 2) | (3 - b)) & kmask;
        }
      }
      if (live) {
        key = static_cast<int64_t>(c < c_rc ? c : c_rc);
        key_rc = static_cast<int64_t>(c < c_rc ? c_rc : c);
      }
    }
    SHK_STAMP(kFrontier, key);
    int lane_row = -1;
    int base = 0, s = 0;
    unsigned seen0 = 0, seen1 = 0;  // solo: the bucket's visited words
    if (key != shk::kSentinel) {
      const shk::PartDesc& p =
          v.parts[shk::route(v.parts, a.n_parts, a.n_shards, key)];
      base = p.base;
      SHK_STAMP(kRoute, base);
      int e;
      shk::bucket_bounds(p.lut, p.n_lut, p.shift, key, s, e);
      SHK_STAMP(kLut, s + e);
      if (!kCluster && glane == 0 && e > s) {
        // the visited bits of the bucket's first 32 rows (two words at
        // most), loaded beside the rows
        const int last = base + min(e, s + shk::kBucketRows) - 1;
        seen0 = __ldcg(a.bitmap + ((base + s) >> 5));
        seen1 = __ldcg(a.bitmap + (last >> 5));
      }
      lane_row = shk::probe_bucket<kGroup>(p.keys, p.counts, s, e, key,
                                           a.min_count, glane);
    }
    const int row = shk::group_max<kGroup>(lane_row);
    SHK_STAMP(kRows, row);
    bool first_visit = false;
    int id = 0;
    if (glane == 0 && row >= 0) {
      id = base + row;
      const unsigned bit = 1u << (id & 31);
      if (!kCluster && row - s < shk::kBucketRows) {
        // solo: visited before this level by the prefetched word, first
        // this level by the shared set; the bit is then set without
        // waiting for the atomic
        const unsigned word = (id >> 5) == ((base + s) >> 5) ? seen0 : seen1;
        first_visit = !(word & bit) && claim_seen(v.ctl, level + 1, id);
        if (first_visit) atomicOr(a.bitmap + (id >> 5), bit);
      } else {
        // the cluster's CTAs (and a bucket's rows past 32) claim on the
        // bitmap itself: the returned word says who came first
        first_visit = !(atomicOr(a.bitmap + (id >> 5), bit) & bit);
      }
    }
    // a slot for each first visit, one counter atomic a warp
    const unsigned mask = __ballot_sync(shk::kFullMask, first_visit);
    if (mask) {
      const int head = __ffs(mask) - 1;
      int slot = 0;
      if (lane == head) slot = atomicAdd(cnt, __popc(mask));
      slot = __shfl_sync(shk::kFullMask, slot, head) +
             __popc(mask & ((1u << lane) - 1));
      if (first_visit) {
        if (slot < width) {
          store_walker<kGlobal>(dst, slot, key, key_rc);
          a.log[log_pos + slot] = id;
        } else {  // overflow: kept for keep_smallest
          a.spill[2 * slot] = key;
          a.spill[2 * slot + 1] = key_rc;
          a.spill[2 * static_cast<int64_t>(a.n_spill) + slot] = id;
        }
      }
    }
    SHK_STAMP(kClaim, mask);
#ifdef SHK_STAGE_CLOCKS
    if (v.rank == 0 && tid == 0 && round < shk::kMaxRounds) {
      a.clocks[shk::kRoundBase + round] +=
          static_cast<unsigned>(clock()) - t_round;
    }
    ++round;
#endif
  }
  level_barrier<kCluster>();
  // the level's claims, one read a warp (a remote one off the leader)
  int n = 0;
  if (lane == 0) n = *reinterpret_cast<volatile int*>(cnt);
  n = __shfl_sync(shk::kFullMask, n, 0);
  if (n > width) {
    keep_smallest<kCluster, kGlobal>(a, v, dst, log_pos, n, width);
  }
  const int n_new = min(n, width);
  w.overflow |= n > width;
  w.n_vis += n_new;
  w.it += 1;
  w.done = n_new == 0;
  w.n_live = n_new;
  w.cur ^= 1;
#ifdef SHK_STAGE_CLOCKS
  if (v.rank == 0 && tid == 0) {
    const unsigned now = static_cast<unsigned>(clock());
    lap[shk::kBarrier] += now - t;
    // a narrow level: at most the solo phase's candidates
    const int split = n_cand > kSoloCand ? shk::kWideSplit : shk::kNarrowSplit;
    for (int j = 0; j < shk::kStages; ++j) a.clocks[split + j] += lap[j];
    a.clocks[split + shk::kStages] += 1;
    a.clocks[split + shk::kStages + 1] += now - t_level;
    a.clocks[split + shk::kStages + 2] += round;
  }
#endif
}

// The closure after the prologue, with the frontiers in (distributed)
// shared memory or, kGlobal, in global scratch: a separate instance each,
// so that the solo levels address their shared frontier directly.
template <bool kGlobal>
__device__ __forceinline__ void walk(const Closure& a, Ctl* ctl,
                                     const shk::PartDesc* parts,
                                     int64_t* front_s) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
#ifdef SHK_STAGE_CLOCKS
  const long long t0 = clock64();
  const uint64_t g0 = shk::global_ns();
#endif
  View v;
  v.rank = rank;
  v.n_cta = static_cast<int>(cluster.num_blocks());
  v.ctl = cluster.map_shared_rank(ctl, 0);
  v.parts = parts;
  int64_t* front = kGlobal ? a.front : cluster.map_shared_rank(front_s, 0);
  v.front0 = front;
  v.front1 = front + 2 * static_cast<int64_t>(a.f_cap);

  // every thread updates the same state from the same counters, so the loop
  // conditions are uniform across the cluster
  Walk w = {0, 0, 0, 0, 0, 0};
  int level = 0;
  run_level<true, kGlobal>(a, v, w, level++, true, a.f_cap);
  bool solo = false;
  if (a.f_narrow < a.f_cap) {
    while (w.it <= a.depth && !w.done && !w.overflow &&
           w.n_live > a.f_narrow) {
      run_level<true, kGlobal>(a, v, w, level++, false, a.f_cap);
    }
    // the narrow loop runs only when the wide one left <= f_narrow walkers:
    // they sit at the front of the frontier, so the cut keeps them all
    solo = 8 * a.f_narrow <= kSoloCand;
    if (solo) {
      // every CTA has read the last count before the leader goes on alone
      cluster.sync();
      if (rank != 0) return;
      v.ctl = ctl;
      v.n_cta = 1;
      if (!kGlobal) {
        v.front0 = front_s;
        v.front1 = front_s + 2 * static_cast<int64_t>(a.f_cap);
      }
      while (w.it <= a.depth && !w.done && !w.overflow) {
        for (int j = 0; j < 4; ++j) {
          run_level<false, kGlobal>(a, v, w, level++, false, a.f_narrow);
        }
      }
    } else {
      while (w.it <= a.depth && !w.done && !w.overflow) {
        for (int j = 0; j < 4; ++j) {
          run_level<true, kGlobal>(a, v, w, level++, false, a.f_narrow);
        }
      }
    }
  } else {
    while (w.it <= a.depth && !w.done && !w.overflow) {
      run_level<true, kGlobal>(a, v, w, level++, false, a.f_cap);
    }
  }
  if (!solo) {
    cluster.sync();  // no CTA leaves while another may read its memory
    if (rank != 0) return;
  }

  const int64_t* frontier = w.cur ? v.front1 : v.front0;
  for (int i = tid; i < a.f_cap; i += kThreads) {
    a.boundary[i] =
        i < w.n_live ? load_walker<kGlobal>(frontier, i).x : shk::kSentinel;
  }
  if (tid == 0) {
    a.state[0] = w.n_vis;
    a.state[1] = w.it;
    a.state[2] = w.overflow;
    a.state[3] = w.done;
#ifdef SHK_STAGE_CLOCKS
    a.clocks[shk::kTotalCycles] += clock64() - t0;
    a.clocks[shk::kTotalNs] += shk::global_ns() - g0;
#endif
  }
}

__global__ void __launch_bounds__(kThreads, 1)
reach_closure_kernel(Closure a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_cta = static_cast<int>(cluster.num_blocks());
  Ctl* ctl = reinterpret_cast<Ctl*>(smem);
  const int n_sp = a.n_parts <= kSmemParts ? a.n_parts : 0;
  auto* parts_s = reinterpret_cast<shk::PartDesc*>(smem + kCtlBytes);
  auto* front_s = reinterpret_cast<int64_t*>(
      smem + kCtlBytes + n_sp * sizeof(shk::PartDesc));
  // the descriptors into this CTA's shared memory: routing reads no global
  // memory
  for (int j = tid; j < 6 * n_sp; j += kThreads) {
    reinterpret_cast<int64_t*>(parts_s)[j] =
        reinterpret_cast<const int64_t*>(a.parts)[j];
  }
  if (tid == 0) {
    for (int j = 0; j < 3; ++j) ctl->cnt[j] = 0;
  }
  for (int j = tid; j < kSeenSlots; j += kThreads) ctl->seen[j] = 0;
  // warm start, spread over the cluster: rows below the floor probed to
  // INT32_MAX and are skipped
  for (int i = rank * kThreads + tid; i < a.n_pre; i += n_cta * kThreads) {
    const int id = a.pre_ids[i];
    if (id != shk::kInf) atomicOr(a.bitmap + (id >> 5), 1u << (id & 31));
  }
  cluster.sync();

  const shk::PartDesc* parts = n_sp ? parts_s : a.parts;
  if (a.front_in_smem) {
    walk<false>(a, ctl, parts, front_s);
  } else {
    walk<true>(a, ctl, parts, front_s);
  }
}

// The widest cluster this card schedules for the kernel (16 where a GPC
// has the SMs, else 8), found once per device.
int max_cluster(int device) {
  static int cached[64] = {};
  if (device >= 0 && device < 64 && cached[device]) return cached[device];
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kMaxSmemBytes;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int size = kMaxCluster;
  for (; size > 1; size /= 2) {
    attr.val.clusterDim.x = size;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(size);
    int n_clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&n_clusters, reach_closure_kernel,
                                       &cfg) == cudaSuccess &&
        n_clusters > 0) {
      break;
    }
    cudaGetLastError();  // a refused size is not the launch's error
  }
  if (device >= 0 && device < 64) cached[device] = size;
  return size;
}

// Launches one attempt; `clocks` is read only by SHK_STAGE_CLOCKS builds.
int launch(const void* parts, int n_parts, int n_shards, const int64_t* c0,
           int n_c0, const int* pre_ids, int n_pre, int64_t min_count, int k,
           int depth, int f_cap, int f_narrow, unsigned* bitmap,
           int64_t* front, int* log, int64_t* boundary, int64_t* state,
           int64_t* spill, int n_spill, long long* clocks,
           cudaStream_t stream) {
  if (n_spill < n_c0 || n_spill / 8 < f_cap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the frontiers in shared memory where they fit, else in global scratch
  const int front_in_smem = f_cap <= kSmemWidth;
  const int n_sp = n_parts <= kSmemParts ? n_parts : 0;
  const size_t smem_bytes = kCtlBytes + n_sp * sizeof(shk::PartDesc) +
                            (front_in_smem ? 32 * static_cast<size_t>(f_cap)
                                           : 0);
  cudaError_t err = cudaFuncSetAttribute(
      reach_closure_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmemBytes));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(reach_closure_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  }
  int device = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one round of candidates a level where the cluster allows it
  const int n_cta =
      std::min(max_cluster(device), (n_spill + kPerCta - 1) / kPerCta);

  Closure a;
  a.parts = static_cast<const shk::PartDesc*>(parts);
  a.n_parts = n_parts;
  a.n_shards = n_shards;
  a.c0 = c0;
  a.n_c0 = n_c0;
  a.pre_ids = pre_ids;
  a.n_pre = n_pre;
  a.min_count = min_count;
  a.k = k;
  a.depth = depth;
  a.f_cap = f_cap;
  a.f_narrow = f_narrow;
  a.front_in_smem = front_in_smem;
  a.bitmap = bitmap;
  a.front = front;
  a.log = log;
  a.boundary = boundary;
  a.state = state;
  a.spill = spill;
  a.n_spill = n_spill;
  a.clocks = clocks;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n_cta;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(n_cta);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, reach_closure_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int shk_reach_closure(const void* parts, int n_parts, int n_shards,
                      const int64_t* c0, int n_c0, const int* pre_ids,
                      int n_pre, int64_t min_count, int k, int depth, int f_cap,
                      int f_narrow, unsigned* bitmap, int64_t* front, int* log,
                      int64_t* boundary, int64_t* state, int64_t* spill,
                      int n_spill, cudaStream_t stream) {
  return launch(parts, n_parts, n_shards, c0, n_c0, pre_ids, n_pre, min_count,
                k, depth, f_cap, f_narrow, bitmap, front, log, boundary, state,
                spill, n_spill, nullptr, stream);
}

#ifdef SHK_STAGE_CLOCKS
// shk_reach_closure with the stage clocks summed into `clocks`
// (stage_clock.cuh kClockWords int64, zeroed).
int shk_reach_closure_clocked(const void* parts, int n_parts, int n_shards,
                              const int64_t* c0, int n_c0, const int* pre_ids,
                              int n_pre, int64_t min_count, int k, int depth,
                              int f_cap, int f_narrow, unsigned* bitmap,
                              int64_t* front, int* log, int64_t* boundary,
                              int64_t* state, int64_t* spill, int n_spill,
                              long long* clocks, cudaStream_t stream) {
  return launch(parts, n_parts, n_shards, c0, n_c0, pre_ids, n_pre, min_count,
                k, depth, f_cap, f_narrow, bitmap, front, log, boundary, state,
                spill, n_spill, clocks, stream);
}
#endif

}  // extern "C"
