// What K11 and K12 (kernels/routed.cu) share: the launch's layout, the record
// words, and the exchange order of a phase's departures.
//
// A routed walk keeps, for every shard s of D, the tensors that
// parallel/partition_v2.py::RoutedWalk allocates; the wrapper
// (kernels/bindings.py::routed_phase_launch) packs their base pointers into
// one RoutedShard per shard, on the card, and the phase's scalars into one
// TrwRoutedLaunch.  Records are uint32 words held in int32 tensors.
#pragma once

#include <cstdint>

namespace trw {

constexpr int kRoutedMaxShards = 256;  // bindings.py ROUTED_MAX_SHARDS
constexpr uint32_t kEmptyWid = 0xFFFFFFFFu;  // the sentinel record's wid

// One shard's buffers (bindings.py _ROUTED_SHARD_FIELDS, in this order).
struct RoutedShard {
  const int32_t* meta;   // (S, 2) [start, deg] of the shard's nodes
  const int32_t* col;    // (E_max,) neighbour ids of its rows
  int32_t* walks;        // (blk + 1, L + 2) its walkers' positions
  const int32_t* inbox;  // (D * cap, R) this phase's arrivals
  int32_t* outbox;       // (D * cap, R) departures, chunk d for shard d
  int32_t* carry;        // (ccap, R + 1) records waiting, last word the dest
  int32_t* stage;        // (max(D * cap, blk), R) each arrival's departure
  int32_t* code;         // (max(D * cap, blk),) its stream << 16 | dest, or -1
  const int32_t* hash;   // (2^hash_log, 2) cuckoo edge set (node2vec)
  const int32_t* bloom;  // (S, 4) Bloom filters of N(v) (node2vec)
  int64_t salt;          // the cuckoo set's salt
};

}  // namespace trw

// The phase's scalars and counters (bindings.py _RoutedLaunch).
struct TrwRoutedLaunch {
  const trw::RoutedShard* shards;  // device array of num_shards
  int64_t* stats;                  // (D, 3): logged, sent, dropped (add)
  int64_t* live;                   // (D, 2): boxed, carried (this pipeline)
  int32_t num_shards;
  int32_t shard_nodes;
  int32_t blk;          // walkers a shard owns (wid-owner = wid / blk)
  int32_t walk_length;
  int32_t cap;          // records a shard sends one destination a phase
  int32_t ccap;         // carry pool slots
  int64_t e_max;        // length of every shard's col
  uint32_t key0, key1;  // Threefry key of the walk's stream
  int32_t spec_rounds;  // node2vec: rounds a STEP record draws
  int32_t hash_log;     // node2vec: log2 of the cuckoo table's rows
  int32_t use_search;   // node2vec: 1 = binary search, 0 = cuckoo probes
  float prob0, prob1, prob2, lo_acc, hi_acc;  // node2vec thresholds
};

namespace trw {

// owner(x) = clip(x // shard_nodes, 0, D - 1) of a signed node id.
__device__ __forceinline__ int owner_of(int32_t x, const TrwRoutedLaunch& a) {
  if (x < 0) return 0;
  return min(x / a.shard_nodes, a.num_shards - 1);
}

// The shard's row of node x, clamped into [0, shard_nodes).
__device__ __forceinline__ int64_t local_row(int32_t x, int my,
                                             const TrwRoutedLaunch& a) {
  const int64_t r = (int64_t)x - (int64_t)my * a.shard_nodes;
  return min(max(r, (int64_t)0), (int64_t)a.shard_nodes - 1);
}

__device__ __forceinline__ int32_t col_at(const RoutedShard& sh, int64_t idx,
                                          const TrwRoutedLaunch& a) {
  return sh.col[min(max(idx, (int64_t)0), a.e_max - 1)];
}

// The exchange order (parallel/partition_v2.py::build_outbox, the JAX
// package's _build_outbox): shard my's candidates are its carry pool's live
// prefix, then the arrivals' departures of stream 0, 1, ... in slot order.
// Destination d takes its first cap candidates; the rest fill the carry pool
// in order, up to ccap, and the excess is dropped and counted.
//
// One block of kCompactThreads does a shard, kCompactThreads candidates at a
// time: a candidate's rank among its destination's is the running count of
// the destination, plus the same destination's candidates of the lower warps
// of this chunk (a count per warp and destination in shared memory, set by
// the first lane of each __match_any_sync group), plus its lower lanes of
// the same group; the carry rank is the running count of leftovers plus a
// ballot's prefix.  The carry pool is compacted in place: a candidate of the
// pool moves to a slot at or below its own, and every thread of a chunk loads
// its record before any writes (the first barrier), so no record is
// overwritten before it is read.
constexpr int kCompactThreads = 512;
constexpr int kCompactWarps = kCompactThreads / 32;

//
// A phase stages its arrivals' departures in the first D * cap slots of the
// stage; phase 0 stages every local walker's first record in the first blk.
template <int R>
__device__ void compact_departures(const TrwRoutedLaunch& a, int my,
                                   int num_streams, int64_t slots) {
  const RoutedShard sh = a.shards[my];
  const int nd = a.num_shards;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ int s_cnt[kRoutedMaxShards];
  __shared__ int s_wcnt[kCompactWarps][kRoutedMaxShards];
  __shared__ int s_wleft[kCompactWarps];
  __shared__ int64_t s_left;
  for (int i = tid; i < kRoutedMaxShards; i += kCompactThreads) s_cnt[i] = 0;
  for (int i = tid; i < kCompactWarps * kRoutedMaxShards;
       i += kCompactThreads) {
    (&s_wcnt[0][0])[i] = 0;
  }
  if (tid == 0) s_left = 0;
  __syncthreads();
  const unsigned lower = (1u << lane) - 1u;
  const int64_t carried = a.live[2 * my + 1];
  for (int pass = 0; pass <= num_streams; ++pass) {
    const int64_t n = pass == 0 ? carried : slots;
    for (int64_t base = 0; base < n; base += kCompactThreads) {
      const int64_t i = base + tid;
      bool valid = false;
      int dest = 0;
      int32_t rec[R];
      if (i < n) {
        if (pass == 0) {
          const int32_t* src = sh.carry + i * (R + 1);
#pragma unroll
          for (int k = 0; k < R; ++k) rec[k] = src[k];
          dest = src[R];
          valid = true;
        } else {
          const int32_t c = sh.code[i];
          if (c >= 0 && (c >> 16) == pass - 1) {
            const int32_t* src = sh.stage + i * R;
#pragma unroll
            for (int k = 0; k < R; ++k) rec[k] = src[k];
            dest = c & 0xFFFF;
            valid = true;
          }
        }
      }
      const unsigned peers =
          __match_any_sync(0xFFFFFFFFu, valid ? (unsigned)dest : 0xFFFFFFFFu);
      const int below = __popc(peers & lower);
      const bool leader = valid && below == 0;
      if (leader) s_wcnt[warp][dest] = __popc(peers);
      __syncthreads();
      int64_t rank = 0;
      if (valid) {
        rank = s_cnt[dest] + below;
        for (int w = 0; w < warp; ++w) rank += s_wcnt[w][dest];
      }
      const bool left = valid && rank >= a.cap;
      const unsigned lball = __ballot_sync(0xFFFFFFFFu, left);
      if (lane == 0) s_wleft[warp] = __popc(lball);
      __syncthreads();
      if (valid && !left) {
        int32_t* dst = sh.outbox + ((int64_t)dest * a.cap + rank) * R;
#pragma unroll
        for (int k = 0; k < R; ++k) dst[k] = rec[k];
      } else if (left) {
        int64_t lrank = s_left + __popc(lball & lower);
        for (int w = 0; w < warp; ++w) lrank += s_wleft[w];
        if (lrank < a.ccap) {
          int32_t* dst = sh.carry + lrank * (R + 1);
#pragma unroll
          for (int k = 0; k < R; ++k) dst[k] = rec[k];
          dst[R] = dest;
        }
      }
      __syncthreads();
      if (leader) {
        atomicAdd(&s_cnt[dest], s_wcnt[warp][dest]);
        s_wcnt[warp][dest] = 0;
      }
      if (tid == 0) {
        int chunk_left = 0;
        for (int w = 0; w < kCompactWarps; ++w) chunk_left += s_wleft[w];
        s_left += chunk_left;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  if (tid == 0) {
    int64_t boxed = 0;
    for (int d = 0; d < nd; ++d) boxed += min(s_cnt[d], a.cap);
    const int64_t left = s_left;
    a.live[2 * my] = boxed;
    a.live[2 * my + 1] = min(left, (int64_t)a.ccap);
    a.stats[3 * my + 2] += max(left - (int64_t)a.ccap, (int64_t)0);
  }
}

}  // namespace trw
