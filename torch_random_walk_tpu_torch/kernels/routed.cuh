// What K11 and K12 (kernels/routed.cu) share: the launch's layout, the record
// words, and the tiled compaction that builds a phase's outboxes and carry
// pool in the exchange order.
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
// Slots of a tile: a body block's inbox slots, and what a compaction block
// ranks (bindings.py ROUTED_TILE).
constexpr int kTile = 256;
constexpr int kTileWarps = kTile / 32;

// One shard's buffers (bindings.py _ROUTED_SHARD_FIELDS, in this order).
struct RoutedShard {
  const int32_t* meta;   // (S, 2) [start, deg] of the shard's nodes
  const int32_t* col;    // (E_max,) neighbour ids of its rows
  int32_t* walks;        // (blk + 1, L + 2) its walkers' positions
  const int32_t* inbox;  // (D * cap, R) this phase's arrivals
  int32_t* outbox;       // (D * cap, R) departures, chunk d for shard d
  int32_t* carry;        // (2, ccap, R + 1) two carry pools, last word the dest
  int32_t* stage;        // (max(D * cap, blk), R) each arrival's departure
  int32_t* code;         // (max(D * cap, blk),) its stream << 16 | dest, or -1
  int32_t* hist;         // stage departures by (tile, stream, dest)
  int32_t* pool_count;   // (2, ctiles + 1, D) each pool's records by (tile,
                         // dest); row ctiles holds the totals by dest
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
  const int64_t* live_all;         // every pipeline's live counts
  int64_t* phases;                 // the walk's phase counter
  int32_t num_live;                // words of live_all
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

// Tiles of a carry pool.
__host__ __device__ __forceinline__ int64_t pool_tiles(
    const TrwRoutedLaunch& a) {
  return ((int64_t)a.ccap + kTile - 1) / kTile;
}

__device__ __forceinline__ void shared_add(int64_t* addr, int64_t v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(addr),
            (unsigned long long)v);
}

// The block's departures by (stream, destination) into row `tile` of the
// shard's histogram, zeros included (code: stream << 16 | dest, or -1).
// Every thread of the block calls it.
template <int S>
__device__ void tile_histogram(const TrwRoutedLaunch& a,
                               const RoutedShard& sh, int64_t tile,
                               int32_t code) {
  __shared__ int s_hist[S * kRoutedMaxShards];
  const int pairs = S * a.num_shards;
  for (int p = threadIdx.x; p < pairs; p += kTile) s_hist[p] = 0;
  __syncthreads();
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, (unsigned)code);
  if (code >= 0 && __popc(peers & ((1u << (threadIdx.x & 31)) - 1u)) == 0) {
    atomicAdd(&s_hist[(code >> 16) * a.num_shards + (code & 0xFFFF)],
              __popc(peers));
  }
  __syncthreads();
  int32_t* row = sh.hist + tile * pairs;
  for (int p = threadIdx.x; p < pairs; p += kTile) row[p] = s_hist[p];
}

// Over rows [0, rows) of a (rows, width) histogram: add each column's sum of
// the rows before `before` to base[col] and, if `total`, its sum of all rows
// to total[col].  Threads take one column and every rows_step-th row, with
// the loads in flight together and no division in the loop.
__device__ __forceinline__ void sum_rows(const int32_t* hist, int64_t rows,
                                         int width, int64_t before,
                                         int64_t* base, int* total) {
  for (int c0 = 0; c0 < width; c0 += kTile) {
    const int cols = min(width - c0, kTile);
    const int rows_step = kTile / cols;
    const int col = c0 + threadIdx.x % cols;
    const int row0 = threadIdx.x / cols;
    if (row0 >= rows_step) continue;
    int pre = 0, all = 0;
    const int32_t* src = hist + col;
#pragma unroll 8
    for (int64_t r = row0; r < rows; r += rows_step) {
      const int v = src[r * width];
      all += v;
      pre += r < before ? v : 0;
    }
    if (pre) shared_add(&base[col], pre);
    if (total != nullptr && all) atomicAdd(&total[col], all);
  }
}

// The exchange order (parallel/partition_v2.py::build_outbox, the JAX
// package's _build_outbox): shard my's candidates are its carry pool's live
// prefix, then the arrivals' departures of stream 0, 1, ... in slot order.
// Destination d takes its first cap candidates; the rest fill the carry pool
// in order, up to ccap, and the excess is dropped and counted.
//
// The candidates fall into segments of at most kTile: each tile of the pool,
// then each (stream, stage tile).  A block takes one tile of one shard, of
// the pool or of the stage over all S streams, so the grid spreads over the
// card, and it needs no other block: a segment's rank base for destination
// d, the count of d's candidates before it, is read from histograms that
// were complete before the launch (the pool's tiles before it; or the whole
// pool, the lower streams' totals and the same stream's earlier tiles).  Its
// carry base, the count of leftovers before it, is sum_d max(0, base_d -
// cap).  Within the segment a candidate's rank is its base plus the same
// destination's candidates of the lower warps (a count per warp in shared
// memory, set by the first lane of each __match_any_sync group) plus its
// lower lanes of the group; its carry rank the carry base plus the lower
// warps' and lanes' leftovers (ballots).
//
// The pools are double-buffered: pool `cur` (the live one) is read and pool
// 1 - cur written, with its counts by (tile, dest), by atomics into counts
// that the body kernel zeroed.  Stage tile 0 of each shard writes its live
// counts and adds its dropped records, from the same histograms' totals.
// Dynamic shared memory: routed_compact_smem(S, D) bytes.
__host__ __device__ constexpr int64_t routed_compact_smem(int s, int nd) {
  return (int64_t)s * nd * (8 + 4 + 4 * kTileWarps);
}

template <int R, int S>
__global__ void __launch_bounds__(kTile)
    routed_compact_kernel(const TrwRoutedLaunch a, int64_t slots, int cur) {
  extern __shared__ int64_t s_dyn[];
  __shared__ int64_t s_pool_len, s_boxed, s_left;
  __shared__ int64_t s_lbase[S];
  __shared__ int s_wleft[kTileWarps][S];
  const int nd = a.num_shards, my = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const RoutedShard sh = a.shards[my];
  const int64_t ntiles = (slots + kTile - 1) / kTile;
  const int64_t nct = pool_tiles(a);
  const int64_t totals = nct * nd;  // the pool counts' row of totals
  const int32_t* cnt_cur = sh.pool_count + cur * (nct + 1) * nd;
  int32_t* cnt_next = sh.pool_count + (1 - cur) * (nct + 1) * nd;
  const int32_t* pool_cur = sh.carry + (int64_t)cur * a.ccap * (R + 1);
  int32_t* pool_next = sh.carry + (int64_t)(1 - cur) * a.ccap * (R + 1);
  const bool from_pool = blockIdx.x >= ntiles;
  const int64_t tile = from_pool ? blockIdx.x - ntiles : blockIdx.x;
  const int nseg = from_pool ? 1 : S;  // streams of this block's candidates
  const int pairs = nseg * nd;
  const bool keeper = !from_pool && tile == 0;  // writes the live counts
  int64_t* s_base = s_dyn;                               // [pairs]
  int* s_total = reinterpret_cast<int*>(s_dyn + S * nd);  // [S * nd]
  int* s_wcnt = s_total + S * nd;                        // [warps][pairs]

  for (int p = tid; p < S * nd; p += kTile) {
    s_base[p] = 0;
    s_total[p] = 0;
  }
  for (int p = tid; p < kTileWarps * pairs; p += kTile) s_wcnt[p] = 0;
  if (tid < S) s_lbase[tid] = 0;
  if (tid == 0) s_pool_len = s_boxed = s_left = 0;
  __syncthreads();
  if (tid < nd) shared_add(&s_pool_len, cnt_cur[totals + tid]);
  __syncthreads();

  // This thread's candidate.
  const int64_t i = tile * kTile + tid;
  bool valid = false;
  int seg = 0, dest = 0;
  int32_t rec[R];
  if (from_pool) {
    if (i < s_pool_len) {
      const int32_t* src = pool_cur + i * (R + 1);
#pragma unroll
      for (int k = 0; k < R; ++k) rec[k] = src[k];
      dest = src[R];
      valid = true;
    }
  } else if (i < slots) {
    const int32_t c = sh.code[i];
    if (c >= 0) {
      const int32_t* src = sh.stage + i * R;
#pragma unroll
      for (int k = 0; k < R; ++k) rec[k] = src[k];
      seg = c >> 16;
      dest = c & 0xFFFF;
      valid = true;
    }
  }
  if (!__syncthreads_or(valid) && !keeper) return;

  // Rank bases: the counts of each destination's candidates before this
  // block's segments, summed over histogram rows (a thread keeps one pair's
  // sums over every rows_step-th row, then adds them in shared memory).
  if (from_pool) {
    sum_rows(cnt_cur, tile, nd, tile, s_base, nullptr);
  } else {
    sum_rows(sh.hist, ntiles, S * nd, tile, s_base, s_total);
  }
  __syncthreads();
  if (!from_pool) {
    for (int p = tid; p < pairs; p += kTile) {
      const int d = p % nd;
      int64_t b = cnt_cur[totals + d];
      for (int s = 0; s < p / nd; ++s) b += s_total[s * nd + d];
      s_base[p] += b;
    }
    __syncthreads();
  }
  for (int p = tid; p < pairs; p += kTile) {
    const int64_t over = s_base[p] - a.cap;
    if (over > 0) shared_add(&s_lbase[p / nd], over);
  }
  if (keeper && tid < nd) {
    int64_t n = cnt_cur[totals + tid];
    for (int s = 0; s < S; ++s) n += s_total[s * nd + tid];
    shared_add(&s_boxed, min(n, (int64_t)a.cap));
    shared_add(&s_left, max(n - a.cap, (int64_t)0));
  }

  // Ranks within the segment.
  const int key = valid ? seg * nd + dest : -1;
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, (unsigned)key);
  const int below = __popc(peers & lower);
  if (valid && below == 0) s_wcnt[warp * pairs + key] = __popc(peers);
  __syncthreads();
  int64_t rank = 0;
  if (valid) {
    rank = s_base[key] + below;
    for (int w = 0; w < warp; ++w) rank += s_wcnt[w * pairs + key];
  }
  const bool left = valid && rank >= a.cap;
  unsigned lball = 0;
  for (int s = 0; s < nseg; ++s) {
    const unsigned b = __ballot_sync(0xFFFFFFFFu, left && seg == s);
    if (lane == 0) s_wleft[warp][s] = __popc(b);
    if (seg == s) lball = b;
  }
  __syncthreads();
  int64_t lrank = 0;
  if (valid && !left) {
    int32_t* dst = sh.outbox + ((int64_t)dest * a.cap + rank) * R;
#pragma unroll
    for (int k = 0; k < R; ++k) dst[k] = rec[k];
  } else if (left) {
    lrank = s_lbase[seg] + __popc(lball & lower);
    for (int w = 0; w < warp; ++w) lrank += s_wleft[w][seg];
    if (lrank < a.ccap) {
      int32_t* dst = pool_next + lrank * (R + 1);
#pragma unroll
      for (int k = 0; k < R; ++k) dst[k] = rec[k];
      dst[R] = dest;
    }
  }
  // The new pool's counts, one atomic per (pool tile, dest) group of a warp.
  const bool stored = left && lrank < a.ccap;
  const unsigned ckey =
      stored ? (unsigned)(((lrank / kTile) << 8) | dest) : 0xFFFFFFFFu;
  const unsigned cpeers = __match_any_sync(0xFFFFFFFFu, ckey);
  if (stored && __popc(cpeers & lower) == 0) {
    atomicAdd(&cnt_next[(lrank / kTile) * nd + dest], __popc(cpeers));
    atomicAdd(&cnt_next[totals + dest], __popc(cpeers));
  }
  if (keeper && tid == 0) {
    a.live[2 * my] = s_boxed;
    a.live[2 * my + 1] = min(s_left, (int64_t)a.ccap);
    a.stats[3 * my + 2] += max(s_left - (int64_t)a.ccap, (int64_t)0);
  }
}

}  // namespace trw
