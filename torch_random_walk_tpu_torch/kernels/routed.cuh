// What the routed phase kernels share (K11 and K12 in kernels/routed.cu, K13,
// K14 and K15 in kernels/routed_families.cu): the launch's layout, the record
// words, the body's bookkeeping, the membership tests and the tiled
// compaction that builds a phase's outboxes and carry pool in the exchange
// order.
//
// A routed walk keeps, for every shard s of D, the tensors that
// parallel/partition_v2.py::RoutedWalk allocates; the wrapper
// (kernels/bindings.py::routed_phase_launch) packs their base pointers into
// one RoutedShard per shard, on the card, and the phase's scalars into one
// TrwRoutedLaunch.  Records are uint32 words held in int32 tensors.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

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
  const int32_t* col;    // (E_max,) neighbour ids of its rows; K13: (E_max,
                         // 2) [relation, tail] rows
  int32_t* walks;        // (blk + 1, walk_cols) its walkers' positions
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
  int64_t* stats;  // (D, stats_width): logged, sent, dropped (add), and
                   // for K13-K15 terminated
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
  int32_t stats_width;  // 3 (K11, K12) or 4 (K13-K15: terminated)
  int32_t walk_cols;    // row stride of the walk rows: L + 2, or 2L + 2 (K13)
  int32_t padding;      // K13-K15: the padding id
  int32_t restart;      // K14, K15: a dead end jumps back to the target
  int32_t* flow;        // K13-K15 (else null): the pipeline's outbox
                        // counts, (2, flow_words(D)) by pool parity
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
__device__ __forceinline__ void tile_histogram(const TrwRoutedLaunch& a,
                                               const RoutedShard& sh,
                                               int64_t tile, int32_t code) {
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

// A word that this launch may have written from another block: with
// COHERENT, read from L2 (ld.global.cg), since this SM's L1 may hold a stale
// copy; else an ordinary load (the per-phase launches, whose inputs were
// complete before they started).
template <bool COHERENT, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (COHERENT) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// Over rows [0, rows) of a (rows, width) histogram: add each column's sum of
// the rows before `before` to base[col] and, if `total`, its sum of all rows
// to total[col].  Threads take one column and every rows_step-th row, with
// the loads in flight together and no division in the loop.
template <bool COHERENT>
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
      const int v = load<COHERENT>(src + r * width);
      all += v;
      pre += r < before ? v : 0;
    }
    if (pre) shared_add(&base[col], pre);
    if (total != nullptr && all) atomicAdd(&total[col], all);
  }
}

// Words of one parity of a pipeline's flow counts (TrwRoutedLaunch.flow):
// box[src][dest], the records shard src boxed for dest, at [src * D + dest];
// each destination's records in, summed over sources, at [D * D + dest];
// the largest box count at [D * D + D].
__host__ __device__ constexpr int64_t flow_words(int nd) {
  return (int64_t)nd * nd + nd + 1;
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
// were complete before the launch, or before the grid barrier that precedes
// the persistent kernel's compaction step (the pool's tiles before it; or
// the whole pool, the lower streams' totals and the same stream's earlier
// tiles).  Its
// carry base, the count of leftovers before it, is sum_d max(0, base_d -
// cap).  Within the segment a candidate's rank is its base plus the same
// destination's candidates of the lower warps (a count per warp in shared
// memory, set by the first lane of each __match_any_sync group) plus its
// lower lanes of the group; its carry rank the carry base plus the lower
// warps' and lanes' leftovers (ballots).
//
// The pools are double-buffered: pool `cur` (the live one) is read and pool
// 1 - cur written, with its counts by (tile, dest), by atomics into counts
// that the body zeroed.  Stage tile 0 of each shard (its keeper) writes its
// live counts and adds its dropped records, from the same histograms'
// totals.
// Dynamic shared memory: routed_compact_smem(S, D) bytes.
__host__ __device__ constexpr int64_t routed_compact_smem(int s, int nd) {
  return (int64_t)s * nd * (8 + 4 + 4 * kTileWarps);
}

// One block's tile of shard `my`: stage tile `tile` (over `slots` stage
// slots) or, if `from_pool`, tile `tile` of the live carry pool `cur`.  Every
// thread of the block calls it; a block whose tile holds no candidate skips
// the rest (all its threads together), unless it is the shard's keeper.
// With a flow buffer the keeper also writes the shard's box counts by
// destination, and adds them to the destinations' totals and the largest
// count, into the parity that the next phase reads (1 - cur), which the
// caller has zeroed.  COHERENT (the persistent kernel, whose caller knows
// the live pool's length, `pool_len`): the candidate, the pool's totals and
// the histogram rows are loaded together, before the block's first
// barrier, and no block skips (its tiles hold records by construction).
template <int R, int S, bool COHERENT>
__device__ __forceinline__ void compact_tile(const TrwRoutedLaunch& a, int my,
                                             bool from_pool, int64_t tile,
                                             int64_t slots, int cur,
                                             int64_t pool_len = -1) {
  extern __shared__ int64_t s_dyn[];
  __shared__ int64_t s_pool_len, s_boxed, s_left;
  __shared__ int64_t s_lbase[S];
  __shared__ int s_wleft[kTileWarps][S];
  __shared__ int s_ptot[kRoutedMaxShards];  // the live pool's records by dest
  const int nd = a.num_shards;
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
  const int nseg = from_pool ? 1 : S;  // streams of this block's candidates
  const int pairs = nseg * nd;
  const bool keeper = !from_pool && tile == 0;  // writes the live counts
  int64_t* s_base = s_dyn;                               // [pairs]
  int* s_total = reinterpret_cast<int*>(s_dyn + S * nd);  // [S * nd]
  int* s_wcnt = s_total + S * nd;                        // [warps][pairs]

  __syncthreads();  // the block's previous tile is done with shared memory
  for (int p = tid; p < S * nd; p += kTile) {
    s_base[p] = 0;
    s_total[p] = 0;
  }
  for (int p = tid; p < kTileWarps * pairs; p += kTile) s_wcnt[p] = 0;
  if (tid < S) s_lbase[tid] = 0;
  if (tid == 0) s_pool_len = s_boxed = s_left = 0;
  const int ptot = tid < nd ? load<COHERENT>(cnt_cur + totals + tid) : 0;

  // This thread's candidate.
  const int64_t i = tile * kTile + tid;
  bool valid = false;
  int seg = 0, dest = 0;
  int32_t rec[R];
  auto take = [&](int64_t plen) {
    if (from_pool) {
      if (i < plen) {
        const int32_t* src = pool_cur + i * (R + 1);
#pragma unroll
        for (int k = 0; k < R; ++k) rec[k] = load<COHERENT>(src + k);
        dest = load<COHERENT>(src + R);
        valid = true;
      }
    } else if (i < slots) {
      const int32_t c = load<COHERENT>(sh.code + i);
      const int32_t* src = sh.stage + i * R;
      // The persistent kernel's narrow records are loaded beside the code
      // (K15's 15 words wait for it: their registers are what it lacks).
      if ((COHERENT && R <= 4) || c >= 0) {
#pragma unroll
        for (int k = 0; k < R; ++k) rec[k] = load<COHERENT>(src + k);
      }
      if (c >= 0) {
        seg = c >> 16;
        dest = c & 0xFFFF;
        valid = true;
      }
    }
  };
  if (tid < nd) s_ptot[tid] = ptot;
  if constexpr (COHERENT) {
    take(pool_len);
    __syncthreads();
  } else {
    __syncthreads();
    if (tid < nd) shared_add(&s_pool_len, ptot);
    __syncthreads();
    take(s_pool_len);
    if (!__syncthreads_or(valid) && !keeper) return;
  }

  // Rank bases: the counts of each destination's candidates before this
  // block's segments, summed over histogram rows (a thread keeps one pair's
  // sums over every rows_step-th row, then adds them in shared memory).
  if (from_pool) {
    sum_rows<COHERENT>(cnt_cur, tile, nd, tile, s_base, nullptr);
  } else {
    sum_rows<COHERENT>(sh.hist, ntiles, S * nd, tile, s_base, s_total);
  }
  __syncthreads();
  if (!from_pool) {
    for (int p = tid; p < pairs; p += kTile) {
      const int d = p % nd;
      int64_t b = s_ptot[d];
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
    int64_t n = ptot;
    for (int s = 0; s < S; ++s) n += s_total[s * nd + tid];
    const int boxed = (int)min(n, (int64_t)a.cap);
    shared_add(&s_boxed, boxed);
    shared_add(&s_left, max(n - a.cap, (int64_t)0));
    if (a.flow != nullptr) {
      int32_t* f = a.flow + (1 - cur) * flow_words(nd);
      f[(int64_t)my * nd + tid] = boxed;
      if (boxed) {
        atomicAdd(&f[(int64_t)nd * nd + tid], boxed);
        atomicMax(&f[(int64_t)nd * nd + nd], boxed);
      }
    }
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
    shared_add(&a.stats[(int64_t)a.stats_width * my + 2],
               max(s_left - (int64_t)a.ccap, (int64_t)0));
  }
}

// The per-phase compaction launch: a block per tile of every shard (grid:
// stage tiles, then pool tiles, by D).
template <int R, int S>
__global__ void __launch_bounds__(kTile)
    routed_compact_kernel(const TrwRoutedLaunch a, int64_t slots, int cur) {
  const int64_t ntiles = (slots + kTile - 1) / kTile;
  const bool from_pool = blockIdx.x >= ntiles;
  compact_tile<R, S, false>(a, blockIdx.y, from_pool,
                            from_pool ? blockIdx.x - ntiles : blockIdx.x,
                            slots, cur);
}

// --- the body kernels' shared steps ------------------------------------------

constexpr int kBodyThreads = kTile;
constexpr uint32_t kLogBit = 0x80000000u;  // LOG hop (K11, K13, K14)
// node2vec flags (K12, K15: the top byte of word 1).
constexpr uint32_t kFMode = 1, kFHasA = 2, kFOvf = 4, kFLog = 32;

// Reset the block's slots of the outbox to the sentinel record, a word a
// thread at a time.
template <int R>
__device__ __forceinline__ void clear_outbox(const RoutedShard& sh,
                                             int64_t first, int64_t slots) {
  const int64_t end = min(first + kBodyThreads, slots) * R;
  for (int64_t w = first * R + threadIdx.x; w < end; w += kBodyThreads) {
    sh.outbox[w] = (w % R == 0) ? -1 : 0;
  }
}

// Zero the counts of carry pool `pool`, which the compaction fills, a word a
// thread over the body's grid.
__device__ __forceinline__ void clear_pool_count(const TrwRoutedLaunch& a,
                                                 const RoutedShard& sh,
                                                 int pool) {
  const int64_t words = (pool_tiles(a) + 1) * a.num_shards;
  int32_t* c = sh.pool_count + pool * words;
  for (int64_t w = (int64_t)blockIdx.x * kBodyThreads + threadIdx.x;
       w < words; w += (int64_t)gridDim.x * kBodyThreads) {
    c[w] = 0;
  }
}

// The walk's phase counter: one more if any record of any pipeline was in
// flight before this phase.  Block (0, 0) of the body.
__device__ __forceinline__ void count_phase(const TrwRoutedLaunch& a) {
  if (blockIdx.x != 0 || blockIdx.y != 0) return;
  bool any = false;
  for (int i = threadIdx.x; i < a.num_live; i += kBodyThreads) {
    any |= a.live_all[i] > 0;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) *a.phases += 1;
}

// Write column `col` of the walker's row in the wid-owner's walk rows.
__device__ __forceinline__ void log_position(const RoutedShard& sh, int my,
                                             uint32_t wid, uint32_t col,
                                             int32_t v,
                                             const TrwRoutedLaunch& a) {
  const int64_t row = (int64_t)wid - (int64_t)my * a.blk;
  sh.walks[row * a.walk_cols + col] = v;
}

__device__ __forceinline__ int wid_owner(uint32_t wid,
                                         const TrwRoutedLaunch& a) {
  return (int)min(wid / (uint32_t)a.blk, (uint32_t)(a.num_shards - 1));
}

__device__ __forceinline__ void add_stat(const TrwRoutedLaunch& a, int my,
                                         int column, int n) {
  if (n) {
    atomicAdd(reinterpret_cast<unsigned long long*>(
                  &a.stats[(int64_t)a.stats_width * my + column]),
              (unsigned long long)n);
  }
}

// Counters of the block: logged positions and departures.
__device__ __forceinline__ void count_block(const TrwRoutedLaunch& a, int my,
                                            bool logged, bool sent) {
  const int n_log = __syncthreads_count(logged);
  const int n_sent = __syncthreads_count(sent);
  if (threadIdx.x == 0) {
    add_stat(a, my, 0, n_log);
    add_stat(a, my, 1, n_sent);
  }
}

// K13-K15: the block's walkers that ended here (column 3).
__device__ __forceinline__ void count_terminated(const TrwRoutedLaunch& a,
                                                 int my, bool done) {
  const int n = __syncthreads_count(done);
  if (threadIdx.x == 0) add_stat(a, my, 3, n);
}

// Slot of key (lo, hi) under hash `which` (graph/hashset.py::hash_slot).
__device__ __forceinline__ uint32_t cuckoo_slot(uint32_t lo, uint32_t hi,
                                                uint32_t salt, int which,
                                                int log_size) {
  const uint32_t a = (which ? 0xC2B2AE3Du : 0x9E3779B1u) ^ salt;
  const uint32_t b = (which ? 0x27D4EB2Fu : 0x85EBCA77u) ^ (salt * 0x9E3779B9u);
  uint32_t h = lo * a + hi * b + (uint32_t)(which + 1);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  return h >> (32 - log_size);
}

// Is cand an out-neighbour of t?  Asked at owner(t) only.
template <bool SEARCH>
__device__ __forceinline__ bool contains(const RoutedShard& sh, int my,
                                         int32_t t, int32_t cand,
                                         const TrwRoutedLaunch& a) {
  if (SEARCH) {  // the 32-trip binary search of t's sorted row
    const int64_t lt = local_row(t, my, a);
    int64_t lo = sh.meta[2 * lt];
    int64_t hi = lo + sh.meta[2 * lt + 1];
    const int64_t end = hi;
    for (int it = 0; it < 32 && lo < hi; ++it) {
      const int64_t mid = (lo + hi) >> 1;
      if (col_at(sh, mid, a) < cand) lo = mid + 1; else hi = mid;
    }
    return lo < end && col_at(sh, lo, a) == cand;
  }
  const uint32_t lo32 = (uint32_t)cand, hi32 = (uint32_t)t;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const uint32_t pos =
        cuckoo_slot(lo32, hi32, (uint32_t)sh.salt, which, a.hash_log);
    if ((uint32_t)sh.hash[2 * pos] == lo32 &&
        (uint32_t)sh.hash[2 * pos + 1] == hi32) {
      return true;
    }
  }
  return false;
}

// True unless the 128-bit filter proves x is not in its set
// (graph/bloom.py::bloom_maybe).
__device__ __forceinline__ bool bloom_maybe(const uint32_t f[4], uint32_t x) {
  const uint32_t muls[2] = {0x9E3779B9u, 0x85EBCA6Bu};
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const uint32_t pos = __umulhi(x * muls[m], 128u);
    const uint32_t word = pos >> 5;
    const uint32_t w = word == 0 ? f[0] : word == 1 ? f[1]
                     : word == 2 ? f[2] : f[3];
    if (!((w >> (pos & 31)) & 1u)) return false;
  }
  return true;
}

__device__ __forceinline__ float accept_uniform(const TrwRoutedLaunch& a,
                                                uint32_t wid, uint32_t s,
                                                uint32_t rnd) {
  return uniform24(threefry2x32(a.key0, a.key1, wid,
                                step_round_counter(s, rnd)).x1);
}

// --- host side of a phase call -------------------------------------------------

inline bool launch_ok(const TrwRoutedLaunch& a, int cur) {
  return a.num_shards >= 1 && a.num_shards <= kRoutedMaxShards &&
         a.cap >= 1 && a.ccap >= 1 && a.blk >= 1 && a.shard_nodes >= 1 &&
         a.e_max >= 1 && a.walk_length >= 0 && a.num_live >= 1 &&
         (a.stats_width == 3 || a.stats_width == 4) &&
         a.walk_cols >= a.walk_length + 2 && (cur == 0 || cur == 1);
}

inline dim3 tile_grid(const TrwRoutedLaunch& a, int64_t slots,
                      int64_t extra = 0) {
  return dim3((unsigned)((slots + kTile - 1) / kTile + extra),
              (unsigned)a.num_shards);
}

// The compaction of `slots` stage slots and the live carry pool `cur`.
template <int R, int S>
void compact(const TrwRoutedLaunch& a, int64_t slots, int cur,
             cudaStream_t st) {
  routed_compact_kernel<R, S>
      <<<tile_grid(a, slots, pool_tiles(a)), kTile,
         routed_compact_smem(S, a.num_shards), st>>>(a, slots, cur);
}

}  // namespace trw
