// K11 and K12: the phase body of the owner-routed walk engines, every shard
// in one call.
//
// Replaces the XLA phase body of the JAX package's routed engines,
// torch_random_walk_tpu/parallel/partition_v2.py (no Pallas counterpart):
// K11 the uniform one, `process` in _routed_uniform_jit:325 with
// _build_outbox:176; K12 the node2vec one, `process` in _routed_n2v_jit:675.
// The plain PyTorch version is parallel/partition_v2.py::RoutedWalk with
// body="plain".
//
// A call is two launches on PyTorch's stream:
// - the body kernel, a thread per inbox slot of every shard (grid: slots /
//   256 by D), logs LOG arrivals into the wid-owner's walk rows and counts
//   them, draws for STEP arrivals (and, in K12, answers RESOLVE arrivals)
//   with the JAX package's Threefry counters, and writes each arrival's one
//   departure into the shard's stage buffer with its stream and destination,
//   and its block's departures by (stream, destination) into the shard's
//   histogram; it also resets the outbox to sentinel records and zeroes the
//   counts of the carry pool that the compaction fills; its first block
//   adds one to the walk's phase counter if any record was in flight before
//   the phase (the JAX loop's test), so a phase enqueued after the end
//   changes nothing but that launch;
// - the compaction kernel (routed.cuh, routed_compact_kernel), a block per
//   tile of 256 stage slots or carry pool slots of every shard, builds the
//   outbox and the other carry pool in the exchange order from the
//   histograms and sets the shard's live counts (boxed, carried), which the
//   host reads once per batch of phases.
// Phase 0 is a histogram launch and the compaction (trw_routed_start), of
// the first records the host stages.
//
// Bound on this card: bytes.  A phase reads each live record once, writes it
// once to the stage and once to the outbox or the pool, and gathers one graph
// row (two meta words and one col word a draw); at the routed legs' sizes
// that is well under a microsecond a phase, so a phase's time is its
// launches, their tails and the histograms' reads.  Both kernels spread over
// the whole card; blocks of the compaction whose tile holds no candidate
// return after one barrier.

#include <cstdint>
#include <cuda_runtime.h>

#include "routed.cuh"
#include "threefry.cuh"

namespace trw {

constexpr int kBodyThreads = kTile;
constexpr int kUniformStreams = 2;
constexpr int kNode2VecStreams = 4;
constexpr int kUniformWidth = 3;
constexpr int kNode2VecWidth = 14;
constexpr uint32_t kLogBit = 0x80000000u;  // uniform LOG hop
// node2vec flags (the top byte of word 1).
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

// Write walk[step] = v into the wid-owner's walk rows.
__device__ __forceinline__ void log_position(const RoutedShard& sh, int my,
                                             uint32_t wid, uint32_t step,
                                             int32_t v,
                                             const TrwRoutedLaunch& a) {
  const int64_t row = (int64_t)wid - (int64_t)my * a.blk;
  sh.walks[row * (a.walk_length + 2) + step] = v;
}

__device__ __forceinline__ int wid_owner(uint32_t wid,
                                         const TrwRoutedLaunch& a) {
  return (int)min(wid / (uint32_t)a.blk, (uint32_t)(a.num_shards - 1));
}

// Counters of the block: logged positions and departures.
__device__ __forceinline__ void count_block(const TrwRoutedLaunch& a, int my,
                                            bool logged, bool sent) {
  const int n_log = __syncthreads_count(logged);
  const int n_sent = __syncthreads_count(sent);
  if (threadIdx.x == 0) {
    if (n_log) {
      atomicAdd(reinterpret_cast<unsigned long long*>(&a.stats[3 * my]),
                (unsigned long long)n_log);
    }
    if (n_sent) {
      atomicAdd(reinterpret_cast<unsigned long long*>(&a.stats[3 * my + 1]),
                (unsigned long long)n_sent);
    }
  }
}

// K11's body: streams 0 = forwarded LOG records (to owner(v)), 1 = drawn
// records (to the wid-owner).
__global__ void __launch_bounds__(kBodyThreads)
    routed_uniform_body_kernel(const TrwRoutedLaunch a, int cur) {
  constexpr int R = kUniformWidth;
  const int my = blockIdx.y;
  const RoutedShard sh = a.shards[my];
  const int64_t slots = (int64_t)a.num_shards * a.cap;
  const int64_t first = (int64_t)blockIdx.x * kBodyThreads;
  count_phase(a);
  clear_outbox<R>(sh, first, slots);
  clear_pool_count(a, sh, 1 - cur);
  const int64_t i = first + threadIdx.x;
  bool logged = false;
  int32_t code = -1;
  if (i < slots) {
    const int32_t* rec = sh.inbox + i * R;
    const uint32_t wid = (uint32_t)rec[0];
    if (wid != kEmptyWid) {
      const uint32_t w1 = (uint32_t)rec[1];
      const uint32_t step = w1 & ~kLogBit;
      const int32_t v = rec[2];
      int32_t out1 = 0, out2 = 0;
      if (w1 & kLogBit) {
        log_position(sh, my, wid, step, v, a);
        logged = true;
        if (step < (uint32_t)a.walk_length) {
          out1 = (int32_t)step;
          out2 = v;
          code = owner_of(v, a);
        }
      } else if (step < (uint32_t)a.walk_length) {
        const int64_t local = local_row(v, my, a);
        const int64_t start = sh.meta[2 * local];
        const uint32_t deg = (uint32_t)sh.meta[2 * local + 1];
        const uint32_t bits =
            threefry2x32(a.key0, a.key1, wid,
                         step_round_counter(step + 1, 0)).x0;
        out1 = (int32_t)((step + 1) | kLogBit);
        out2 = deg > 0 ? col_at(sh, start + randint(bits, deg), a) : v;
        code = (1 << 16) | wid_owner(wid, a);
      }
      if (code >= 0) {
        int32_t* dst = sh.stage + i * R;
        dst[0] = (int32_t)wid;
        dst[1] = out1;
        dst[2] = out2;
      }
    }
    sh.code[i] = code;
  }
  tile_histogram<kUniformStreams>(a, sh, blockIdx.x, code);
  count_block(a, my, logged, code >= 0);
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

// K12's body: streams 0 = forwarded LOG records (to owner(v)), 1 = resolved
// steps (LOG records to the wid-owner), 2 = frozen draws (RESOLVE records to
// owner(t)), 3 = replays (STEP records back to owner(v)).
template <bool SEARCH>
__global__ void __launch_bounds__(kBodyThreads)
    routed_node2vec_body_kernel(const TrwRoutedLaunch a, int cur) {
  constexpr int R = kNode2VecWidth;
  const int my = blockIdx.y;
  const RoutedShard sh = a.shards[my];
  const int64_t slots = (int64_t)a.num_shards * a.cap;
  const int64_t first = (int64_t)blockIdx.x * kBodyThreads;
  count_phase(a);
  clear_outbox<R>(sh, first, slots);
  clear_pool_count(a, sh, 1 - cur);
  const int64_t i = first + threadIdx.x;
  bool logged = false;
  int32_t code = -1;
  if (i < slots) {
    uint32_t r[R];
    const int32_t* rec = sh.inbox + i * R;
#pragma unroll
    for (int k = 0; k < R; ++k) r[k] = (uint32_t)rec[k];
    const uint32_t wid = r[0];
    if (wid != kEmptyWid) {
      const uint32_t step = r[1] & 0xFFFFFFu;
      const uint32_t flags = r[1] >> 24;
      const int32_t t = (int32_t)r[2], v = (int32_t)r[3];
      const uint32_t s = step + 1;  // the step being taken
      const bool mode_log = flags & kFLog;
      const bool mode_resolve = !mode_log && (flags & kFMode);
      const bool live = step < (uint32_t)a.walk_length;
      uint32_t out[R];
#pragma unroll
      for (int k = 0; k < R; ++k) out[k] = 0;
      out[0] = wid;
      // The departure, by kind: the stream and its destination, and the
      // filter the record carries.
      const uint32_t* bloom_src = nullptr;
      int stream = -1, dest = 0;
      if (mode_log) {
        log_position(sh, my, wid, step, v, a);
        logged = true;
        if (live) {  // forward, flags cleared
#pragma unroll
          for (int k = 0; k < R; ++k) out[k] = r[k];
          out[1] = step;
          stream = 0;
          dest = owner_of(v, a);
        }
      } else if (!mode_resolve && live) {  // STEP at owner(v)
        const int64_t local = local_row(v, my, a);
        const int64_t start = sh.meta[2 * local];
        const uint32_t deg = (uint32_t)sh.meta[2 * local + 1];
        const uint32_t* v_bloom =
            reinterpret_cast<const uint32_t*>(sh.bloom) + 4 * local;
        int32_t next = v;
        bool done = true;
        if (s == 1) {  // first hop: a uniform draw, no acceptance test
          const uint32_t bits = threefry2x32(
              a.key0, a.key1, wid, step_round_counter(1, 0)).x0;
          if (deg > 0) next = col_at(sh, start + randint(bits, deg), a);
        } else if (deg > 0) {  // the speculative rejection scan
          const uint32_t tb[4] = {r[10], r[11], r[12], r[13]};
          const uint32_t rnd0 = r[4];
          bool has_a = false, ovf = false;
          int nf = 0;
          int32_t acand = v, f1 = v, f2 = v;
          uint32_t f1r = 0, f2r = 0, stop3 = 0;
          for (int k = 0; k < a.spec_rounds; ++k) {
            const uint32_t rk = rnd0 + (uint32_t)k;
            const U32x2 b =
                threefry2x32(a.key0, a.key1, wid, step_round_counter(s, rk));
            const int32_t cand = col_at(sh, start + randint(b.x0, deg), a);
            const float rr = uniform24(b.x1);
            bool acc, rej;
            if (cand == t) {
              acc = rr < a.prob0;
              rej = !acc;
            } else if (bloom_maybe(tb, (uint32_t)cand)) {
              acc = rr < a.lo_acc;
              rej = rr >= a.hi_acc;
            } else {
              acc = rr < a.prob2;
              rej = !acc;
            }
            if (acc) {
              acand = cand;
              has_a = true;
              break;
            }
            if (!rej) {  // frozen: its answer needs N(t)
              if (nf == 0) {
                f1 = cand;
                f1r = rk;
              } else if (nf == 1) {
                f2 = cand;
                f2r = rk;
              } else {
                ovf = true;
                stop3 = rk;
              }
              ++nf;
              if (ovf) break;
            }
          }
          const uint32_t replay = ovf ? stop3 : rnd0 + (uint32_t)a.spec_rounds;
          if (has_a && nf == 0) {
            next = acand;
          } else if (nf >= 1) {  // RESOLVE at owner(t), carrying N(v)
            done = false;
            out[1] = step | ((kFMode | (has_a ? kFHasA : 0u) |
                              (ovf ? kFOvf : 0u) | ((uint32_t)min(nf, 2) << 3))
                             << 24);
            out[2] = (uint32_t)t;
            out[3] = (uint32_t)v;
            out[4] = replay;
            out[5] = (uint32_t)acand;
            out[6] = (uint32_t)f1;
            out[7] = f1r;
            out[8] = (uint32_t)f2;
            out[9] = f2r;
            bloom_src = v_bloom;
            stream = 2;
            dest = owner_of(t, a);
          } else {  // every round rejected: replay at owner(v), N(t) kept
            done = false;
            out[1] = step;
            out[2] = (uint32_t)t;
            out[3] = (uint32_t)v;
            out[4] = replay;
#pragma unroll
            for (int k = 0; k < 4; ++k) out[10 + k] = tb[k];
            stream = 3;
            dest = owner_of(v, a);
          }
        }
        if (done) {  // LOG record to the wid-owner, carrying N(v)
          out[1] = s | (kFLog << 24);
          out[2] = (uint32_t)v;
          out[3] = (uint32_t)next;
          bloom_src = v_bloom;
          stream = 1;
          dest = wid_owner(wid, a);
        }
      } else if (mode_resolve) {  // RESOLVE at owner(t)
        const int32_t f1c = (int32_t)r[6], f2c = (int32_t)r[8];
        const uint32_t n_f = flags >> 3;
        const float r1 = accept_uniform(a, wid, s, r[7]);
        const float r2 = accept_uniform(a, wid, s, r[9]);
        const bool acc1 = contains<SEARCH>(sh, my, t, f1c, a) ? r1 < a.prob1
                                                               : r1 < a.prob2;
        const bool acc2 =
            n_f >= 2 && !acc1 &&
            (contains<SEARCH>(sh, my, t, f2c, a) ? r2 < a.prob1
                                                  : r2 < a.prob2);
        if (acc1 || acc2 || (flags & kFHasA)) {  // LOG record, N(v) shipped
          out[1] = s | (kFLog << 24);
          out[2] = (uint32_t)v;
          out[3] = acc1 ? (uint32_t)f1c : acc2 ? (uint32_t)f2c : r[5];
#pragma unroll
          for (int k = 0; k < 4; ++k) out[10 + k] = r[10 + k];
          stream = 1;
          dest = wid_owner(wid, a);
        } else {  // replay at owner(v), carrying N(t) (local here)
          out[1] = step;
          out[2] = (uint32_t)t;
          out[3] = (uint32_t)v;
          out[4] = r[4];
          bloom_src = reinterpret_cast<const uint32_t*>(sh.bloom) +
                      4 * local_row(t, my, a);
          stream = 3;
          dest = owner_of(v, a);
        }
      }
      if (stream >= 0) {
        if (bloom_src != nullptr) {
#pragma unroll
          for (int k = 0; k < 4; ++k) out[10 + k] = bloom_src[k];
        }
        int32_t* dst = sh.stage + i * R;
#pragma unroll
        for (int k = 0; k < R; ++k) dst[k] = (int32_t)out[k];
        code = (stream << 16) | dest;
      }
    }
    sh.code[i] = code;
  }
  tile_histogram<kNode2VecStreams>(a, sh, blockIdx.x, code);
  count_block(a, my, logged, code >= 0);
}

// Phase 0's histogram: the host-staged codes of the first `slots` stage
// slots, one stream.
__global__ void __launch_bounds__(kTile)
    routed_stage_hist_kernel(const TrwRoutedLaunch a, int64_t slots) {
  const RoutedShard sh = a.shards[blockIdx.y];
  const int64_t i = (int64_t)blockIdx.x * kTile + threadIdx.x;
  tile_histogram<1>(a, sh, blockIdx.x, i < slots ? sh.code[i] : -1);
}

}  // namespace trw

namespace {

bool launch_ok(const TrwRoutedLaunch& a, int cur) {
  return a.num_shards >= 1 && a.num_shards <= trw::kRoutedMaxShards &&
         a.cap >= 1 && a.ccap >= 1 && a.blk >= 1 && a.shard_nodes >= 1 &&
         a.e_max >= 1 && a.walk_length >= 0 && a.num_live >= 1 &&
         (cur == 0 || cur == 1);
}

dim3 tile_grid(const TrwRoutedLaunch& a, int64_t slots, int64_t extra = 0) {
  return dim3((unsigned)((slots + trw::kTile - 1) / trw::kTile + extra),
              (unsigned)a.num_shards);
}

// The compaction of `slots` stage slots and the live carry pool `cur`.
template <int R, int S>
void compact(const TrwRoutedLaunch& a, int64_t slots, int cur,
             cudaStream_t st) {
  trw::routed_compact_kernel<R, S>
      <<<tile_grid(a, slots, trw::pool_tiles(a)), trw::kTile,
         trw::routed_compact_smem(S, a.num_shards), st>>>(a, slots, cur);
}

}  // namespace

// K11: one phase of the uniform engine for every shard; carry pool `cur` is
// the live one, and the other is filled.
extern "C" int trw_routed_uniform_phase(const TrwRoutedLaunch* launch,
                                        int cur, void* stream) {
  const TrwRoutedLaunch& a = *launch;
  if (!launch_ok(a, cur)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t slots = (int64_t)a.num_shards * a.cap;
  trw::routed_uniform_body_kernel<<<tile_grid(a, slots), trw::kTile, 0, st>>>(
      a, cur);
  compact<trw::kUniformWidth, trw::kUniformStreams>(a, slots, cur, st);
  return (int)cudaGetLastError();
}

// K12: one phase of the node2vec engine for every shard, as K11's.
extern "C" int trw_routed_node2vec_phase(const TrwRoutedLaunch* launch,
                                         int cur, void* stream) {
  const TrwRoutedLaunch& a = *launch;
  if (!launch_ok(a, cur) || a.walk_length >= (1 << 24) || a.spec_rounds < 1 ||
      (!a.use_search && (a.hash_log < 1 || a.hash_log > 31))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t slots = (int64_t)a.num_shards * a.cap;
  if (a.use_search) {
    trw::routed_node2vec_body_kernel<true>
        <<<tile_grid(a, slots), trw::kTile, 0, st>>>(a, cur);
  } else {
    trw::routed_node2vec_body_kernel<false>
        <<<tile_grid(a, slots), trw::kTile, 0, st>>>(a, cur);
  }
  compact<trw::kNode2VecWidth, trw::kNode2VecStreams>(a, slots, cur, st);
  return (int)cudaGetLastError();
}

// Phase 0 of either engine: the histogram and the compaction of the first
// blk stage slots (every local walker's first record, as one departure
// stream) into the outbox, which the caller has reset, from carry pool 0
// into pool 1, whose counts the caller has zeroed, as both pools'.
extern "C" int trw_routed_start(const TrwRoutedLaunch* launch, int width,
                                void* stream) {
  const TrwRoutedLaunch& a = *launch;
  if (!launch_ok(a, 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t slots = a.blk;
  if (width == trw::kUniformWidth) {
    trw::routed_stage_hist_kernel<<<tile_grid(a, slots), trw::kTile, 0, st>>>(
        a, slots);
    compact<trw::kUniformWidth, 1>(a, slots, 0, st);
  } else if (width == trw::kNode2VecWidth) {
    trw::routed_stage_hist_kernel<<<tile_grid(a, slots), trw::kTile, 0, st>>>(
        a, slots);
    compact<trw::kNode2VecWidth, 1>(a, slots, 0, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
