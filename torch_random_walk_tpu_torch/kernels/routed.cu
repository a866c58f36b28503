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
// the first records the host stages; it serves the family engines' phase 0
// too (kernels/routed_families.cu: record widths 4 and 15).
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

namespace trw {

constexpr int kUniformStreams = 2;
constexpr int kNode2VecStreams = 4;
constexpr int kUniformWidth = 3;
constexpr int kNode2VecWidth = 14;

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

using trw::compact;
using trw::launch_ok;
using trw::tile_grid;

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

// Phase 0 of any routed engine (K11-K15, by record width: 3, 14, 4 or 15):
// the histogram and the compaction of the first blk stage slots (every local
// walker's first record, as one departure stream) into the outbox, which the
// caller has reset, from carry pool 0 into pool 1, whose counts the caller
// has zeroed, as both pools'.
extern "C" int trw_routed_start(const TrwRoutedLaunch* launch, int width,
                                void* stream) {
  const TrwRoutedLaunch& a = *launch;
  if (!launch_ok(a, 0) || (width != 3 && width != 14 && width != 4 &&
                           width != 15)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t slots = a.blk;
  trw::routed_stage_hist_kernel<<<tile_grid(a, slots), trw::kTile, 0, st>>>(
      a, slots);
  switch (width) {
    case 3: compact<3, 1>(a, slots, 0, st); break;
    case 14: compact<14, 1>(a, slots, 0, st); break;
    case 4: compact<4, 1>(a, slots, 0, st); break;
    default: compact<15, 1>(a, slots, 0, st); break;
  }
  return (int)cudaGetLastError();
}
