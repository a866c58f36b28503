// K13, K14 and K15: the phase bodies of the owner-routed KG-triples and
// edge-list walk engines, every shard in one call.
//
// Replaces the XLA phase bodies of the JAX package's routed family engines,
// torch_random_walk_tpu/parallel/partition_v2.py (no Pallas counterpart):
// K13 the triples one, `process` in _routed_triples_jit:1121 (:1163); K14
// the uniform edge-list one, `process` in _routed_edge_list_jit:1388
// (:1420); K15 the biased (node2vec p/q) edge-list one, `process` in
// _routed_edge_list_n2v_jit:1678 (:1774); each with _build_outbox:176.  The
// plain PyTorch versions are parallel/partition_v2.py::RoutedWalk's
// _triples_body, _edge_list_body and _edge_list_node2vec_body (body="plain").
//
// A call is two launches on PyTorch's stream, as K11's and K12's
// (kernels/routed.cu): the body kernel here, a thread per inbox slot of every
// shard, and the tiled compaction of routed.cuh at this engine's record width
// and streams; phase 0 is trw_routed_start's.  Beside K11's bookkeeping the
// bodies count the walkers that end at them (stats column 3): a LOG arrival
// past the last step, a walker absorbed by padding.  The walk rows were
// filled with the padding id before phase 0, so an absorbed walker's
// remaining positions need no record.
//
// - K13 (records of 4 words: wid, step | LOG, relation, entity): a STEP
//   arrival at owner(entity) reads its meta row and one (relation, tail) row
//   with one Threefry draw (STREAM_TRIPLES, counter (step + 1) << 16) and
//   sends the transition to the wid-owner, which writes the relation and the
//   tail at columns 2s - 1 and 2s of its walk row and forwards the walker to
//   owner(tail); a head without triples, or the padding, ends the walk.
// - K14 (records of 4 words: wid, step | LOG | FUSE, node, target): as K13 on
//   a tails column (STREAM_EDGE_UNIFORM); a dead end with `restart` (a
//   template flag) sends one FUSE record that logs the jump back to the
//   target at s + 1 (position s is padding) and forwards to owner(target).
// - K15 (records of 15 words, K12's with the target in word 10 and the
//   Bloom filter in words 11-14): K12's machine with the edge-list law
//   (STREAM_EDGE_BIASED): a walker at padding draws the jump node, a dead
//   end draws padding, a candidate equal to t or to padding is decided
//   locally at prob_0 and an accepted padding moves to the jump node; the
//   exact test is the cuckoo edge set only; without `restart` an accepted
//   padding ends the walk.
//
// Bound on this card: bytes, as K11's and K12's.  A phase reads each live
// record once, writes it once to the stage and once to the outbox or the
// pool, and gathers one graph row a draw (two meta words and one payload
// row); at the routed legs' sizes a phase's time is its launches, their
// tails and the histograms' reads.

#include <cstdint>
#include <cuda_runtime.h>

#include "routed.cuh"

namespace trw {

constexpr int kFamilyStreams = 2;     // K13, K14
constexpr int kFamilyN2VStreams = 4;  // K15
constexpr int kFamilyWidth = 4;       // K13, K14
constexpr int kEdgeN2VWidth = 15;     // K15
constexpr uint32_t kFuseBit = 0x40000000u;  // K14's fused dead-end restart

// (relation, tail) row idx of a shard's triples, clamped into [0, e_max).
__device__ __forceinline__ int2 triple_at(const RoutedShard& sh, int64_t idx,
                                          const TrwRoutedLaunch& a) {
  const int64_t k = min(max(idx, (int64_t)0), a.e_max - 1);
  return make_int2(sh.col[2 * k], sh.col[2 * k + 1]);
}

// K13's body: streams 0 = forwarded LOG records (to owner(tail)), 1 = drawn
// transitions (to the wid-owner).
__global__ void __launch_bounds__(kBodyThreads)
    routed_triples_body_kernel(const TrwRoutedLaunch a, int cur) {
  constexpr int R = kFamilyWidth;
  const int my = blockIdx.y;
  const RoutedShard sh = a.shards[my];
  const int64_t slots = (int64_t)a.num_shards * a.cap;
  const int64_t first = (int64_t)blockIdx.x * kBodyThreads;
  count_phase(a);
  clear_outbox<R>(sh, first, slots);
  clear_pool_count(a, sh, 1 - cur);
  const int64_t i = first + threadIdx.x;
  bool logged = false, done = false;
  int32_t code = -1;
  if (i < slots) {
    const int32_t* rec = sh.inbox + i * R;
    const uint32_t wid = (uint32_t)rec[0];
    if (wid != kEmptyWid) {
      const uint32_t w1 = (uint32_t)rec[1];
      const uint32_t step = w1 & ~kLogBit;
      const int32_t v = rec[3];
      int32_t out1 = 0, out2 = 0, out3 = v;
      if (w1 & kLogBit) {  // at the wid-owner: log (relation, tail)
        log_position(sh, my, wid, 2 * step - 1, rec[2], a);
        log_position(sh, my, wid, 2 * step, v, a);
        logged = true;
        if (step < (uint32_t)a.walk_length && v != a.padding) {
          out1 = (int32_t)step;
          code = owner_of(v, a);
        } else {
          done = true;
        }
      } else if (step < (uint32_t)a.walk_length) {  // at owner(v): draw
        const int64_t local = local_row(v, my, a);
        const int64_t start = sh.meta[2 * local];
        const uint32_t cnt = (uint32_t)sh.meta[2 * local + 1];
        if ((int32_t)cnt > 0 && v != a.padding) {
          const uint32_t bits =
              threefry2x32(a.key0, a.key1, wid,
                           step_round_counter(step + 1, 0)).x0;
          const int2 rt = triple_at(sh, start + randint(bits, cnt), a);
          out1 = (int32_t)((step + 1) | kLogBit);
          out2 = rt.x;
          out3 = rt.y;
          code = (1 << 16) | wid_owner(wid, a);
        } else {
          done = true;  // absorbed: its padding is in the walk rows already
        }
      }
      if (code >= 0) {
        int32_t* dst = sh.stage + i * R;
        dst[0] = (int32_t)wid;
        dst[1] = out1;
        dst[2] = out2;
        dst[3] = out3;
      }
    }
    sh.code[i] = code;
  }
  tile_histogram<kFamilyStreams>(a, sh, blockIdx.x, code);
  count_block(a, my, logged, code >= 0);
  count_terminated(a, my, done);
}

// K14's body: streams 0 = forwarded LOG records (to owner(node)), 1 = drawn
// records (to the wid-owner).
template <bool RESTART>
__global__ void __launch_bounds__(kBodyThreads)
    routed_edge_list_body_kernel(const TrwRoutedLaunch a, int cur) {
  constexpr int R = kFamilyWidth;
  const int my = blockIdx.y;
  const RoutedShard sh = a.shards[my];
  const int64_t slots = (int64_t)a.num_shards * a.cap;
  const int64_t first = (int64_t)blockIdx.x * kBodyThreads;
  count_phase(a);
  clear_outbox<R>(sh, first, slots);
  clear_pool_count(a, sh, 1 - cur);
  const int64_t i = first + threadIdx.x;
  bool logged = false, done = false;
  int32_t code = -1;
  if (i < slots) {
    const int32_t* rec = sh.inbox + i * R;
    const uint32_t wid = (uint32_t)rec[0];
    if (wid != kEmptyWid) {
      const uint32_t w1 = (uint32_t)rec[1];
      const uint32_t step = w1 & ~(kLogBit | kFuseBit);
      const int32_t v = rec[2], tgt = rec[3];
      int32_t out1 = 0, out2 = 0;
      if (w1 & kLogBit) {  // at the wid-owner
        // A fused record logs the jump back to the target at step + 1
        // (position step is padding) and forwards from there.
        const bool fused = w1 & kFuseBit;
        const uint32_t fstep = fused ? step + 1 : step;
        const int32_t fnode = fused ? tgt : v;
        log_position(sh, my, wid, fstep, fnode, a);
        logged = true;
        if (fstep < (uint32_t)a.walk_length) {
          out1 = (int32_t)fstep;
          out2 = fnode;
          code = owner_of(fnode, a);
        } else {
          done = true;
        }
      } else if (step < (uint32_t)a.walk_length) {  // at owner(v): draw
        const int64_t local = local_row(v, my, a);
        const int64_t start = sh.meta[2 * local];
        const uint32_t cnt = (uint32_t)sh.meta[2 * local + 1];
        const uint32_t bits =
            threefry2x32(a.key0, a.key1, wid,
                         step_round_counter(step + 1, 0)).x0;
        int32_t nxt = (int32_t)cnt > 0
                          ? col_at(sh, start + randint(bits, cnt), a)
                          : a.padding;
        if (v == a.padding) nxt = RESTART ? tgt : a.padding;  // the jump
        const uint32_t s1 = step + 1;
        if (nxt != a.padding) {
          out1 = (int32_t)(s1 | kLogBit);
          out2 = nxt;
          code = (1 << 16) | wid_owner(wid, a);
        } else if (RESTART && s1 < (uint32_t)a.walk_length) {
          out1 = (int32_t)(s1 | kLogBit | kFuseBit);
          out2 = nxt;
          code = (1 << 16) | wid_owner(wid, a);
        } else {
          done = true;  // absorbed, or a dead end at the last step
        }
      }
      if (code >= 0) {
        int32_t* dst = sh.stage + i * R;
        dst[0] = (int32_t)wid;
        dst[1] = out1;
        dst[2] = out2;
        dst[3] = tgt;
      }
    }
    sh.code[i] = code;
  }
  tile_histogram<kFamilyStreams>(a, sh, blockIdx.x, code);
  count_block(a, my, logged, code >= 0);
  count_terminated(a, my, done);
}

// K15's draw: the edge-list law on the shard's tails (sample_edge_neighbor):
// at padding the jump node, at a dead end padding, else a uniform out-edge.
__device__ __forceinline__ int32_t edge_draw(const RoutedShard& sh,
                                             uint32_t bits, int32_t v,
                                             int64_t start, uint32_t cnt,
                                             int32_t jump,
                                             const TrwRoutedLaunch& a) {
  if (v == a.padding) return jump;
  return (int32_t)cnt > 0 ? col_at(sh, start + randint(bits, cnt), a)
                          : a.padding;
}

// K15's body: streams 0 = forwarded LOG records (to owner(v)), 1 = resolved
// steps (LOG records to the wid-owner), 2 = frozen draws (RESOLVE records to
// owner(t)), 3 = replays (STEP records back to owner(v)).
template <bool RESTART>
__global__ void __launch_bounds__(kBodyThreads)
    routed_edge_list_node2vec_body_kernel(const TrwRoutedLaunch a, int cur) {
  constexpr int R = kEdgeN2VWidth;
  const int my = blockIdx.y;
  const RoutedShard sh = a.shards[my];
  const int64_t slots = (int64_t)a.num_shards * a.cap;
  const int64_t first = (int64_t)blockIdx.x * kBodyThreads;
  count_phase(a);
  clear_outbox<R>(sh, first, slots);
  clear_pool_count(a, sh, 1 - cur);
  const int64_t i = first + threadIdx.x;
  bool logged = false, done = false;
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
      const int32_t tgt = (int32_t)r[10];
      const int32_t jump = RESTART ? tgt : a.padding;
      const uint32_t s = step + 1;  // the step being taken
      const bool mode_log = flags & kFLog;
      const bool mode_resolve = !mode_log && (flags & kFMode);
      const bool live = step < (uint32_t)a.walk_length;
      uint32_t out[R];
#pragma unroll
      for (int k = 0; k < R; ++k) out[k] = 0;
      out[0] = wid;
      out[10] = (uint32_t)tgt;
      // The departure, by kind: the stream and its destination, and the
      // filter the record carries (words 11-14).
      const uint32_t* bloom_src = nullptr;
      int stream = -1, dest = 0;
      // A step that advances: the node it moves to, and the filter of N(v)
      // its LOG record carries (local on STEP lanes; a RESOLVE lane has
      // copied the one it shipped in).
      bool advance = false;
      int32_t next = v;
      const uint32_t* next_bloom = nullptr;
      if (mode_log) {
        log_position(sh, my, wid, step, v, a);
        logged = true;
        if (live) {  // forward, flags cleared
#pragma unroll
          for (int k = 0; k < R; ++k) out[k] = r[k];
          out[1] = step;
          stream = 0;
          dest = owner_of(v, a);
        } else {
          done = true;
        }
      } else if (!mode_resolve && live) {  // STEP at owner(v)
        const int64_t local = local_row(v, my, a);
        const int64_t start = sh.meta[2 * local];
        const uint32_t cnt = (uint32_t)sh.meta[2 * local + 1];
        const uint32_t* v_bloom =
            reinterpret_cast<const uint32_t*>(sh.bloom) + 4 * local;
        if (s == 1) {  // first hop: a uniform draw, no acceptance test
          const uint32_t bits = threefry2x32(
              a.key0, a.key1, wid, step_round_counter(1, 0)).x0;
          next = edge_draw(sh, bits, v, start, cnt, jump, a);
          advance = true;
          next_bloom = v_bloom;
        } else {  // the speculative rejection scan
          const uint32_t tb[4] = {r[11], r[12], r[13], r[14]};
          const uint32_t rnd0 = r[4];
          bool has_a = false, ovf = false;
          int nf = 0;
          int32_t acand = v, f1 = v, f2 = v;
          uint32_t f1r = 0, f2r = 0, stop3 = 0;
          for (int k = 0; k < a.spec_rounds; ++k) {
            const uint32_t rk = rnd0 + (uint32_t)k;
            const U32x2 b =
                threefry2x32(a.key0, a.key1, wid, step_round_counter(s, rk));
            const int32_t cand = edge_draw(sh, b.x0, v, start, cnt, jump, a);
            const float rr = uniform24(b.x1);
            bool acc, rej;
            if (cand == t || cand == a.padding) {  // decided here
              acc = rr < a.prob0;
              rej = !acc;
            } else if (bloom_maybe(tb, (uint32_t)cand)) {
              acc = rr < a.lo_acc;
              rej = rr >= a.hi_acc;
            } else {
              acc = rr < a.prob2;
              rej = !acc;
            }
            if (acc) {  // an accepted padding moves on to the jump node
              acand = (cand == a.padding && cand != t) ? jump : cand;
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
            advance = true;
            next_bloom = v_bloom;
          } else if (nf >= 1) {  // RESOLVE at owner(t), carrying N(v)
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
            out[1] = step;
            out[2] = (uint32_t)t;
            out[3] = (uint32_t)v;
            out[4] = replay;
#pragma unroll
            for (int k = 0; k < 4; ++k) out[11 + k] = tb[k];
            stream = 3;
            dest = owner_of(v, a);
          }
        }
      } else if (mode_resolve) {  // RESOLVE at owner(t): the cuckoo set
        const int32_t f1c = (int32_t)r[6], f2c = (int32_t)r[8];
        const uint32_t n_f = flags >> 3;
        const float r1 = accept_uniform(a, wid, s, r[7]);
        const float r2 = accept_uniform(a, wid, s, r[9]);
        const bool acc1 = contains<false>(sh, my, t, f1c, a) ? r1 < a.prob1
                                                              : r1 < a.prob2;
        const bool acc2 =
            n_f >= 2 && !acc1 &&
            (contains<false>(sh, my, t, f2c, a) ? r2 < a.prob1
                                                 : r2 < a.prob2);
        if (acc1 || acc2 || (flags & kFHasA)) {  // N(v) shipped in
          next = acc1 ? f1c : acc2 ? f2c : (int32_t)r[5];
          advance = true;
#pragma unroll
          for (int k = 0; k < 4; ++k) out[11 + k] = r[11 + k];
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
      if (advance) {
        if (!RESTART && next == a.padding) {
          done = true;  // absorbed: its padding is in the walk rows already
        } else {  // LOG record to the wid-owner
          out[1] = s | (kFLog << 24);
          out[2] = (uint32_t)v;
          out[3] = (uint32_t)next;
          bloom_src = next_bloom;
          stream = 1;
          dest = wid_owner(wid, a);
        }
      }
      if (stream >= 0) {
        if (bloom_src != nullptr) {
#pragma unroll
          for (int k = 0; k < 4; ++k) out[11 + k] = bloom_src[k];
        }
        int32_t* dst = sh.stage + i * R;
#pragma unroll
        for (int k = 0; k < R; ++k) dst[k] = (int32_t)out[k];
        code = (stream << 16) | dest;
      }
    }
    sh.code[i] = code;
  }
  tile_histogram<kFamilyN2VStreams>(a, sh, blockIdx.x, code);
  count_block(a, my, logged, code >= 0);
  count_terminated(a, my, done);
}

}  // namespace trw

using trw::compact;
using trw::launch_ok;
using trw::tile_grid;

namespace {

bool family_launch_ok(const TrwRoutedLaunch& a, int cur) {
  return launch_ok(a, cur) && a.stats_width == 4;
}

}  // namespace

// K13: one phase of the triples engine for every shard; carry pool `cur` is
// the live one, and the other is filled.
extern "C" int trw_routed_triples_phase(const TrwRoutedLaunch* launch,
                                        int cur, void* stream) {
  const TrwRoutedLaunch& a = *launch;
  if (!family_launch_ok(a, cur) || a.walk_cols < 2 * a.walk_length + 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t slots = (int64_t)a.num_shards * a.cap;
  trw::routed_triples_body_kernel<<<tile_grid(a, slots), trw::kTile, 0, st>>>(
      a, cur);
  compact<trw::kFamilyWidth, trw::kFamilyStreams>(a, slots, cur, st);
  return (int)cudaGetLastError();
}

// K14: one phase of the uniform edge-list engine for every shard, as K13's.
extern "C" int trw_routed_edge_list_phase(const TrwRoutedLaunch* launch,
                                          int cur, void* stream) {
  const TrwRoutedLaunch& a = *launch;
  if (!family_launch_ok(a, cur)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t slots = (int64_t)a.num_shards * a.cap;
  if (a.restart) {
    trw::routed_edge_list_body_kernel<true>
        <<<tile_grid(a, slots), trw::kTile, 0, st>>>(a, cur);
  } else {
    trw::routed_edge_list_body_kernel<false>
        <<<tile_grid(a, slots), trw::kTile, 0, st>>>(a, cur);
  }
  compact<trw::kFamilyWidth, trw::kFamilyStreams>(a, slots, cur, st);
  return (int)cudaGetLastError();
}

// K15: one phase of the biased edge-list engine for every shard, as K13's.
extern "C" int trw_routed_edge_list_node2vec_phase(
    const TrwRoutedLaunch* launch, int cur, void* stream) {
  const TrwRoutedLaunch& a = *launch;
  if (!family_launch_ok(a, cur) || a.walk_length >= (1 << 24) ||
      a.spec_rounds < 1 || a.use_search || a.hash_log < 1 ||
      a.hash_log > 31) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t slots = (int64_t)a.num_shards * a.cap;
  if (a.restart) {
    trw::routed_edge_list_node2vec_body_kernel<true>
        <<<tile_grid(a, slots), trw::kTile, 0, st>>>(a, cur);
  } else {
    trw::routed_edge_list_node2vec_body_kernel<false>
        <<<tile_grid(a, slots), trw::kTile, 0, st>>>(a, cur);
  }
  compact<trw::kEdgeN2VWidth, trw::kFamilyN2VStreams>(a, slots, cur, st);
  return (int)cudaGetLastError();
}
