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
// All three are one persistent cooperative launch that runs up to a whole
// walk's phases on the card (routed_batch below): the exchange (K4's copy,
// kernels/exchange.cuh), the body and the compaction of each phase are
// steps of one kernel, separated by grid barriers, and each step's work is
// the records in flight, not the slots.  The bodies differ only in what an
// arrival does (TriplesBody, EdgeListBody, EdgeNode2VecBody).  Phase 0 is
// trw_routed_start's for all three.  Beside K11's bookkeeping the bodies
// count the walkers that end at them (stats column 3): a LOG arrival past
// the last step, a walker absorbed by padding.  The walk rows were filled
// with the padding id before phase 0, so an absorbed walker's remaining
// positions need no record.
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
// row).  At the routed legs' sizes that is about a microsecond a phase, so
// a call a phase (K11's and K12's path) spends its time on launches, their
// tails and the histograms' reads over every slot; the persistent kernel
// keeps the phase loop on the card (the host reads the phase counter and
// the live counts once a walk) and sizes every step by the records: the
// compaction keeps each chunk's record count (TrwRoutedLaunch.flow), so the
// exchange copies, the body reads and the outbox reset rewrites only those
// records, and the compaction's tiles are the records' and the live pool's.
// What is left is the grid barriers (three a serial phase, two an
// overlapped interval) and the dependent reads of each step.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "exchange.cuh"
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

// K13's arrival: the departure of one record, into out (code -1: none).
// Streams 0 = forwarded LOG records (to owner(entity)), 1 = drawn
// transitions (to the wid-owner).
struct TriplesBody {
  static constexpr int R = kFamilyWidth;
  static constexpr int S = kFamilyStreams;

  __device__ __forceinline__ static int32_t arrival(const TrwRoutedLaunch& a,
                                    const RoutedShard& sh, int my,
                                    const uint32_t (&r)[R], uint32_t (&out)[R],
                                    bool& logged, bool& done) {
    const uint32_t wid = r[0];
    if (wid == kEmptyWid) return -1;
    const uint32_t w1 = r[1];
    const uint32_t step = w1 & ~kLogBit;
    const int32_t v = (int32_t)r[3];
    uint32_t out1 = 0, out2 = 0, out3 = (uint32_t)v;
    int32_t code = -1;
    if (w1 & kLogBit) {  // at the wid-owner: log (relation, tail)
      log_position(sh, my, wid, 2 * step - 1, (int32_t)r[2], a);
      log_position(sh, my, wid, 2 * step, v, a);
      logged = true;
      if (step < (uint32_t)a.walk_length && v != a.padding) {
        out1 = step;
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
        out1 = (step + 1) | kLogBit;
        out2 = (uint32_t)rt.x;
        out3 = (uint32_t)rt.y;
        code = (1 << 16) | wid_owner(wid, a);
      } else {
        done = true;  // absorbed: its padding is in the walk rows already
      }
    }
    out[0] = wid;
    out[1] = out1;
    out[2] = out2;
    out[3] = out3;
    return code;
  }
};

// K14's arrival: the departure of one record, into out (code -1: none).
// Streams 0 = forwarded LOG records (to owner(node)), 1 = drawn records (to
// the wid-owner).
template <bool RESTART>
struct EdgeListBody {
  static constexpr int R = kFamilyWidth;
  static constexpr int S = kFamilyStreams;

  __device__ __forceinline__ static int32_t arrival(const TrwRoutedLaunch& a,
                                    const RoutedShard& sh, int my,
                                    const uint32_t (&r)[R], uint32_t (&out)[R],
                                    bool& logged, bool& done) {
    const uint32_t wid = r[0];
    if (wid == kEmptyWid) return -1;
    const uint32_t w1 = r[1];
    const uint32_t step = w1 & ~(kLogBit | kFuseBit);
    const int32_t v = (int32_t)r[2], tgt = (int32_t)r[3];
    int32_t out1 = 0, out2 = 0, code = -1;
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
    out[0] = wid;
    out[1] = (uint32_t)out1;
    out[2] = (uint32_t)out2;
    out[3] = (uint32_t)tgt;
    return code;
  }
};

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

// K15's arrival.  Streams 0 = forwarded LOG records (to owner(v)), 1 =
// resolved steps (LOG records to the wid-owner), 2 = frozen draws (RESOLVE
// records to owner(t)), 3 = replays (STEP records back to owner(v)).
template <bool RESTART>
struct EdgeNode2VecBody {
  static constexpr int R = kEdgeN2VWidth;
  static constexpr int S = kFamilyN2VStreams;

  __device__ __forceinline__ static int32_t arrival(const TrwRoutedLaunch& a,
                                    const RoutedShard& sh, int my,
                                    const uint32_t (&r)[R], uint32_t (&out)[R],
                                    bool& logged, bool& done) {
    const uint32_t wid = r[0];
    if (wid == kEmptyWid) return -1;
    const uint32_t step = r[1] & 0xFFFFFFu;
    const uint32_t flags = r[1] >> 24;
    const int32_t t = (int32_t)r[2], v = (int32_t)r[3];
    const int32_t tgt = (int32_t)r[10];
    const int32_t jump = RESTART ? tgt : a.padding;
    const uint32_t s = step + 1;  // the step being taken
    const bool mode_log = flags & kFLog;
    const bool mode_resolve = !mode_log && (flags & kFMode);
    const bool live = step < (uint32_t)a.walk_length;
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
    if (stream < 0) return -1;
    if (bloom_src != nullptr) {
#pragma unroll
      for (int k = 0; k < 4; ++k) out[11 + k] = bloom_src[k];
    }
    return (stream << 16) | dest;
  }
};

}  // namespace trw

// --- K13-K15: the persistent batch kernel -----------------------------------

// One launch of the batch kernel (bindings.py _RoutedBatch): the walk's
// pipelines (one under `serial`, two under `overlapped`), the phases it may
// run, the pipeline the first overlapped interval exchanges, each
// pipeline's live carry pool, whether the exchange may copy 16-byte words
// (every chunk 16-byte aligned), and the blocks the card holds resident (the
// occupancy query's blocks per SM times the SMs, found when it was packed).
struct TrwRoutedBatch {
  TrwRoutedLaunch pipe[2];
  int64_t max_phases;
  int32_t num_pipes;
  int32_t first;
  int32_t cur[2];
  int32_t vec;
  int32_t resident;
};

namespace trw {

// Every block of the grid arrives before any leaves: cooperative_groups'
// grid barrier, which a cooperative launch with every block resident
// provides (nvcc builds it without -rdc).  It was faster on the H100 than an
// arrival count with a generation word polled by each block's first thread.
__device__ __forceinline__ void grid_barrier() {
  cooperative_groups::this_grid().sync();
}

// out[0] = 0 and out[s + 1] = the sum of v over threads 0..s, for s < n
// (n <= kTile; thread s holds its shard's v).  Every thread calls it.
__device__ __forceinline__ void block_prefix(int v, int n, int* out) {
  __shared__ int s_warp[kTileWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int x = tid < n ? v : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kTileWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < kTileWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kTileWarps) s_warp[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += s_warp[warp - 1];
  if (tid < n) out[tid + 1] = x;
  if (tid == 0) out[0] = 0;
  __syncthreads();
}

// The segment s in [0, n) with off[s] <= k < off[s + 1] (off[0] = 0 <= k <
// off[n]; empty segments are passed over).
__device__ __forceinline__ int find_segment(const int* off, int n,
                                            int64_t k) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= k) lo = mid; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int tiles_of(int64_t n) {
  return (int)((n + kTile - 1) / kTile);
}

// A record of R words in (from another block of this launch) and out.
template <int R>
__device__ __forceinline__ void load_record(const int32_t* p,
                                            uint32_t (&r)[R]) {
  if constexpr (R == 4) {
    const int4 v = __ldcg(reinterpret_cast<const int4*>(p));
    r[0] = (uint32_t)v.x;
    r[1] = (uint32_t)v.y;
    r[2] = (uint32_t)v.z;
    r[3] = (uint32_t)v.w;
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) r[k] = (uint32_t)__ldcg(p + k);
  }
}

template <int R>
__device__ __forceinline__ void store_record(int32_t* p,
                                             const uint32_t (&r)[R]) {
  if constexpr (R == 4) {
    *reinterpret_cast<int4*>(p) =
        make_int4((int)r[0], (int)r[1], (int)r[2], (int)r[3]);
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) p[k] = (int32_t)r[k];
  }
}

// The exchange step's item v of D * D * pieces: piece v / (D * D) of the
// live prefix of chunk (src, dst) = (v % (D * D)) / D, v % D, from src's
// outbox into dst's inbox (K4's copy, with L2 loads).  The items number
// fewer than 2^31 (D <= 256, a chunk under 2^31 words), so the divisions
// are 32-bit ones, which need no call.
template <int R>
__device__ __forceinline__ void exchange_item(const TrwRoutedLaunch& a,
                                              const int32_t* box, int v,
                                              bool vec) {
  const int nd = a.num_shards;
  const int pair = v % (nd * nd);
  const int piece = v / (nd * nd);
  const int src = pair / nd, dst = pair % nd;
  const int64_t words = (int64_t)__ldcg(box + pair) * R;
  const int64_t chunk = (int64_t)a.cap * R;
  const int32_t* from = a.shards[src].outbox + dst * chunk;
  int32_t* to = const_cast<int32_t*>(a.shards[dst].inbox) + src * chunk;
  if (vec) {
    const int64_t elems = (words + 3) / 4;
    if (piece * kPieceElems < elems) {
      copy_piece<uint4, true>(reinterpret_cast<const uint4*>(from),
                              reinterpret_cast<uint4*>(to), piece, elems);
    }
  } else if (piece * kPieceElems < words) {
    copy_piece<uint32_t, true>(reinterpret_cast<const uint32_t*>(from),
                               reinterpret_cast<uint32_t*>(to), piece, words);
  }
}

// The exchange step's items: D * D chunks times the pieces of the largest
// live prefix.
template <int R>
__device__ __forceinline__ int exchange_items(int nd, int maxbox, bool vec) {
  const int64_t words = (int64_t)maxbox * R;
  const int64_t elems = vec ? (words + 3) / 4 : words;
  return nd * nd * (int)((elems + kPieceElems - 1) / kPieceElems);
}

// The body of the persistent kernel: up to b.max_phases phases of the walk,
// each as a call a phase runs it (exchange, body, compaction), with grid
// barriers between the steps.  Serial: (a) exchange of the pipeline |
// (b) its body over the records that arrived, the reset of its outbox's
// slots that were live, and the zeroing of the counts its compaction fills
// | (c) its compaction |.  Overlapped: (a) exchange of pipeline X beside
// (b) of pipeline Y | (c) Y's compaction |, then the roles swap.  Before
// each phase every block reads the same live counts: the walk's phase
// counter adds one, as count_phase does, if any record is in flight, and
// all blocks stop together once none is.  Work is in proportion to the
// records: the box counts that the compaction keeps (TrwRoutedLaunch.flow)
// say how many records each chunk holds, so the exchange copies and the
// body reads only those, and the steps' tiles are the records' (virtual
// tiles over shards, by a prefix sum that every block computes alike, taken
// in a grid-stride loop).  A shard's stage holds its arrivals' departures
// at the arrival's rank among the records it took in, which keeps the slot
// order, so the compaction keeps the exchange order.
template <class Body>
__device__ __forceinline__ void routed_batch(const TrwRoutedBatch& b) {
  constexpr int R = Body::R, S = Body::S;
  __shared__ int s_work[kRoutedMaxShards + 1];  // step (b)'s tiles by shard
  __shared__ int s_comp[kRoutedMaxShards + 1];  // step (c)'s tiles by shard
  __shared__ int s_seg[kRoutedMaxShards + 1];   // an item's records by chunk
  __shared__ int s_in[kRoutedMaxShards];        // records each shard takes in
  __shared__ int s_out[kRoutedMaxShards];       // records in its outbox
  __shared__ int s_carried[kRoutedMaxShards];   // records in its live pool
  __shared__ int32_t* s_count[kRoutedMaxShards];  // its pool counts
  __shared__ int64_t s_slot[kTile];             // a reset tile's slots
  __shared__ int s_maxbox;
  const int nd = b.pipe[0].num_shards;
  const int tid = threadIdx.x;
  const int grid = gridDim.x;
  const int64_t fw = flow_words(nd);
  // Each pipeline's live pool, kept in two registers (an array indexed by
  // the pipeline would live on the stack).
  int cur0 = b.cur[0], cur1 = b.cur[1];
  int y = b.num_pipes == 2 ? 1 - b.first : 0;  // the processed pipeline
  for (int it = 0; it < b.max_phases; ++it) {
    const int x = b.num_pipes == 2 ? 1 - y : y;  // the exchanged pipeline
    const TrwRoutedLaunch& ay = y ? b.pipe[1] : b.pipe[0];
    const TrwRoutedLaunch& ax = x ? b.pipe[1] : b.pipe[0];
    const int cy = y ? cur1 : cur0;
    const int32_t* fy = ay.flow + cy * fw;
    const int32_t* fx = ax.flow + (x ? cur1 : cur0) * fw;

    // Every block reads the same counts: records in flight, and per shard
    // the records it takes in, boxed in its outbox and carried.
    bool any = false;
    for (int i = tid; i < ay.num_live; i += kTile) {
      any |= __ldcg(ay.live_all + i) > 0;
    }
    int in = 0, out = 0, carried = 0;
    if (tid < nd) {
      in = __ldcg(fy + (int64_t)nd * nd + tid);
      out = (int)__ldcg(ay.live + 2 * tid);
      carried = (int)__ldcg(ay.live + 2 * tid + 1);
      s_in[tid] = in;
      s_out[tid] = out;
      s_carried[tid] = carried;
      s_count[tid] = ay.shards[tid].pool_count;
    }
    if (tid == 0) s_maxbox = __ldcg(fx + (int64_t)nd * nd + nd);
    if (!__syncthreads_or(any)) break;
    if (blockIdx.x == 0 && tid == 0) shared_add(ay.phases, 1);
    block_prefix(tiles_of(in) + tiles_of(out), nd, s_work);
    block_prefix(max(tiles_of(in), 1) + tiles_of(carried), nd, s_comp);
    const int n_ex = exchange_items<R>(nd, s_maxbox, b.vec);

    if (b.num_pipes == 1) {  // (a) alone
      for (int v = blockIdx.x; v < n_ex; v += grid) {
        exchange_item<R>(ax, fx, v, b.vec);
      }
      grid_barrier();
    }
    // The counts that Y's compaction fills: its next pool's, and the flow
    // counts it adds to.
    {
      const int per = (int)(pool_tiles(ay) + 1) * nd;
      for (int s = 0; s < nd; ++s) {
        int32_t* count = s_count[s] + (1 - cy) * per;
        for (int w = blockIdx.x * kTile + tid; w < per; w += grid * kTile) {
          count[w] = 0;
        }
      }
      if (blockIdx.x == 0 && tid <= nd) {
        ay.flow[(1 - cy) * fw + (int64_t)nd * nd + tid] = 0;
      }
    }
    // (b), and under `overlapped` (a) beside it: the first n_ex items.
    const int first = b.num_pipes == 1 ? 0 : n_ex;
    int seg_key = -1;  // the shard and kind s_seg was summed for
    for (int v = blockIdx.x; v < first + s_work[nd]; v += grid) {
      if (v < first) {
        exchange_item<R>(ax, fx, v, b.vec);
        continue;
      }
      const int my = find_segment(s_work, nd, v - first);
      const int t = v - first - s_work[my];
      const int in_tiles = tiles_of(s_in[my]);
      const bool body = t < in_tiles;
      const int key = 2 * my + (body ? 0 : 1);
      if (key != seg_key) {  // records of each chunk: in, by source; out, by
                             // destination
        int c = 0;
        if (tid < nd) {
          const int i = body ? tid * nd + my : my * nd + tid;
          c = __ldcg(fy + i);
        }
        block_prefix(c, nd, s_seg);
        seg_key = key;
      }
      const RoutedShard sh = ay.shards[my];
      if (body) {
        const int64_t k = (int64_t)t * kTile + tid;
        bool logged = false, done = false;
        int32_t code = -1;
        if (k < s_in[my]) {
          const int src = find_segment(s_seg, nd, k);
          uint32_t r[R], o[R];
          load_record<R>(sh.inbox + ((int64_t)src * ay.cap + k - s_seg[src])
                                        * R, r);
          code = Body::arrival(ay, sh, my, r, o, logged, done);
          if (code >= 0) store_record<R>(sh.stage + k * R, o);
          sh.code[k] = code;
        }
        tile_histogram<S>(ay, sh, t, code);
        count_block(ay, my, logged, code >= 0);
        count_terminated(ay, my, done);
      } else {  // reset the outbox slots that were live to sentinel records
        const int64_t q0 = (int64_t)(t - in_tiles) * kTile;
        const int n = (int)min((int64_t)kTile, (int64_t)s_out[my] - q0);
        if (tid < n) {
          const int d = find_segment(s_seg, nd, q0 + tid);
          s_slot[tid] = ((int64_t)d * ay.cap + q0 + tid - s_seg[d]) * R;
        }
        __syncthreads();
        for (int w = tid; w < n * R; w += kTile) {
          const int q = w / R;
          const int k = w - q * R;
          sh.outbox[s_slot[q] + k] = k == 0 ? -1 : 0;
        }
        __syncthreads();
      }
    }
    grid_barrier();

    // (c) Y's compaction: each shard's stage tiles (at least its keeper)
    // and its live pool's tiles.
    for (int v = blockIdx.x; v < s_comp[nd]; v += grid) {
      const int my = find_segment(s_comp, nd, v);
      const int t = v - s_comp[my];
      const int stage_tiles = max(tiles_of(s_in[my]), 1);
      compact_tile<R, S, true>(ay, my, t >= stage_tiles,
                               t >= stage_tiles ? t - stage_tiles : t,
                               s_in[my], cy, s_carried[my]);
    }
    grid_barrier();
    if (y) {
      cur1 ^= 1;
    } else {
      cur0 ^= 1;
    }
    y = x;
  }
}

// At least two blocks an SM, so at most 128 registers a thread: ptxas then
// gives K14's kernel 95 registers and no spill, two blocks an SM (264 on an
// H100); left to itself it held K14's to 80 registers, three blocks an SM,
// and spilled.
constexpr int kBatchMinBlocks = 2;

// The batch kernels by engine (bindings.py BATCH_KERNELS): the C entries and
// the geometry query are keyed by kernel, never by record width (K13 and K14
// share width 4).
enum BatchKernel : int32_t { kBatchK13 = 0, kBatchK14 = 1, kBatchK15 = 2 };

__global__ void __launch_bounds__(kTile, kBatchMinBlocks)
    routed_triples_batch_kernel(const __grid_constant__ TrwRoutedBatch b) {
  routed_batch<TriplesBody>(b);
}

template <bool RESTART>
__global__ void __launch_bounds__(kTile, kBatchMinBlocks)
    routed_edge_list_batch_kernel(const __grid_constant__ TrwRoutedBatch b) {
  routed_batch<EdgeListBody<RESTART>>(b);
}

template <bool RESTART>
__global__ void __launch_bounds__(kTile, kBatchMinBlocks)
    routed_edge_list_node2vec_batch_kernel(
        const __grid_constant__ TrwRoutedBatch b) {
  routed_batch<EdgeNode2VecBody<RESTART>>(b);
}

// The batch kernel's launch: every block resident (blocks per SM from the
// occupancy query, times the SMs), so the grid barriers cannot wait on a
// block that never runs.
template <class Body>
int batch_geometry(const void* kernel, int nd, int32_t* out) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  const size_t smem = (size_t)routed_compact_smem(Body::S, nd);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTile,
                                                      smem);
  }
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = coop ? per_sm : 0;
  out[1] = sms;
  out[2] = attr.numRegs;
  out[3] = (int32_t)attr.localSizeBytes;
  out[4] = (int32_t)attr.sharedSizeBytes;
  out[5] = (int32_t)smem;
  // Which kernel answered: its entry's address, low and high words.
  const uint64_t fn = (uint64_t)(uintptr_t)kernel;
  out[6] = (int32_t)(uint32_t)fn;
  out[7] = (int32_t)(uint32_t)(fn >> 32);
  return 0;
}

// A grid of at most b.resident blocks (batch_geometry's, when the batch was
// packed).
template <class Body>
int batch_launch(const void* kernel, const TrwRoutedBatch& b, int32_t grid,
                 cudaStream_t st) {
  if (grid < 1 || grid > b.resident) {
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  void* args[] = {const_cast<TrwRoutedBatch*>(&b)};
  const size_t smem =
      (size_t)routed_compact_smem(Body::S, b.pipe[0].num_shards);
  return (int)cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid),
                                          dim3(kTile), args, smem, st);
}

}  // namespace trw

using trw::launch_ok;

namespace {

bool family_launch_ok(const TrwRoutedLaunch& a, int cur) {
  return launch_ok(a, cur) && a.stats_width == 4;
}

bool n2v_launch_ok(const TrwRoutedLaunch& a) {
  return a.walk_length < (1 << 24) && a.spec_rounds >= 1 && !a.use_search &&
         a.hash_log >= 1 && a.hash_log <= 31;
}

// The batch's pipelines are the walk's: one or two, on the same shards and
// counters, each with its flow counts; K13's walk rows hold 2L + 1
// positions.
bool batch_ok(const TrwRoutedBatch& b, int kernel) {
  if (b.num_pipes < 1 || b.num_pipes > 2 || (b.first != 0 && b.first != 1) ||
      b.max_phases < 1 || b.max_phases >= (int64_t)1 << 31 ||
      (b.vec != 0 && b.vec != 1) || b.resident < 1) {
    return false;
  }
  for (int p = 0; p < b.num_pipes; ++p) {
    const TrwRoutedLaunch& a = b.pipe[p];
    if (!family_launch_ok(a, b.cur[p]) || a.flow == nullptr ||
        a.num_shards != b.pipe[0].num_shards ||
        a.num_live != 2 * b.num_pipes * a.num_shards ||
        (kernel == trw::kBatchK13 &&
         a.walk_cols < 2 * (int64_t)a.walk_length + 2) ||
        (kernel == trw::kBatchK15 && !n2v_launch_ok(a))) {
      return false;
    }
  }
  return true;
}

}  // namespace

// K13: up to batch->max_phases phases of the triples engine, every shard, in
// one cooperative launch of `grid` blocks (at most the resident blocks of
// the card).
extern "C" int trw_routed_triples_batch(const TrwRoutedBatch* batch,
                                        int32_t grid, void* stream) {
  const TrwRoutedBatch& b = *batch;
  if (!batch_ok(b, trw::kBatchK13)) return (int)cudaErrorInvalidValue;
  using namespace trw;
  return batch_launch<TriplesBody>((const void*)routed_triples_batch_kernel,
                                   b, grid, (cudaStream_t)stream);
}

// K14: the same for the uniform edge-list engine.
extern "C" int trw_routed_edge_list_batch(const TrwRoutedBatch* batch,
                                          int32_t grid, void* stream) {
  const TrwRoutedBatch& b = *batch;
  if (!batch_ok(b, trw::kBatchK14)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  using namespace trw;
  return b.pipe[0].restart
             ? batch_launch<EdgeListBody<true>>(
                   (const void*)routed_edge_list_batch_kernel<true>, b, grid,
                   st)
             : batch_launch<EdgeListBody<false>>(
                   (const void*)routed_edge_list_batch_kernel<false>, b, grid,
                   st);
}

// K15: the same for the biased edge-list engine.
extern "C" int trw_routed_edge_list_node2vec_batch(
    const TrwRoutedBatch* batch, int32_t grid, void* stream) {
  const TrwRoutedBatch& b = *batch;
  if (!batch_ok(b, trw::kBatchK15)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  using namespace trw;
  return b.pipe[0].restart
             ? batch_launch<EdgeNode2VecBody<true>>(
                   (const void*)routed_edge_list_node2vec_batch_kernel<true>,
                   b, grid, st)
             : batch_launch<EdgeNode2VecBody<false>>(
                   (const void*)routed_edge_list_node2vec_batch_kernel<false>,
                   b, grid, st);
}

// The geometry of batch kernel `kernel` (a BatchKernel; K14's and K15's by
// restart flag, K13 has one) at D shards: out = blocks per SM (0 where the
// card cannot launch cooperatively), SMs, registers, local (spill) bytes,
// static and dynamic shared bytes a block, and the kernel's address (two
// words).
extern "C" int trw_routed_batch_geometry(int32_t kernel, int32_t restart,
                                         int32_t num_shards, int32_t* out) {
  using namespace trw;
  if (num_shards < 1 || num_shards > kRoutedMaxShards) {
    return (int)cudaErrorInvalidValue;
  }
  switch (kernel) {
    case kBatchK13:
      return batch_geometry<TriplesBody>(
          (const void*)routed_triples_batch_kernel, num_shards, out);
    case kBatchK14:
      return restart ? batch_geometry<EdgeListBody<true>>(
                           (const void*)routed_edge_list_batch_kernel<true>,
                           num_shards, out)
                     : batch_geometry<EdgeListBody<false>>(
                           (const void*)routed_edge_list_batch_kernel<false>,
                           num_shards, out);
    case kBatchK15:
      return restart
                 ? batch_geometry<EdgeNode2VecBody<true>>(
                       (const void*)routed_edge_list_node2vec_batch_kernel<
                           true>,
                       num_shards, out)
                 : batch_geometry<EdgeNode2VecBody<false>>(
                       (const void*)routed_edge_list_node2vec_batch_kernel<
                           false>,
                       num_shards, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
