// K9 and K10: KG-triples walks and their skip-gram / CBOW windows.
//
// K9 replaces the XLA programs ops/fatwalk.py::uniform_walk_triples_fat
// (FAT == true) and its oracle ops/triples_walk.py::uniform_walk_triples
// (FAT == false); neither is Pallas.  One thread per walker; for step s,
// bits = threefry(key, wid, s << 16).x0 and the head's range [start, end]:
//   i = start + mulhi(bits, end - start + 1)
//   out[2s - 1], out[2s] = triples[i].relation, triples[i].tail
// or (padding, padding) where the head has no triples.  The oracle looks
// every head up clamped into [0, N) and absorbs at a head equal to padding;
// the fat engine tests only the target (padding or outside [0, N) gives
// padding from step 1 on) and then follows the tails' ranges.
// Bound: a chain of dependent random reads, as K1's.  The fat semantics
// read one 16-byte row a step of TriplesGraph.triple_tab (a graph's; made
// per call for raw arrays), (relation, tail, start_tail, cnt_tail), which
// holds the step's output pair and the next head's range, so the chain is
// one load a step.  The oracle semantics (FAT == false: raw arrays, and a
// graph without the fat table) look each head up by id, so they read its
// 8-byte range, then 8 bytes of the 12-byte triple (one row in eight
// straddles a 32-byte sector).
// Design: K1's, one thread per walker, the walk stored a 32-byte sector at a
// time from registers (csr.cuh::RowWriter), two words a step.
// On the H100 at the bench shape (PERF.md §6) triple_tab took the graph
// entry from 0.57 to 0.41 ms.  Measured and not kept: an 8-byte [relation,
// tail] pair column with the index (0.54 ms: the index read stays in the
// chain), and on raw arrays a pair column copied per call.
//
// K10 replaces the XLA programs ops/windows.py::to_windows_triples
// (skip-gram) and to_windows_triples_cbow (CBOW), both through
// _triples_targets_and_windows; neither is Pallas.  Window win = walk *
// per_walk + i, per_walk = (width - 1) / 2, has its target triple at walk
// positions 2i .. 2i + 2 and 2W context triples: slot j < W at relation
// position 1 + 2i - 2(j + 1), slot j >= W at 1 + 2i + 2(j - W + 1), each
// component outside the walk padded.  SG negatives: slot u = win * 2W + j
// (mod 2^32) draws triples[mulhi(threefry(key, u, 0).x0, T)]; CBOW: draws
// win * 4 + r, r = 0..3, and keeps the first that differs from the target
// triple, else the last.
// Bound: bytes.  A window writes 3 + 6W words (SG; 3 + 3W + 3 for CBOW) and
// reads its walk's words (from L1 after the first window of the walk) and
// one random 12-byte triple row a draw.
// Skip-gram: one thread per (window, slot), the kernel of the first port,
// kept: its 104 857 600 random rows of a 432 MB table set its time.  A
// kernel that only draws and gathers them takes 97 % of this one's time on
// the H100, so the slot's division, its 12-byte stores and the window copy
// hide under the gathers, and no layout of the stores measured faster
// (PERF.md §6, "K10 variant").
// CBOW (K3's shape): one thread a window, which draws the window's first
// negative row before it reads its walk words, so that no lane waits on
// another.
// - The window's walk is u * magic >> shift inside a group of walks
//   (blockIdx.y) whose window indices fit 31 bits (no division); the draw
//   counters are the group's base mod 2^32 plus 4u, so more than 2^32
//   draws keep the JAX bitstream.
// - A warp's 32 window rows (6W words each, back to back in the output) are
//   staged in shared memory, each lane's row put as 8-byte pairs at run-time
//   offsets, and written 16 bytes a lane, so every store fills whole
//   sectors, for every W: a span longer than the stage's 1024 words (W > 5)
//   goes out in pieces.  Rows stored by their own threads (8 stores 120
//   bytes apart across the warp at W = 5) took 3.6 times as long.
// - A draw that collides with the target (rare) draws again.
// Measured and not kept (PERF.md §6, "K10 variant"): one thread a window for
// skip-gram (its ten rows in flight a thread, staged or direct stores, 64 to
// 256 threads, windows first, the draws in two batches: 0.5-6 % slower than
// the kernel kept, or worse), streaming stores, a copy of the triples
// padded to 16-byte rows (5.8 % faster if kept with the table, slower when
// made per call), an L2 fetch granularity of 32 bytes (no change); for
// CBOW, a kernel for W = 5 alone that held the window's 23 walk words in
// registers (1.5 % faster at W = 5, but it left every other W to rows
// stored by their own threads: 1.7 ms at W = 2 and 18.1 ms at W = 10, where
// this kernel takes 0.64 and 1.45).

#include <cstdint>
#include <cuda_runtime.h>

#include "csr.cuh"
#include "ranges.cuh"

namespace trw {

constexpr int kTriplesThreads = 128;
constexpr int kWindowsThreads = 256;
constexpr int kCbowRounds = 4;  // ops/windows.py::CBOW_TRIPLE_ROUNDS

struct Triples {
  RangeIndex idx;
  // (num_triples, 4) triple_tab rows (FAT) or (num_triples, 3) triples
  const int32_t* __restrict__ rows;
  int64_t num_triples;
};

// Component c of triple i, clamped into the table (0 for an empty table,
// whose lanes the callers mask, as ops/common.py::gather_rows does).
__device__ __forceinline__ int32_t triple_at(const int32_t* __restrict__ triples,
                                             int64_t rows, int64_t i, int c) {
  if (rows == 0) return 0;
  i = min(max(i, (int64_t)0), rows - 1);
  return triples[3 * i + c];
}

template <bool FAT>
__global__ void __launch_bounds__(kTriplesThreads) uniform_walk_triples_kernel(
    Triples g, const int32_t* __restrict__ targets, int32_t* __restrict__ walks,
    int32_t num_walkers, int32_t walk_length, uint32_t k0, uint32_t k1,
    uint32_t walker_offset, int32_t pad) {
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= num_walkers) return;
  uint32_t wid = (uint32_t)tid + walker_offset;
  const int32_t last = 2 * walk_length;
  int32_t* out = walks + tid * ((int64_t)last + 1);
  RowWriter w{out, (int32_t)(((uintptr_t)out >> 2) & 7), last, {}};
  int32_t cur = targets[tid];
  w.put(0, cur);
  Range r = range_of(g.idx, cur);
  if (FAT) r.has = r.has && cur != pad && (uint32_t)cur < (uint32_t)g.idx.num_nodes;
  for (int32_t s = 1; s <= walk_length; ++s) {
    if (!FAT) {
      r = range_of(g.idx, cur);
      r.has = r.has && cur != pad;
    }
    int32_t rel = pad, tail = pad;
    if (r.has) {
      uint32_t bits = threefry2x32(k0, k1, wid, step_round_counter(s, 0)).x0;
      int64_t i = draw_in(r, bits, max(g.num_triples, (int64_t)1));
      if (g.num_triples == 0) {
        rel = tail = 0;  // as ops/common.py::gather_rows gives
        if (FAT) r = range_of(g.idx, 0);
      } else if (FAT) {  // the fat engine: the tail's range from its row
        int4 row = reinterpret_cast<const int4*>(g.rows)[i];
        rel = row.x;
        tail = row.y;
        r.start = row.z;
        r.end = (int64_t)row.z + row.w;
        r.has = row.w > 0;
      } else {
        rel = g.rows[3 * i + 1];
        tail = g.rows[3 * i + 2];
      }
    }
    w.put(2 * s - 1, rel);
    w.put(2 * s, tail);
    cur = tail;
  }
}

// K10 skip-gram's launch, as trw_to_windows_triples_sg fills it.
struct TripleSlotsPlan {
  const int32_t* walks;    // (num_walks, width)
  const int32_t* triples;  // (num_triples, 3)
  int32_t* targets;        // (num_win, 3)
  int32_t* windows;        // (num_win, 2W, 3)
  int32_t* negatives;      // (num_win, 2W, 3)
  uint64_t slots;          // num_win * 2W
  int64_t num_triples;
  int32_t width, per_walk, window, pad;
  uint32_t k0, k1;
};

// Skip-gram: one thread per (window, slot).  Consecutive threads write
// consecutive 12-byte pieces of the windows and negatives; the slot index is
// the draw's counter; the slot's window and walk come from one 32-bit
// division each where the slot count fits 32 bits (64-bit beyond); the
// window's slot 0 writes the target.
__global__ void __launch_bounds__(kWindowsThreads) to_windows_triples_sg_kernel(
    const __grid_constant__ TripleSlotsPlan p) {
  const uint64_t u = (uint64_t)blockIdx.x * kWindowsThreads + threadIdx.x;
  if (u >= p.slots) return;
  const uint32_t two_w = 2u * (uint32_t)p.window;
  uint64_t win, walk;
  uint32_t j, i;
  if (p.slots <= 0xFFFFFFFFull) {
    const uint32_t u32 = (uint32_t)u;
    const uint32_t win32 = u32 / two_w;
    j = u32 - win32 * two_w;
    const uint32_t walk32 = win32 / (uint32_t)p.per_walk;
    i = win32 - walk32 * (uint32_t)p.per_walk;
    win = win32;
    walk = walk32;
  } else {
    win = u / two_w;
    j = (uint32_t)(u - win * two_w);
    walk = win / (uint64_t)p.per_walk;
    i = (uint32_t)(win - walk * (uint64_t)p.per_walk);
  }
  const int32_t* row = p.walks + walk * (uint64_t)p.width;
  const int32_t rel_pos = 1 + 2 * (int32_t)i;
  const int32_t left = (int32_t)j < p.window;
  const int32_t hop = 2 * (left ? (int32_t)j + 1 : (int32_t)j - p.window + 1);
  const int32_t at = left ? rel_pos - hop : rel_pos + hop;
  int32_t* wout = p.windows + 3 * u;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int32_t k = at - 1 + c;
    wout[c] = (k >= 0 && k < p.width) ? row[k] : p.pad;
  }
  const uint32_t bits = threefry2x32(p.k0, p.k1, (uint32_t)u, 0u).x0;
  const int64_t ti = (int64_t)randint(bits, (uint32_t)p.num_triples);
  int32_t* nout = p.negatives + 3 * u;
#pragma unroll
  for (int c = 0; c < 3; ++c) nout[c] = triple_at(p.triples, p.num_triples, ti, c);
  if (j != 0) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) p.targets[3 * win + c] = row[rel_pos - 1 + c];
}

// K10 CBOW's launch, as bindings.triple_windows_plan computes it.
struct TripleWindowsPlan {
  const int32_t* walks;    // (num_walks, width)
  const int32_t* triples;  // (num_triples, 3)
  int32_t* targets;        // (num_win, 3)
  int32_t* windows;        // (num_win, 2W, 3)
  int32_t* negatives;      // (num_win, 3)
  int64_t num_walks;
  uint32_t width, per_walk, window;
  uint32_t magic, shift;  // u / per_walk == (u * magic) >> shift, u < 2^31
  uint32_t group_walks, group_windows, group_draws;  // draws mod 2^32
  uint32_t num_triples;
  int32_t pad;
  uint32_t k0, k1;
};

constexpr int kStageWords = 1024;  // a warp's staging area, in words

// `words` words (even) of a warp's stage out to dst, 16 bytes a lane (8
// where dst is off a 16-byte boundary, which only a launch of several
// groups with an odd group base gives).
__device__ __forceinline__ void warp_store(const int32_t* stage, int32_t* dst,
                                           uint32_t words) {
  const uint32_t lane = threadIdx.x & 31;
  if (((uintptr_t)dst & 15) == 0) {
    for (uint32_t q = lane; q < words / 4; q += 32) {
      reinterpret_cast<int4*>(dst)[q] = reinterpret_cast<const int4*>(stage)[q];
    }
    if ((words & 3) && lane == 0) {
      reinterpret_cast<int2*>(dst)[words / 2 - 1] =
          reinterpret_cast<const int2*>(stage)[words / 2 - 1];
    }
  } else {
    for (uint32_t q = lane; q < words / 2; q += 32) {
      reinterpret_cast<int2*>(dst)[q] = reinterpret_cast<const int2*>(stage)[q];
    }
  }
}

__device__ __forceinline__ int3 triple_row(const int32_t* __restrict__ triples,
                                           uint32_t bits, uint32_t rows) {
  const int32_t* t = triples + 3 * (int64_t)randint(bits, rows);
  return make_int3(__ldg(t), __ldg(t + 1), __ldg(t + 2));
}

// Walk word k of `row`, padded outside the walk.
__device__ __forceinline__ int32_t walk_word(const int32_t* __restrict__ row,
                                             int32_t k, int32_t width,
                                             int32_t pad) {
  return (k >= 0 && k < width) ? __ldg(row + k) : pad;
}

// Walk position of the relation of context slot j of the window whose
// target's relation is at `rel`.
__device__ __forceinline__ int32_t slot_relation(int32_t rel, int32_t j,
                                                 int32_t w) {
  return j < w ? rel - 2 * (j + 1) : rel + 2 * (j - w + 1);
}

// CBOW: one thread a window.  The warp's live windows (a prefix of its
// lanes) have rows of 6W words that lie back to back in the output; each
// lane puts its row into the warp's stage as 8-byte pairs, two slots (six
// words) an iteration, and the warp writes the span 16 bytes a lane, in
// pieces of kStageWords words where the span is longer (W > 5).
__global__ void __launch_bounds__(kWindowsThreads) to_windows_triples_cbow_kernel(
    const __grid_constant__ TripleWindowsPlan p) {
  const int64_t walk0 = (int64_t)blockIdx.y * p.group_walks;
  const int64_t left = p.num_walks - walk0;
  const uint32_t here =
      (left < p.group_walks ? (uint32_t)left : p.group_walks) * p.per_walk;
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t u = blockIdx.x * kWindowsThreads + threadIdx.x;
  const uint32_t u0 = u - lane;
  if (u0 >= here) return;  // the whole warp is past the last window
  const bool live = u < here;
  const int32_t width = (int32_t)p.width, window = (int32_t)p.window;
  const int64_t win = (int64_t)blockIdx.y * p.group_windows + u;
  const uint32_t d0 = blockIdx.y * p.group_draws + u * (uint32_t)kCbowRounds;
  int32_t rel = 0;
  const int32_t* __restrict__ row = p.walks;
  int3 n = make_int3(0, 0, 0);
  if (live) {
    const uint32_t wl = (uint32_t)(((uint64_t)u * p.magic) >> p.shift);
    rel = 1 + 2 * (int32_t)(u - wl * p.per_walk);
    row = p.walks + (walk0 + wl) * (int64_t)p.width;
    // The first draw's row, in flight beside the window's walk words.
    n = triple_row(p.triples, threefry2x32(p.k0, p.k1, d0, 0u).x0,
                   p.num_triples);
  }
  __shared__ int4 stage_all[kWindowsThreads / 32][kStageWords / 4];
  int32_t* stage = reinterpret_cast<int32_t*>(stage_all[threadIdx.x / 32]);
  const uint32_t row_words = 6u * p.window;
  const uint32_t lanes = min(here - u0, 32u);
  const uint32_t span = lanes * row_words, mine = lane * row_words;
  int32_t* dst = p.windows + ((int64_t)blockIdx.y * p.group_windows + u0) *
                                 (int64_t)row_words;
  for (uint32_t c0 = 0; c0 < span; c0 += kStageWords) {
    if (live && mine < c0 + kStageWords && mine + row_words > c0) {
      for (int32_t t = 0; t < window; ++t) {
        const uint32_t at = mine + 6u * t;  // the slots' span offset
        if (at + 6u <= c0 || at >= c0 + kStageWords) continue;
        const uint32_t o = at - c0;  // pairs o, o + 2, o + 4 of the stage
        const int32_t a = slot_relation(rel, 2 * t, window) - 1;
        const int32_t b = slot_relation(rel, 2 * t + 1, window) - 1;
        const int32_t v[6] = {walk_word(row, a, width, p.pad),
                              walk_word(row, a + 1, width, p.pad),
                              walk_word(row, a + 2, width, p.pad),
                              walk_word(row, b, width, p.pad),
                              walk_word(row, b + 1, width, p.pad),
                              walk_word(row, b + 2, width, p.pad)};
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          if (o + 2u * q < (uint32_t)kStageWords) {  // wraps below c0
            reinterpret_cast<int2*>(stage)[(o + 2u * q) / 2] =
                make_int2(v[2 * q], v[2 * q + 1]);
          }
        }
      }
    }
    __syncwarp();
    warp_store(stage, dst + c0, min(span - c0, (uint32_t)kStageWords));
    __syncwarp();
  }
  if (!live) return;
  const int3 target = make_int3(__ldg(row + rel - 1), __ldg(row + rel),
                                __ldg(row + rel + 1));
  int32_t* tout = p.targets + 3 * win;
  tout[0] = target.x;
  tout[1] = target.y;
  tout[2] = target.z;
  for (int r = 1; r < kCbowRounds && n.x == target.x && n.y == target.y &&
                  n.z == target.z;
       ++r) {
    n = triple_row(p.triples, threefry2x32(p.k0, p.k1, d0 + r, 0u).x0,
                   p.num_triples);
  }
  int32_t* nout = p.negatives + 3 * win;
  nout[0] = n.x;
  nout[1] = n.y;
  nout[2] = n.z;
}

}  // namespace trw

// K9: `fat` picks the semantics and the table, TriplesGraph.triple_tab's
// (T, 4) rows for the fat engine, the raw (T, 3) triples for the oracle.
extern "C" int trw_uniform_walk_triples(
    const int32_t* index, const int32_t* table, int32_t num_entities,
    int64_t num_triples, const int32_t* targets, int32_t* walks,
    int32_t num_walkers, int32_t walk_length, uint32_t k0, uint32_t k1,
    uint32_t walker_offset, int32_t pad, int32_t fat, void* stream) {
  const int threads = trw::kTriplesThreads;
  const unsigned blocks = (unsigned)((num_walkers + threads - 1) / threads);
  const trw::Triples g{{reinterpret_cast<const int2*>(index), num_entities},
                       table, num_triples};
  cudaStream_t st = (cudaStream_t)stream;
  if (fat) {
    trw::uniform_walk_triples_kernel<true><<<blocks, threads, 0, st>>>(
        g, targets, walks, num_walkers, walk_length, k0, k1, walker_offset,
        pad);
  } else {
    trw::uniform_walk_triples_kernel<false><<<blocks, threads, 0, st>>>(
        g, targets, walks, num_walkers, walk_length, k0, k1, walker_offset,
        pad);
  }
  return (int)cudaGetLastError();
}

extern "C" int trw_to_windows_triples_sg(
    const int32_t* walks, int64_t num_walks, int32_t width, int32_t window,
    int32_t pad, const int32_t* triples, int64_t num_triples, uint32_t k0,
    uint32_t k1, int32_t* targets, int32_t* windows, int32_t* negatives,
    void* stream) {
  trw::TripleSlotsPlan p;
  p.walks = walks;
  p.triples = triples;
  p.targets = targets;
  p.windows = windows;
  p.negatives = negatives;
  p.per_walk = (width - 1) / 2;
  p.slots = (uint64_t)num_walks * (uint64_t)p.per_walk * 2ull *
            (uint64_t)window;
  p.num_triples = num_triples;
  p.width = width;
  p.window = window;
  p.pad = pad;
  p.k0 = k0;
  p.k1 = k1;
  const uint64_t blocks =
      (p.slots + trw::kWindowsThreads - 1) / trw::kWindowsThreads;
  if (blocks > 0x7FFFFFFFull) return (int)cudaErrorInvalidValue;
  trw::to_windows_triples_sg_kernel<<<(unsigned)blocks, trw::kWindowsThreads,
                                      0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int trw_to_windows_triples_cbow(
    const int32_t* walks, int64_t num_walks, int32_t width, int32_t window,
    int32_t pad, const int32_t* triples, uint32_t num_triples, uint32_t k0,
    uint32_t k1, uint32_t magic, uint32_t shift, uint32_t group_walks,
    uint32_t group_windows, uint32_t group_draws, int32_t groups,
    int32_t* targets, int32_t* windows, int32_t* negatives, void* stream) {
  trw::TripleWindowsPlan p;
  p.walks = walks;
  p.triples = triples;
  p.targets = targets;
  p.windows = windows;
  p.negatives = negatives;
  p.num_walks = num_walks;
  p.width = (uint32_t)width;
  p.per_walk = (uint32_t)((width - 1) / 2);
  p.window = (uint32_t)window;
  p.magic = magic;
  p.shift = shift;
  p.group_walks = group_walks;
  p.group_windows = group_windows;
  p.group_draws = group_draws;
  p.num_triples = num_triples;
  p.pad = pad;
  p.k0 = k0;
  p.k1 = k1;
  const int threads = trw::kWindowsThreads;
  const dim3 grid((group_windows + threads - 1) / threads, (unsigned)groups);
  cudaStream_t st = (cudaStream_t)stream;
  trw::to_windows_triples_cbow_kernel<<<grid, threads, 0, st>>>(p);
  return (int)cudaGetLastError();
}
