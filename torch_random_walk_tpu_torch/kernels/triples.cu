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
// Bound: a chain of dependent random reads, as K1's: a step reads the head's
// 8-byte range, then 8 bytes of a 12-byte triple row that depends on it.
// Design: K1's, one thread per walker, the walk stored a 32-byte sector at a
// time from registers (csr.cuh::RowWriter), two words a step.
//
// K10 replaces the XLA programs ops/windows.py::to_windows_triples (CBOW ==
// false) and to_windows_triples_cbow (CBOW == true), both through
// _triples_targets_and_windows; neither is Pallas.  Window win = walk *
// per_walk + i, per_walk = (width - 1) / 2, has its target triple at walk
// positions 2i .. 2i + 2 and 2W context triples: slot j < W at relation
// position 1 + 2i - 2(j + 1), slot j >= W at 1 + 2i + 2(j - W + 1), each
// component outside the walk padded.  SG negatives: slot u = win * 2W + j
// draws triples[mulhi(threefry(key, u, 0).x0, T)]; CBOW: draws
// win * 4 + r, r = 0..3, and keeps the first that differs from the target
// triple, else the last.
// Bound: bytes.  A window writes 3 + 6W words (SG; 3 + 3W + 3 for CBOW) and
// reads its walk's words (from L1 after the first window of the walk) and
// one random 12-byte triple row a draw; the Threefry calls (2W or 4 a
// window) come close behind.
// Design: one thread per (window, slot): consecutive threads write
// consecutive 12-byte pieces of the windows and SG negatives, so a warp's
// stores cover whole lines; the slot index is the SG draw's counter; the
// slot's window and walk come from one 32-bit division each where the slot
// count fits 32 bits (64-bit beyond); the target triple and the CBOW
// negative are written by the window's slot 0.

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
  const int32_t* __restrict__ triples;  // (num_triples, 3) [head, rel, tail]
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
      rel = triple_at(g.triples, g.num_triples, i, 1);
      tail = triple_at(g.triples, g.num_triples, i, 2);
    }
    w.put(2 * s - 1, rel);
    w.put(2 * s, tail);
    cur = tail;
    if (FAT && r.has) r = range_of(g.idx, tail);
  }
}

// K10's launch, as bindings.to_windows_triples fills it.
struct TripleWindowsPlan {
  const int32_t* walks;    // (num_walks, width)
  const int32_t* triples;  // (num_triples, 3)
  int32_t* targets;        // (num_win, 3)
  int32_t* windows;        // (num_win, 2W, 3)
  int32_t* negatives;      // (num_win, 2W, 3) SG, (num_win, 3) CBOW
  uint64_t slots;          // num_win * 2W
  int64_t num_triples;
  int32_t width, per_walk, window, pad;
  uint32_t k0, k1;
};

template <bool CBOW>
__global__ void __launch_bounds__(kWindowsThreads) to_windows_triples_kernel(
    const __grid_constant__ TripleWindowsPlan p) {
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
  if (!CBOW) {
    const uint32_t bits = threefry2x32(p.k0, p.k1, (uint32_t)u, 0u).x0;
    const int64_t ti = (int64_t)randint(bits, (uint32_t)p.num_triples);
    int32_t* nout = p.negatives + 3 * u;
#pragma unroll
    for (int c = 0; c < 3; ++c) nout[c] = triple_at(p.triples, p.num_triples, ti, c);
  }
  if (j != 0) return;
  int32_t target[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    target[c] = row[rel_pos - 1 + c];
    p.targets[3 * win + c] = target[c];
  }
  if (CBOW) {
    for (int r = 0; r < kCbowRounds; ++r) {
      const uint32_t bits = threefry2x32(
          p.k0, p.k1, (uint32_t)(win * kCbowRounds + r), 0u).x0;
      const int64_t ti = (int64_t)randint(bits, (uint32_t)p.num_triples);
      int32_t cand[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) cand[c] = triple_at(p.triples, p.num_triples, ti, c);
      if (r == kCbowRounds - 1 || cand[0] != target[0] ||
          cand[1] != target[1] || cand[2] != target[2]) {
#pragma unroll
        for (int c = 0; c < 3; ++c) p.negatives[3 * win + c] = cand[c];
        break;
      }
    }
  }
}

}  // namespace trw

extern "C" int trw_uniform_walk_triples(
    const int32_t* index, const int32_t* triples, int32_t num_entities,
    int64_t num_triples, const int32_t* targets, int32_t* walks,
    int32_t num_walkers, int32_t walk_length, uint32_t k0, uint32_t k1,
    uint32_t walker_offset, int32_t pad, int32_t fat, void* stream) {
  const int threads = trw::kTriplesThreads;
  const unsigned blocks = (unsigned)((num_walkers + threads - 1) / threads);
  trw::Triples g{{reinterpret_cast<const int2*>(index), num_entities}, triples,
                 num_triples};
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

extern "C" int trw_to_windows_triples(
    const int32_t* walks, int64_t num_walks, int32_t width, int32_t window,
    int32_t pad, const int32_t* triples, int64_t num_triples, uint32_t k0,
    uint32_t k1, int32_t cbow, int32_t* targets, int32_t* windows,
    int32_t* negatives, void* stream) {
  trw::TripleWindowsPlan p;
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
  cudaStream_t st = (cudaStream_t)stream;
  if (cbow) {
    trw::to_windows_triples_kernel<true>
        <<<(unsigned)blocks, trw::kWindowsThreads, 0, st>>>(p);
  } else {
    trw::to_windows_triples_kernel<false>
        <<<(unsigned)blocks, trw::kWindowsThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}
