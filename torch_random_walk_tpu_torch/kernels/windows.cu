// K3: skip-gram windows from walks, one thread a window.
//
// Replaces the XLA program torch_random_walk_tpu/ops/windows.py::to_windows
// (sliding-window gather + one Threefry draw per negative slot); it has no
// Pallas counterpart.  Window win = walk * per_walk + offset, per_walk =
// L - W + 1, and its slots j in [0, W-1):
//   targets[win]   = walk[offset + W/2]
//   pos[win, j]    = walk[offset + (j < W/2 ? j : j + 1)]
//   neg[win, j]    = mulhi(threefry(key, slot, 0).x0, num_nodes),
//                    slot = win * (W-1) + j mod 2^32  (the flat index of
//                    _neg_bits; the bitstream must not change)
//
// Bound on this card: bytes (the walks read once, 2 * (W-1) + 1 words
// written a window), with the integer operations close behind (one
// Threefry-2x32 a slot: 41 rotates and xors that only the INT32 pipe runs,
// beside its adds).  So the design keeps everything else off the INT32
// pipe's per-slot path and writes whole sectors:
// - one thread a window, its W-1 Threefry chains independent of each other;
// - 32-bit index arithmetic, once a thread: the window's walk is
//   u * magic >> shift (no division), and the walks are cut into groups
//   (blockIdx.y) small enough that every index inside a group fits 32 bits,
//   so more than 2^31 windows still work through 64-bit group bases;
// - each thread reads its W walk words straight from global memory: a
//   warp's load of one word position is one coalesced request, the repeats
//   by neighbouring windows hit L1, and the Threefry work, which does not
//   wait on them, hides their latency (a block that staged its span of words
//   in shared memory first was slower: PERF.md);
// - with W-1 = 4 (the bench's window of 5) the pos and neg rows go out as
//   one 16-byte store each (the wrapper allocates them, so rows of 16 bytes
//   are aligned); any other W stores 4 bytes at a time.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace trw {

constexpr int kWindowThreads = 256;  // bindings.WINDOW_THREADS

// The launch, as the wrapper's windows_plan() computes it.
struct WindowPlan {
  const int32_t* walks;
  int32_t* targets;
  int32_t* pos;
  int32_t* neg;
  int64_t num_walks;
  uint32_t length, window, per_walk;
  uint32_t magic, shift;  // u / per_walk == (u * magic) >> shift, u < 2^31
  uint32_t group_walks, group_windows, group_slots;  // slots mod 2^32
  uint32_t num_nodes, k0, k1;
};

__device__ __forceinline__ uint32_t walk_of(const WindowPlan& p, uint32_t u) {
  return (uint32_t)(((uint64_t)u * p.magic) >> p.shift);
}

template <int CTX>  // W - 1; 0: any W, read from the plan
__global__ void __launch_bounds__(kWindowThreads) to_windows_kernel(
    const __grid_constant__ WindowPlan p) {
  const uint32_t ctx = CTX ? CTX : p.window - 1;
  const int64_t walk0 = (int64_t)blockIdx.y * p.group_walks;
  const int64_t left = p.num_walks - walk0;
  const uint32_t windows_here =
      (left < p.group_walks ? (uint32_t)left : p.group_walks) * p.per_walk;
  const uint32_t u = blockIdx.x * kWindowThreads + threadIdx.x;
  if (u >= windows_here) return;
  // Window u of the group starts at word u + walk(u) * (W - 1) of the
  // group's walks.
  const int32_t* row = p.walks + walk0 * p.length + (u + walk_of(p, u) * ctx);
  const uint32_t mid = (ctx + 1) / 2;
  const int64_t win = (int64_t)blockIdx.y * p.group_windows + u;
  const uint32_t slot = blockIdx.y * p.group_slots + u * ctx;
  p.targets[win] = row[mid];
  if constexpr (CTX == 4) {
    uint32_t n[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      n[j] = randint(threefry2x32(p.k0, p.k1, slot + j, 0u).x0, p.num_nodes);
    }
    reinterpret_cast<int4*>(p.pos)[win] = make_int4(row[0], row[1], row[3],
                                                    row[4]);
    reinterpret_cast<int4*>(p.neg)[win] =
        make_int4((int)n[0], (int)n[1], (int)n[2], (int)n[3]);
  } else {
    int32_t* pos = p.pos + win * ctx;
    int32_t* neg = p.neg + win * ctx;
    for (uint32_t j = 0; j < ctx; ++j) {
      pos[j] = row[j < mid ? j : j + 1];
      neg[j] = (int32_t)randint(threefry2x32(p.k0, p.k1, slot + j, 0u).x0,
                                p.num_nodes);
    }
  }
}

}  // namespace trw

extern "C" int trw_to_windows(const int32_t* walks, int64_t num_walks,
                              int32_t length, int32_t window,
                              uint32_t num_nodes, uint32_t k0, uint32_t k1,
                              uint32_t magic, uint32_t shift,
                              uint32_t group_walks, uint32_t group_windows,
                              uint32_t group_slots, int32_t groups,
                              int32_t blocks, int32_t* targets, int32_t* pos,
                              int32_t* neg, void* stream) {
  trw::WindowPlan p;
  p.walks = walks;
  p.targets = targets;
  p.pos = pos;
  p.neg = neg;
  p.num_walks = num_walks;
  p.length = (uint32_t)length;
  p.window = (uint32_t)window;
  p.per_walk = (uint32_t)(length - window + 1);
  p.magic = magic;
  p.shift = shift;
  p.group_walks = group_walks;
  p.group_windows = group_windows;
  p.group_slots = group_slots;
  p.num_nodes = num_nodes;
  p.k0 = k0;
  p.k1 = k1;
  const dim3 grid((unsigned)blocks, (unsigned)groups);
  cudaStream_t st = (cudaStream_t)stream;
  if (window == 5) {
    trw::to_windows_kernel<4><<<grid, trw::kWindowThreads, 0, st>>>(p);
  } else {
    trw::to_windows_kernel<0><<<grid, trw::kWindowThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}
