// K3: skip-gram windows from walks, one thread per output slot.
//
// Replaces the XLA program torch_random_walk_tpu/ops/windows.py::to_windows
// (sliding-window gather + one Threefry draw per negative slot); it has no
// Pallas counterpart.  Output slot (win, j), win = walk * per_walk + offset,
// j in [0, W-1):
//   targets[win]   = walk[offset + W/2]
//   pos[win, j]    = walk[offset + (j < W/2 ? j : j + 1)]
//   neg[win, j]    = mulhi(threefry(key, slot, 0).x0, num_nodes),
//                    slot = win * (W-1) + j   (the flat index of _neg_bits)
//
// Bound on this card: bytes.  The walks are read once (neighbouring slots
// read neighbouring words, so the reads hit cache) and 2 * (W-1) + 1 words
// are written per window; consecutive threads write consecutive words of pos
// and neg, so the stores coalesce.  The Threefry draw is ~100 integer
// operations per slot, far below what the stores cost.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace trw {

__global__ void to_windows_kernel(const int32_t* __restrict__ walks,
                                  int64_t num_slots, int32_t length,
                                  int32_t window, uint32_t num_nodes,
                                  uint32_t k0, uint32_t k1,
                                  int32_t* __restrict__ targets,
                                  int32_t* __restrict__ pos,
                                  int32_t* __restrict__ neg) {
  int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= num_slots) return;
  const int32_t ctx = window - 1;
  const int32_t per_walk = length - window + 1;
  const int32_t mid = window / 2;
  int64_t win = slot / ctx;
  int32_t j = (int32_t)(slot - win * ctx);
  int64_t walk = win / per_walk;
  int32_t offset = (int32_t)(win - walk * per_walk);
  const int32_t* row = walks + walk * (int64_t)length + offset;
  pos[slot] = row[j < mid ? j : j + 1];
  if (j == 0) targets[win] = row[mid];
  uint32_t bits = threefry2x32(k0, k1, (uint32_t)slot, 0u).x0;
  neg[slot] = (int32_t)randint(bits, num_nodes);
}

}  // namespace trw

extern "C" int trw_to_windows(const int32_t* walks, int64_t num_slots,
                              int32_t length, int32_t window, uint32_t num_nodes,
                              uint32_t k0, uint32_t k1, int32_t* targets,
                              int32_t* pos, int32_t* neg, void* stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((num_slots + threads - 1) / threads);
  trw::to_windows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      walks, num_slots, length, window, num_nodes, k0, k1, targets, pos, neg);
  return (int)cudaGetLastError();
}
