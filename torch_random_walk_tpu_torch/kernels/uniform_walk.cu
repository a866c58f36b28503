// K1: uniform CSR random walks, one thread per walker.
//
// Replaces the XLA hot loop torch_random_walk_tpu/ops/uniform.py::
// uniform_walk_csr (same bitstream as ops/fatwalk.py::uniform_walk_fat); it
// has no Pallas counterpart.  For walker w and step s = 1..L:
//   bits = threefry(key, wid, s << 16).x0
//   next = deg(cur) > 0 ? col[start(cur) + mulhi(bits, deg(cur))] : cur
//
// Bound on this card: bytes, and latency before bytes.  Every step is a chain
// of dependent random reads (two row_ptr words, one col word), so a walker
// cannot run ahead of its own memory latency; the design answers that with
// parallelism alone: one independent thread per walker, 128-thread blocks, as
// many walkers in flight as the card holds.  Each thread writes its own row
// of the (B, L+1) output, which is not coalesced; kept simple on purpose.

#include <cstdint>
#include <cuda_runtime.h>

#include "csr.cuh"

namespace trw {

__global__ void uniform_walk_csr_kernel(Csr g, const int32_t* __restrict__ targets,
                                        int32_t* __restrict__ walks,
                                        int32_t num_walkers, int32_t walk_length,
                                        uint32_t k0, uint32_t k1,
                                        uint32_t walker_offset) {
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= num_walkers) return;
  uint32_t wid = (uint32_t)tid + walker_offset;
  int32_t* out = walks + tid * ((int64_t)walk_length + 1);
  int32_t cur = targets[tid];
  out[0] = cur;
  for (int32_t s = 1; s <= walk_length; ++s) {
    if (g.num_edges > 0) {
      uint32_t bits = threefry2x32(k0, k1, wid, step_round_counter(s, 0)).x0;
      cur = sample_neighbor(g, cur, bits);
    }
    out[s] = cur;
  }
}

}  // namespace trw

extern "C" int trw_uniform_walk_csr(const int32_t* row_ptr, const int32_t* col_idx,
                                    int32_t num_nodes, int64_t num_edges,
                                    const int32_t* targets, int32_t* walks,
                                    int32_t num_walkers, int32_t walk_length,
                                    uint32_t k0, uint32_t k1,
                                    uint32_t walker_offset, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((num_walkers + threads - 1) / threads);
  trw::Csr g{row_ptr, col_idx, num_nodes, num_edges};
  trw::uniform_walk_csr_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g, targets, walks, num_walkers, walk_length, k0, k1, walker_offset);
  return (int)cudaGetLastError();
}
