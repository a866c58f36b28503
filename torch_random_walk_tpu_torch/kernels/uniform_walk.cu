// K1: uniform CSR random walks, one thread per walker.
//
// Replaces the XLA hot loop torch_random_walk_tpu/ops/uniform.py::
// uniform_walk_csr (same bitstream as ops/fatwalk.py::uniform_walk_fat); it
// has no Pallas counterpart.  For walker w and step s = 1..L:
//   bits = threefry(key, wid, s << 16).x0
//   next = deg(cur) > 0 ? col[start(cur) + mulhi(bits, deg(cur))] : cur
//
// Bound on this card: the chains of dependent random reads, once the stores
// are whole sectors.  Every step reads cur's two row_ptr words, then one col
// word that depends on them, and the next step depends on that word.  At the
// bench shape (131 072 walkers, L = 80) all walkers are resident at once
// (an SM holds 16 blocks of 128), so the card's throughput of random reads, not
// each walker's latency, sets the time: it falls with the walkers.  Timed
// apart in copies of this kernel (PERF.md): the reads alone (walk
// computed, only column L stored) take three quarters of the new kernel's
// time; the old 4-byte stores alone took 0.6 of the reads' time, and
// contended with them; Threefry alone and whole-sector stores alone take a
// tenth of the kernel's time each.
//
// What the design does about it:
// - Each walk row is stored a whole 32-byte sector at a time from eight
//   registers (csr.cuh::RowWriter, shared with K2).  The old kernel stored
//   one 4-byte word a step: a warp's store touched 32 sectors (rows are
//   (L+1)*4 bytes apart) and wrote an eighth of each, and L2 had to fill
//   those partly written sectors from device memory.  That halved K1's time
//   on the H100.
// - Nothing else: the random reads are as the walk needs them.
// Measured and not kept (PERF.md): streaming stores (__stcs) and an
// L2::evict_first store policy (no change beyond the run-to-run spread:
// the 42 MB of walks do not push the graph out of L2 enough to matter),
// L2::evict_last loads of row_ptr (5 % faster, but the lines keep their
// priority after the launch and speed up or crowd the kernels that follow,
// which is global state this kernel must not leave), two walkers a thread
// interleaved (no change: the walkers are all resident already), the row
// bounds as one aligned 8-byte load from a per-graph (start, end) table
// (slower: the 16 MB table takes more of L2 than the 8 MB row_ptr), 64 or
// 256 threads a block (no change).

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
  RowWriter w{out, (int32_t)(((uintptr_t)out >> 2) & 7), walk_length, {}};
  int32_t cur = targets[tid];
  w.put(0, cur);
  for (int32_t s = 1; s <= walk_length; ++s) {
    if (g.num_edges > 0) {
      uint32_t bits = threefry2x32(k0, k1, wid, step_round_counter(s, 0)).x0;
      cur = sample_neighbor(g, cur, bits);
    }
    w.put(s, cur);
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
