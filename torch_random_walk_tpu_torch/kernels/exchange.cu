// K4: all-to-all of per-destination record chunks between D shards.
//
// Replaces the one Pallas kernel of the JAX package,
// torch_random_walk_tpu/parallel/pallas_exchange.py::_exchange_kernel (called
// through pallas_all_to_all): shard `my` copies outbox[my] -> inbox[my]
// locally and pushes outbox[dst] into shard dst's inbox[my] by remote DMA,
// all copies started before any wait.  Same result as
// lax.all_to_all(split_axis=0, concat_axis=0, tiled=False).
//
// Here every (src, dst) chunk is copied by its own set of blocks in one
// launch: block (tile, dst, src) reads outbox[src][dst] and writes
// inbox[dst][src].  Like the TPU kernel it is a push into the destination
// shard's inbox, and it takes one base pointer per shard, not one stacked
// tensor: every shard owns its buffers, and a pointer that is peer-mapped
// from another card can be passed later without a new kernel.  So far it has
// run only with every shard's buffers on one card.
//
// Bound on this card: bytes (2 * D * D * words * 4 moved, no arithmetic).
// 16-byte loads and stores where the chunk size and the base pointers allow
// (the wrapper decides and passes `vec`), 4-byte otherwise.  At the routed
// engine's chunk sizes the copy is a few MB, so the launch itself is most of
// the time.

#include <cstdint>
#include <cuda_runtime.h>

namespace trw {

template <typename T>
__global__ void all_to_all_chunks_kernel(const void* const* __restrict__ outboxes,
                                         void* const* __restrict__ inboxes,
                                         int32_t num_shards, int64_t elems) {
  const int src = blockIdx.z;
  const int dst = blockIdx.y;
  const T* from = (const T*)outboxes[src] + (int64_t)dst * elems;
  T* to = (T*)inboxes[dst] + (int64_t)src * elems;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < elems;
       i += stride) {
    to[i] = from[i];
  }
}

}  // namespace trw

// outboxes / inboxes: device arrays of num_shards base pointers; each buffer
// holds num_shards chunks of `words` 32-bit words.
extern "C" int trw_all_to_all_chunks(const void* const* outboxes,
                                     void* const* inboxes, int32_t num_shards,
                                     int64_t words, int32_t vec, void* stream) {
  const int threads = 256;
  const int64_t elems = vec ? words / 4 : words;
  int64_t tiles = (elems + threads - 1) / threads;
  if (tiles > 64) tiles = 64;  // grid-stride loop covers the rest
  if (tiles < 1) tiles = 1;
  dim3 grid((unsigned)tiles, (unsigned)num_shards, (unsigned)num_shards);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    trw::all_to_all_chunks_kernel<uint4><<<grid, threads, 0, st>>>(
        outboxes, inboxes, num_shards, elems);
  } else {
    trw::all_to_all_chunks_kernel<uint32_t><<<grid, threads, 0, st>>>(
        outboxes, inboxes, num_shards, elems);
  }
  return (int)cudaGetLastError();
}
