// K4: all-to-all of per-destination record chunks between D shards.
//
// Replaces the one Pallas kernel of the JAX package,
// torch_random_walk_tpu/parallel/pallas_exchange.py::_exchange_kernel (called
// through pallas_all_to_all): shard `my` copies outbox[my] -> inbox[my]
// locally and pushes outbox[dst] into shard dst's inbox[my] by remote DMA,
// all copies started before any wait.  Same result as
// lax.all_to_all(split_axis=0, concat_axis=0, tiled=False).
//
// Here every (src, dst) chunk is copied by its own few blocks in one launch:
// block (piece, dst, src) reads its piece of outbox[src][dst] and writes it
// into inbox[dst][src].  Like the TPU kernel it is a push into the
// destination shard's inbox, and it takes one base pointer per shard, not one
// stacked tensor: every shard owns its buffers, and a pointer that is
// peer-mapped from another card can be passed later without a new kernel.
// So far it has run only with every shard's buffers on one card.
//
// Bound on this card: bytes (2 * D * D * words * 4 moved, no arithmetic).  At
// the routed engine's chunk sizes the copy is a few MB, so what a launch
// costs besides the bytes is most of its time.  The design cuts that:
// - the 2 * D base pointers come by value in the kernel's parameter space
//   (__grid_constant__, read through the constant cache), so no thread waits
//   on a load of its pointers before its data load can start;
// - each thread issues all its loads (kLoads words of 16 bytes, or of 4 bytes
//   where a chunk or a base pointer is not 16-byte aligned) before its first
//   store, so a block has all its bytes in flight at once;
// - the wrapper packs the launch's arguments once per set of buffers, and
//   the C side launches with them as they are.
// A block's copy is exchange.cuh's copy_piece, which the persistent routed
// kernel (kernels/routed_families.cu) runs as its exchange step.

#include <cstdint>
#include <cuda_runtime.h>

#include "exchange.cuh"

namespace trw {

// One base pointer per shard for its outbox and for its inbox.
template <int MAX_SHARDS>
struct ShardBases {
  const void* out[MAX_SHARDS];
  void* in[MAX_SHARDS];
};

template <int MAX_SHARDS, typename T>
__global__ void __launch_bounds__(kExchangeThreads) all_to_all_chunks_kernel(
    const __grid_constant__ ShardBases<MAX_SHARDS> bases, int64_t elems) {
  const int src = blockIdx.z;
  const int dst = blockIdx.y;
  const T* __restrict__ from =
      static_cast<const T*>(bases.out[src]) + (int64_t)dst * elems;
  T* __restrict__ to = static_cast<T*>(bases.in[dst]) + (int64_t)src * elems;
  copy_piece<T, false>(from, to, blockIdx.x, elems);
}

// Nothing: the floor of a launch of the same geometry, queued the same way.
__global__ void empty_kernel() {}

}  // namespace trw

// What one exchange launch needs, packed once by the wrapper for a fixed set
// of buffers: outbox base pointers in bases[0, D), inbox ones in
// bases[D, 2D); chunks of `words` 32-bit words; `vec` for 16-byte words.
struct TrwExchangeLaunch {
  int32_t num_shards;
  int32_t vec;
  int64_t words;
  const void* bases[2 * trw::kMaxShards];
};

namespace {

template <int MAX_SHARDS, typename T>
int launch_exchange(const TrwExchangeLaunch& a, cudaStream_t stream) {
  trw::ShardBases<MAX_SHARDS> bases{};
  for (int s = 0; s < a.num_shards; ++s) {
    bases.out[s] = a.bases[s];
    bases.in[s] = const_cast<void*>(a.bases[a.num_shards + s]);
  }
  const int64_t elems = a.vec ? a.words / 4 : a.words;
  const int64_t per_block = trw::kPieceElems;
  const dim3 grid((unsigned)((elems + per_block - 1) / per_block),
                  (unsigned)a.num_shards, (unsigned)a.num_shards);
  trw::all_to_all_chunks_kernel<MAX_SHARDS, T>
      <<<grid, trw::kExchangeThreads, 0, stream>>>(bases, elems);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_exchange_sized(const TrwExchangeLaunch& a, cudaStream_t stream) {
  if (a.num_shards <= 8) return launch_exchange<8, T>(a, stream);
  if (a.num_shards <= 32) return launch_exchange<32, T>(a, stream);
  return launch_exchange<trw::kMaxShards, T>(a, stream);
}

}  // namespace

// Returns cudaErrorInvalidValue for a launch that was not packed right (the
// wrapper checks all of it first).
extern "C" int trw_all_to_all_chunks(const TrwExchangeLaunch* launch,
                                     void* stream) {
  if (launch->num_shards < 1 || launch->num_shards > trw::kMaxShards ||
      launch->words < 1 || (launch->vec && launch->words % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  return launch->vec ? launch_exchange_sized<uint4>(*launch, st)
                     : launch_exchange_sized<uint32_t>(*launch, st);
}

// An empty kernel on a grid of grid_x * grid_y * grid_z blocks of `threads`.
extern "C" int trw_empty_kernel(int32_t grid_x, int32_t grid_y, int32_t grid_z,
                                int32_t threads, void* stream) {
  trw::empty_kernel<<<dim3((unsigned)grid_x, (unsigned)grid_y,
                           (unsigned)grid_z),
                      threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
