// K4's copy of one piece of a record chunk, shared by K4's own launch
// (kernels/exchange.cu) and by the persistent routed walk kernel
// (kernels/routed_families.cu), whose exchange step runs it over the live
// prefix of every chunk.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace trw {

// bindings.py mirrors these three (EXCHANGE_THREADS, EXCHANGE_LOADS,
// MAX_SHARDS).
constexpr int kExchangeThreads = 256;
constexpr int kLoads = 4;  // words in flight per thread
constexpr int kMaxShards = 256;  // 2 * 256 pointers: 4 KB of parameters
// Words of T one block copies in one call.
constexpr int kPieceElems = kExchangeThreads * kLoads;

// Copy words [piece * kPieceElems, (piece + 1) * kPieceElems) of a chunk of
// `elems` words from `from` to `to`: thread t issues its kLoads loads (words
// piece * kPieceElems + k * kExchangeThreads + t) before its first store, so
// the block has all its bytes in flight at once.  COHERENT loads go to L2
// only (ld.global.cg): a chunk that another block wrote earlier in the same
// launch may be stale in this SM's L1.
template <typename T, bool COHERENT>
__device__ __forceinline__ void copy_piece(const T* __restrict__ from,
                                           T* __restrict__ to, int64_t piece,
                                           int64_t elems) {
  const int64_t first = piece * kPieceElems + threadIdx.x;
  T v[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int64_t i = first + k * kExchangeThreads;
    if (i < elems) {
      if constexpr (COHERENT) {
        v[k] = __ldcg(from + i);
      } else {
        v[k] = from[i];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int64_t i = first + k * kExchangeThreads;
    if (i < elems) to[i] = v[k];
  }
}

}  // namespace trw
