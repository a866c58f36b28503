// What the two KGE loss kernels share (kge_pair.cu: K19, the pair loss of
// TransE, DistMult and RotatE; kge_windows.cu: K20, the skip-gram and CBOW
// losses over composed triples): rows taken by a group of lanes as K16 takes
// them (sgns_windows.cuh), a group sum that lets the groups of a warp run
// apart, the rounding of a bfloat16 table's arithmetic, the masked mean of
// both losses, -(sum over the weighted items) / max(their count, 1), whose
// count is taken on the device, and the block's sum of the relation rows'
// gradient in shared memory.

#pragma once

#include <type_traits>

#include "sgns_windows.cuh"

namespace trw {
namespace kge {

using win::kMaxDim;
using win::kThreads;
using win::Lanes;
using win::piece_at;
using win::RowIO;

constexpr int kCountThreads = 256;
// The shared-memory budget of the relation rows' gradient sums of a block
// (all relation tables of a call together), under the 48 KB a block takes
// without the opt-in attribute: four blocks an SM hold 188 KB of its 227
// KB.  The leading relation rows that fit it are summed there; rows past
// them (vocabularies larger than the budget) are added to the tables with
// float4 atomics, as the entity rows.  The touched-rows step's relation
// sub-table is padded to a static size, but its ids address its leading
// rows only.
constexpr int kRelSharedBytes = 47 * 1024;
constexpr int kCountMaxGrid = 1024;
constexpr int kFinishThreads = 256;

// x rounded to T (round to nearest even), as an elementwise operation on
// bfloat16 tables rounds its result in JAX and in PyTorch; float32 as is.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// The lanes of this thread's group of G (G = 16 or 32) within its warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32)
    return 0xffffffffu;
  else
    return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

// The sum of x over the G lanes of a group.  Only the group's lanes take
// part, so the groups of a warp may run different trips and branches.
template <int G>
__device__ __forceinline__ float group_reduce(float x) {
  const unsigned mask = group_mask<G>();
#pragma unroll
  for (int m = G / 2; m > 0; m >>= 1) x += __shfl_xor_sync(mask, x, m);
  return x;
}

// Lane `lane`'s K pieces of V elements of a row segment of `len` elements
// at p (zeros past len).  On the vector path len is a multiple of V and p
// 16-byte aligned.
template <typename T, int V, int K>
__device__ __forceinline__ void load_pieces(const T* p, int lane, int len,
                                            float (&out)[K][V]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int at = piece_at<V>(k, lane);
    if (at < len) {
      RowIO<T, V>::unpack(RowIO<T, V>::load(p + at), out[k]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) out[k][j] = 0.0f;
    }
  }
}

// Add lane `lane`'s pieces to the float32 row segment at p.
template <int V, int K>
__device__ __forceinline__ void add_pieces(float* p, int lane, int len,
                                           const float (&v)[K][V]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int at = piece_at<V>(k, lane);
    if (at < len) win::atomic_add_floats<V>(p + at, v[k]);
  }
}

template <int K, int V>
__device__ __forceinline__ void zero_pieces(float (&v)[K][V]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) v[k][j] = 0.0f;
}

// Floats of a relation row's sum in shared memory for rows of `len`
// elements at load width `vec`: on the vector path K pieces of 128 (G lanes
// of V), as with_width picks K; on the scalar path the row.
__host__ __device__ inline int rel_stride(int len, int vec) {
  const int k = (len + 127) / 128;
  return vec == 1 ? len : (k <= 1 ? 1 : (k <= 2 ? 2 : 4)) * 128;
}

inline int64_t rel_shared_bytes(int64_t num_rel, int len, int vec,
                                int tables) {
  return (int64_t)tables * num_rel * rel_stride(len, vec) * 4;
}

__device__ __forceinline__ float* rel_sum_buffer() {
  extern __shared__ float kge_rel_sum[];
  return kge_rel_sum;
}

// Where a relation table's gradient goes: rows below `shared_rows` to the
// block's sum in shared memory (`shared`, `stride` floats a row, the lanes'
// pieces laid out (k, j, lane) so that the G lanes of a group add to
// consecutive words at each step), flushed to `table` once at the block's
// end; the other rows to `table` itself with float4 atomics.
struct RelGrad {
  float* table;   // (N_r, len) float32
  float* shared;  // shared_rows * stride floats
  int len, stride, shared_rows;
};

template <int V>
__device__ __forceinline__ int rel_word(int k, int j, int lane) {
  return (k * V + j) * Lanes<V>::G + lane;
}

template <int V, int K>
__device__ __forceinline__ void add_rel(const RelGrad& r, int32_t row,
                                        int lane, const float (&v)[K][V]) {
  if (row < r.shared_rows) {
    float* p = r.shared + row * r.stride;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (piece_at<V>(k, lane) < r.len)
#pragma unroll
        for (int j = 0; j < V; ++j)
          atomicAdd(p + rel_word<V>(k, j, lane), v[k][j]);
  } else {
    add_pieces<V, K>(r.table + (int64_t)row * r.len, lane, r.len, v);
  }
}

__device__ __forceinline__ void zero_shared(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.0f;
}

// The block's relation sums to their tables, after the item loop (the
// caller syncs the block first): a thread a row piece, its V words in one
// float4 atomic row add (one float on the scalar path), pieces that are all
// zero left out.  The only global adds on a relation row below shared_rows.
template <int V, int K>
__device__ __forceinline__ void flush_rel(const RelGrad& r) {
  constexpr int G = Lanes<V>::G;
  const int per_row = V == 1 ? r.len : K * G;
  for (int p = threadIdx.x; p < r.shared_rows * per_row; p += blockDim.x) {
    const int row = p / per_row, q = p - row * per_row;
    const int k = V == 1 ? 0 : q / G, lane = V == 1 ? q : q % G;
    const int at = V == 1 ? q : piece_at<V>(k, lane);
    if (at >= r.len) continue;
    float v[V];
    bool any = false;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[j] = r.shared[row * r.stride +
                      (V == 1 ? q : rel_word<V>(k, j, lane))];
      any |= v[j] != 0.0f;  // NaN goes on
    }
    if (any) win::atomic_add_floats<V>(r.table + (int64_t)row * r.len + at, v);
  }
}

// The masked mean: `count` (zero on entry) gets the number of weighted
// items, each block writes its partial sum of the items' terms to
// partial[block], and the finish kernel writes loss = -(sum of partials) /
// max(count, 1).
struct Mean {
  int32_t* count;
  float* partial;
  float* loss;
};

// count += the number of items i < n whose weight is 1: w(i) is 0 or 1.
template <typename W>
__global__ void __launch_bounds__(kCountThreads)
count_kernel(W w, int64_t n, int32_t* __restrict__ count) {
  int c = 0;
  for (int64_t i = (int64_t)blockIdx.x * kCountThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kCountThreads)
    c += w(i);
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0 && c != 0) atomicAdd(count, c);
}

template <typename W>
cudaError_t launch_count(W w, int64_t n, int32_t* count,
                         cudaStream_t stream) {
  int64_t grid = (n + kCountThreads - 1) / kCountThreads;
  grid = grid < 1 ? 1 : (grid > kCountMaxGrid ? kCountMaxGrid : grid);
  count_kernel<W><<<(int)grid, kCountThreads, 0, stream>>>(w, n, count);
  return cudaGetLastError();
}

// One block: the partials summed in one fixed order (double), so that equal
// inputs give equal loss bits.  A template, so that both sources that
// include this header may instantiate it.
template <typename C>
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const float* __restrict__ partial, int32_t n,
              const C* __restrict__ count, float* __restrict__ loss) {
  __shared__ double buf[kFinishThreads];
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += kFinishThreads)
    s += (double)partial[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int m = kFinishThreads / 2; m > 0; m >>= 1) {
    if (threadIdx.x < m) buf[threadIdx.x] += buf[threadIdx.x + m];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const C c = *count;
    loss[0] = (float)(-buf[0] / (double)(c > 1 ? c : 1));
  }
}

inline cudaError_t launch_finish(const Mean& m, int32_t blocks,
                                 cudaStream_t stream) {
  finish_kernel<int32_t><<<1, kFinishThreads, 0, stream>>>(
      m.partial, blocks, m.count, m.loss);
  return cudaGetLastError();
}

// grad_loss / max(count, 1): the gradient of the mean with respect to one
// weighted item's term (grad_loss null: 1).
__device__ __forceinline__ float mean_scale(const float* grad_loss,
                                            const int32_t* count) {
  const int32_t c = __ldg(count);
  const float g = grad_loss ? __ldg(grad_loss) : 1.0f;
  return g / (float)(c > 1 ? c : 1);
}

// Write the block's partial sum of its groups' `sum`s, in group order.
template <int kGroups>
__device__ __forceinline__ void block_partial(float sum, int group, int lane,
                                              float* partial) {
  __shared__ float red[kGroups];
  if (lane == 0) red[group] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < kGroups; ++i) s += red[i];
    partial[blockIdx.x] = s;
  }
}

}  // namespace kge
}  // namespace trw
