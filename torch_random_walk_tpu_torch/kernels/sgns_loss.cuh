// What the two builds of K5/K6 share: the loss's shape, the row lookup, the
// stable log-sigmoid and sigmoid, and the entry points of the bfloat16
// tensor-core kernels (sgns_loss_tc.cu) that sgns_loss.cu dispatches to.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace trw {

struct LossShape {
  int32_t num_walks;   // B
  int32_t length1;     // L1 = L + 1
  int32_t num_nodes;   // N
  int32_t dim;         // D
  int32_t hw;          // window_size / 2
  int32_t centers;     // C = L1 - 2 * hw
  float neg_weight;    // num_neg / S
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// log(sigmoid(x)), stable: min(x, 0) - log1p(exp(-|x|)).
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// sigmoid(x) from exp(-|x|), never overflowing.
__device__ __forceinline__ float sigmoid(float x) {
  float e = expf(-fabsf(x));
  float r = 1.0f / (1.0f + e);
  return x >= 0.0f ? r : e * r;
}

// Node id -> row: a negative id wraps once, and the result is clamped so that
// no id, however wrong, reads outside the table.
__device__ __forceinline__ int64_t table_row(int32_t id, int32_t num_nodes) {
  int64_t r = id < 0 ? (int64_t)id + num_nodes : (int64_t)id;
  return r < 0 ? 0 : (r >= num_nodes ? (int64_t)num_nodes - 1 : r);
}

inline int max_shared_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

// loss = -(sum of partial[0, n)) / count, in one fixed order (sgns_loss.cu).
cudaError_t launch_reduce_partials(const float* partial, int32_t n,
                                   double count, float* loss,
                                   cudaStream_t stream);

namespace tc {

// The three kernels of the bfloat16 build, for describe().
enum Kind { kFwd = 0, kRows = 1, kNeg = 2 };
constexpr int kDescribeInts = 10;

// Largest chunk of shared negatives one launch takes (K5: backward false;
// K6: the smaller of its two kernels'), 0 if the shape does not fit.
int chunk_size(const LossShape& sh, int num_neg_ids, bool backward);
// Number of float partial sums K5 writes.
int64_t num_partials(const LossShape& sh, int num_neg_ids);
// Per kernel (kFwd, kRows, kNeg): tile rows, walks per tile, centers per walk
// in a tile, tiles, negatives per launch, launches, stages of the gather
// ring, shared bytes, blocks per SM, grid.  Returns a CUDA error code.
int describe(const LossShape& sh, int num_neg_ids, int32_t* out);
int launch_fwd(const LossShape& sh, const int32_t* walks, const void* in_emb,
               const void* out_emb, const int32_t* neg_ids, int num_neg_ids,
               float* partial, float* loss, cudaStream_t stream);
int launch_bwd(const LossShape& sh, const int32_t* walks, const void* in_emb,
               const void* out_emb, const int32_t* neg_ids, int num_neg_ids,
               const float* grad_loss, float* grad_in, float* grad_out,
               cudaStream_t stream);

}  // namespace tc
}  // namespace trw
