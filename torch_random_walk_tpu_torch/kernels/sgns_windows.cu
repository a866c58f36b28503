// K16 and K17: the per-window SGNS loss, forward (K16) and backward (K17), in
// its skip-gram and its CBOW form.
//
// Replace the XLA programs of torch_random_walk_tpu/models/skipgram.py::
// SkipGramModel.loss_fn (and its jax.value_and_grad in train_step) and
// torch_random_walk_tpu/models/cbow.py::CBOWModel.loss_fn (and train_step);
// XLA fuses them on the TPU, and they have no Pallas counterpart.  For
// window b with in ids i[b, 0..CI), positive ids p[b, 0..CO) and negative ids
// n[b, 0..CO):
//   h      = (1 / CI) * sum over k of in_emb[i[b, k]]
//   loss_b = -(sum over c of logsig(h . out_emb[p[b, c]])
//              + sum over c of logsig(-(h . out_emb[n[b, c]])))
//   loss   = (sum over b of loss_b) / B
// Skip-gram: CI = 1 (the targets), CO = W - 1 (pos, neg of to_windows).
// CBOW (template flag kCbow): CI = W - 1 (the context), CO = 1 (the positive
// and the negative node of to_windows_cbow).  Products and sums are float32
// whatever the tables' type.  An id of -1 addresses the last row, as
// table[ids] does in JAX (table_row, shared with K5/K6).
//
// Bound on this card: bytes.  A window reads CI + 2 CO rows of D elements
// and does 2 (CI + 2 CO) D flops on them, far below the ~300 flops a byte at
// which the card's arithmetic would limit.  So one warp takes one window at a
// time, and each lane loads 4 consecutive elements of a row (an 8-byte load
// of a bfloat16 row, 16 bytes of a float32 row; D = 128 is one load a lane
// a row); dot products are reduced with warp shuffles, which leave the sum
// on every lane.  D that is no multiple of 4 takes one element a lane a
// step.  D <= 512.
//
// K16's mean is deterministic: each warp sums its windows in grid-stride
// order, each block its 8 warps in order into partial[block], and the
// single-block reduction of K5 (launch_reduce_partials) sums the partials in
// a fixed order; the grid depends only on B.  So equal inputs give equal
// loss bits.
//
// K17 computes the gradient of K16's loss times a device scalar as two dense
// (N, D) float32 tables, like K6.  Per window one pass over the out rows:
// each row's dloss/dlogit g, then dh += g * row in registers and g * h added
// to the row's gradient; last dh / CI added to each in row.  Rows are added
// with atomics (one float4 atomicAdd a lane a row for D a multiple of 4,
// sm_90's vector atomics on global memory), so the order of the sums changes
// from run to run: K17 is held to its plain version within K6's limit, 1e-4
// of the largest entry of each table.

#include "sgns_loss.cuh"

namespace trw {
namespace win {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 512;
constexpr int kMaxGrid = 4096;

template <typename T, int V>
struct RowIO;

template <>
struct RowIO<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};

template <>
struct RowIO<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[4]) {
    uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&x.x);
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&x.y);
    float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    v[0] = fa.x; v[1] = fa.y; v[2] = fb.x; v[3] = fb.y;
  }
};

template <>
struct RowIO<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
};

template <>
struct RowIO<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[1]) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <int V>
__device__ __forceinline__ void atomic_add_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// The pieces of a row one lane owns: elements (k * 32 + lane) * V + j,
// k < kSlots, j < V, those below D.
template <int V>
struct Lane {
  static constexpr int kSlots = kMaxDim / (32 * V);
  int lane, dim;
  __device__ __forceinline__ int at(int k) const { return (k * 32 + lane) * V; }
  __device__ __forceinline__ bool has(int k) const { return at(k) < dim; }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// h = mean of the window's in rows (one row for skip-gram).
template <typename T, int V, bool kCbow>
__device__ __forceinline__ void load_h(const Lane<V>& ln, const T* in_emb,
                                       const int32_t* ids, int in_cols,
                                       int num_nodes,
                                       float (&h)[Lane<V>::kSlots][V]) {
  const int cols = kCbow ? in_cols : 1;
#pragma unroll
  for (int k = 0; k < Lane<V>::kSlots; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) h[k][j] = 0.0f;
  for (int c = 0; c < cols; ++c) {
    const T* row = in_emb + table_row(ids[c], num_nodes) * ln.dim;
#pragma unroll
    for (int k = 0; k < Lane<V>::kSlots; ++k) {
      if (!ln.has(k)) continue;
      float v[V];
      RowIO<T, V>::load(row + ln.at(k), v);
#pragma unroll
      for (int j = 0; j < V; ++j) h[k][j] += v[j];
    }
  }
  if (kCbow) {
    const float n = (float)cols;
#pragma unroll
    for (int k = 0; k < Lane<V>::kSlots; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) h[k][j] = h[k][j] / n;
  }
}

// h . row, on every lane; the row's values stay in `v` for the backward.
template <typename T, int V>
__device__ __forceinline__ float dot_row(const Lane<V>& ln, const T* row,
                                         const float (&h)[Lane<V>::kSlots][V],
                                         float (&v)[Lane<V>::kSlots][V]) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < Lane<V>::kSlots; ++k) {
    if (!ln.has(k)) continue;
    RowIO<T, V>::load(row + ln.at(k), v[k]);
#pragma unroll
    for (int j = 0; j < V; ++j) s += h[k][j] * v[k][j];
  }
  return warp_sum(s);
}

struct Windows {
  const int32_t* in_ids;  // (B, CI)
  const int32_t* pos;     // (B, CO)
  const int32_t* neg;     // (B, CO)
  int64_t num_windows;    // B
  int32_t in_cols, out_cols, num_nodes, dim;
};

template <typename T, int V, bool kCbow>
__global__ void __launch_bounds__(kThreads)
windows_loss_fwd_kernel(Windows w, const T* __restrict__ in_emb,
                        const T* __restrict__ out_emb,
                        float* __restrict__ partial) {
  __shared__ float red[kWarps];
  const int warp = threadIdx.x >> 5;
  const Lane<V> ln{(int)(threadIdx.x & 31), w.dim};
  const int in_cols = kCbow ? w.in_cols : 1, out_cols = kCbow ? 1 : w.out_cols;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  float sum = 0.0f;
  for (int64_t b = (int64_t)blockIdx.x * kWarps + warp; b < w.num_windows;
       b += step) {
    float h[Lane<V>::kSlots][V], v[Lane<V>::kSlots][V];
    load_h<T, V, kCbow>(ln, in_emb, w.in_ids + b * in_cols, in_cols,
                        w.num_nodes, h);
    float acc = 0.0f;
    for (int c = 0; c < out_cols; ++c) {
      const T* row = out_emb + table_row(w.pos[b * out_cols + c], w.num_nodes)
                                   * w.dim;
      acc += log_sigmoid(dot_row<T, V>(ln, row, h, v));
    }
    for (int c = 0; c < out_cols; ++c) {
      const T* row = out_emb + table_row(w.neg[b * out_cols + c], w.num_nodes)
                                   * w.dim;
      acc += log_sigmoid(-dot_row<T, V>(ln, row, h, v));
    }
    sum += acc;
  }
  if (ln.lane == 0) red[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) s += red[i];
    partial[blockIdx.x] = s;
  }
}

template <typename T, int V, bool kCbow>
__global__ void __launch_bounds__(kThreads)
windows_loss_bwd_kernel(Windows w, const T* __restrict__ in_emb,
                        const T* __restrict__ out_emb,
                        const float* __restrict__ grad_loss,
                        float* __restrict__ grad_in,
                        float* __restrict__ grad_out) {
  const int warp = threadIdx.x >> 5;
  const Lane<V> ln{(int)(threadIdx.x & 31), w.dim};
  const int in_cols = kCbow ? w.in_cols : 1, out_cols = kCbow ? 1 : w.out_cols;
  const float scale = grad_loss[0] / (float)w.num_windows;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  for (int64_t b = (int64_t)blockIdx.x * kWarps + warp; b < w.num_windows;
       b += step) {
    float h[Lane<V>::kSlots][V], v[Lane<V>::kSlots][V];
    float dh[Lane<V>::kSlots][V];
    load_h<T, V, kCbow>(ln, in_emb, w.in_ids + b * in_cols, in_cols,
                        w.num_nodes, h);
#pragma unroll
    for (int k = 0; k < Lane<V>::kSlots; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) dh[k][j] = 0.0f;
    for (int c = 0; c < 2 * out_cols; ++c) {
      const bool positive = c < out_cols;
      const int32_t id = positive ? w.pos[b * out_cols + c]
                                  : w.neg[b * out_cols + c - out_cols];
      const int64_t r = table_row(id, w.num_nodes);
      const float x = dot_row<T, V>(ln, out_emb + r * w.dim, h, v);
      // d(-logsig(x))/dx = -sigmoid(-x); d(-logsig(-x))/dx = sigmoid(x).
      const float g = positive ? -scale * sigmoid(-x) : scale * sigmoid(x);
      float* dst = grad_out + r * w.dim;
#pragma unroll
      for (int k = 0; k < Lane<V>::kSlots; ++k) {
        if (!ln.has(k)) continue;
        float add[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          dh[k][j] += g * v[k][j];
          add[j] = g * h[k][j];
        }
        atomic_add_vec<V>(dst + ln.at(k), add);
      }
    }
    if (kCbow) {
      const float n = (float)in_cols;
#pragma unroll
      for (int k = 0; k < Lane<V>::kSlots; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) dh[k][j] = dh[k][j] / n;
    }
    for (int c = 0; c < in_cols; ++c) {
      float* dst =
          grad_in + table_row(w.in_ids[b * in_cols + c], w.num_nodes) * w.dim;
#pragma unroll
      for (int k = 0; k < Lane<V>::kSlots; ++k)
        if (ln.has(k)) atomic_add_vec<V>(dst + ln.at(k), dh[k]);
    }
  }
}

inline int grid_for(int64_t num_windows) {
  int64_t blocks = (num_windows + kWarps - 1) / kWarps;
  return (int)(blocks < kMaxGrid ? (blocks < 1 ? 1 : blocks) : kMaxGrid);
}

template <typename T, int V, bool kCbow>
int launch(const Windows& w, const void* in_emb, const void* out_emb,
           float* partial, float* loss, const float* grad_loss, float* grad_in,
           float* grad_out, cudaStream_t stream) {
  const int grid = grid_for(w.num_windows);
  if (loss != nullptr) {
    windows_loss_fwd_kernel<T, V, kCbow><<<grid, kThreads, 0, stream>>>(
        w, (const T*)in_emb, (const T*)out_emb, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)launch_reduce_partials(partial, grid, (double)w.num_windows,
                                       loss, stream);
  }
  windows_loss_bwd_kernel<T, V, kCbow><<<grid, kThreads, 0, stream>>>(
      w, (const T*)in_emb, (const T*)out_emb, grad_loss, grad_in, grad_out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Windows& w, int vec, int cbow, const void* in_emb,
             const void* out_emb, float* partial, float* loss,
             const float* grad_loss, float* grad_in, float* grad_out,
             cudaStream_t stream) {
  if (vec == 4)
    return cbow ? launch<T, 4, true>(w, in_emb, out_emb, partial, loss,
                                     grad_loss, grad_in, grad_out, stream)
                : launch<T, 4, false>(w, in_emb, out_emb, partial, loss,
                                      grad_loss, grad_in, grad_out, stream);
  return cbow ? launch<T, 1, true>(w, in_emb, out_emb, partial, loss,
                                   grad_loss, grad_in, grad_out, stream)
              : launch<T, 1, false>(w, in_emb, out_emb, partial, loss,
                                    grad_loss, grad_in, grad_out, stream);
}

int run(const Windows& w, int elem_bytes, int vec, int cbow,
        const void* in_emb, const void* out_emb, float* partial, float* loss,
        const float* grad_loss, float* grad_in, float* grad_out,
        cudaStream_t stream) {
  if (w.num_windows < 1 || w.dim < 1 || w.dim > kMaxDim || w.num_nodes < 1 ||
      (vec != 1 && vec != 4) || (vec == 4 && w.dim % 4 != 0) ||
      (cbow ? w.in_cols < 1 : w.out_cols < 1))
    return (int)cudaErrorInvalidValue;
  if (elem_bytes == 4)
    return dispatch<float>(w, vec, cbow, in_emb, out_emb, partial, loss,
                           grad_loss, grad_in, grad_out, stream);
  if (elem_bytes == 2)
    return dispatch<__nv_bfloat16>(w, vec, cbow, in_emb, out_emb, partial,
                                   loss, grad_loss, grad_in, grad_out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace win
}  // namespace trw

extern "C" int trw_sgns_windows_grid(int64_t num_windows) {
  return trw::win::grid_for(num_windows);
}

// K16.  loss[0] = the mean window loss; partial holds
// trw_sgns_windows_grid(num_windows) floats of scratch.
extern "C" int trw_sgns_windows_loss_fwd(
    const int32_t* in_ids, const int32_t* pos, const int32_t* neg,
    int64_t num_windows, int32_t in_cols, int32_t out_cols, const void* in_emb,
    const void* out_emb, int32_t num_nodes, int32_t dim, int32_t elem_bytes,
    int32_t vec, int32_t cbow, float* partial, float* loss, void* stream) {
  trw::win::Windows w{in_ids, pos, neg, num_windows, in_cols, out_cols,
                      num_nodes, dim};
  return trw::win::run(w, elem_bytes, vec, cbow, in_emb, out_emb, partial,
                       loss, nullptr, nullptr, nullptr,
                       (cudaStream_t)stream);
}

// K17.  grad_in and grad_out (N, D) float32, zero on entry, receive the
// gradient of K16's loss times grad_loss[0].
extern "C" int trw_sgns_windows_loss_bwd(
    const int32_t* in_ids, const int32_t* pos, const int32_t* neg,
    int64_t num_windows, int32_t in_cols, int32_t out_cols, const void* in_emb,
    const void* out_emb, int32_t num_nodes, int32_t dim, int32_t elem_bytes,
    int32_t vec, int32_t cbow, const float* grad_loss, float* grad_in,
    float* grad_out, void* stream) {
  trw::win::Windows w{in_ids, pos, neg, num_windows, in_cols, out_cols,
                      num_nodes, dim};
  return trw::win::run(w, elem_bytes, vec, cbow, in_emb, out_emb, nullptr,
                       nullptr, grad_loss, grad_in, grad_out,
                       (cudaStream_t)stream);
}
