// K18: Adam in one pass, over whole tables (dense entry) or over the rows a
// step touched (rows entry).
//
// Replaces the XLA programs of torch_random_walk_tpu/models/skipgram.py::
// SkipGramModel.walk_train_step:238-245 and train_step:173 (optax.adam, then
// optax.apply_updates; the same in models/cbow.py::CBOWModel.train_step) and
// the touched-rows update of walk_train_step_sparse:257; XLA fuses each on
// the TPU, and none has a Pallas counterpart.
//
// Bound on this card: bytes.  An element costs about a dozen flops and 16 to
// 20 bytes (g float32, param, mu and nu read, param, mu and nu written), so
// both entries read each operand once and write each result once, with
// 16-byte accesses: 8 elements a thread for bfloat16 tables, 4 for float32.
//
// Dense entry: the port's plain dense Adam (models/skipgram.py::
// adam_update_plain), moments in the tables' type.  It rounds as the plain
// version does on the card, one PyTorch operation at a time: the gradient
// rounded once to the tables' type; mu = fma(1 - b1, g, mu * b1) and nu =
// fma(1 - b2, g * g, nu * b2) in float32 (add_ with alpha and addcmul_
// contract to one fma in PyTorch's CUDA kernels), each rounded once when
// stored; the step from the stored moments, where a division by a host
// scalar (the bias corrections, cast to the moments' type as optax casts
// them) is a product with its float32 reciprocal, as PyTorch's CUDA division
// by a scalar computes it; the parameter rounded once after the step is
// added.
//
// Rows entry: JAX's lazy formula over M deduplicated slots, moments float32
// whatever the tables' type: mu' = b1 mu + (1 - b1) g, nu' = b2 nu + (1 - b2)
// g^2, row = (param - lr (mu' / bc1) / (sqrt(nu' / bc2) + eps)) in the
// tables' type, bc = 1 - b^count in float32, every operation rounded on its
// own (no fma), as the plain version's separate tensor operations.  Slot m
// writes row ids[m] (-1 wraps to N - 1; ids outside [-1, N), the pads, write
// nothing) only where flag[m] != 0 (no flag array: every slot); g is the
// slot's float32 gradient row, rounded first to the tables' type as JAX's
// gradient of a bfloat16 sub-table is.  The caller keeps at most one slot a
// row.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace trw {
namespace adam {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 132 * 16;

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, bc1, bc2;  // omb = 1 - b, in float32
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V consecutive elements through 16-byte accesses (V * sizeof(T) is a
// multiple of 16) or, for V == 1, one scalar access.
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f(p[0]);
  } else {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int q = 0; q < V / kPer; ++q) {
      uint4 raw = *reinterpret_cast<const uint4*>(p + q * kPer);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[q * kPer + j] = to_f(e[j]);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f<T>(v[0]);
  } else {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int q = 0; q < V / kPer; ++q) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) e[j] = from_f<T>(v[q * kPer + j]);
      *reinterpret_cast<uint4*>(p + q * kPer) = raw;
    }
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// One element of the dense entry; inv_bc = 1 / bc in float32.
template <typename T>
__device__ __forceinline__ void dense_one(const Hyper& h, float inv_bc1,
                                          float inv_bc2, float g, float& p,
                                          float& m, float& v) {
  const float gf = round_to<T>(g);
  m = round_to<T>(__fmaf_rn(h.omb1, gf, __fmul_rn(m, h.b1)));
  v = round_to<T>(__fmaf_rn(h.omb2, __fmul_rn(gf, gf), __fmul_rn(v, h.b2)));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, inv_bc2)), h.eps);
  const float step = __fdiv_rn(__fmul_rn(m, inv_bc1), denom);
  p = round_to<T>(__fadd_rn(__fmul_rn(step, -h.lr), p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adam_dense_kernel(Hyper h, int64_t n, const float* __restrict__ grad,
                  T* __restrict__ param, T* __restrict__ mu,
                  T* __restrict__ nu) {
  constexpr int V = 16 / sizeof(T);
  const float inv_bc1 = 1.0f / h.bc1, inv_bc2 = 1.0f / h.bc2;
  const int64_t vecs = n / V;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < vecs; i += stride) {
    const int64_t e = i * V;
    float g[V], p[V], m[V], v[V];
    load<float, V>(grad + e, g);
    load<T, V>(param + e, p);
    load<T, V>(mu + e, m);
    load<T, V>(nu + e, v);
#pragma unroll
    for (int j = 0; j < V; ++j) dense_one<T>(h, inv_bc1, inv_bc2, g[j], p[j],
                                             m[j], v[j]);
    store<T, V>(param + e, p);
    store<T, V>(mu + e, m);
    store<T, V>(nu + e, v);
  }
  // The last n % V elements, one a thread.
  const int64_t e = vecs * V + first;
  if (e < n) {
    float p = to_f(param[e]), m = to_f(mu[e]), v = to_f(nu[e]);
    dense_one<T>(h, inv_bc1, inv_bc2, grad[e], p, m, v);
    param[e] = from_f<T>(p);
    mu[e] = from_f<T>(m);
    nu[e] = from_f<T>(v);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
adam_rows_kernel(Hyper h, int64_t num_slots, int32_t num_nodes, int32_t dim,
                 const int32_t* __restrict__ ids,
                 const uint8_t* __restrict__ flag,
                 const float* __restrict__ grad, T* __restrict__ param,
                 float* __restrict__ mu, float* __restrict__ nu) {
  const int per_row = dim / V;
  const int64_t items = num_slots * per_row;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += stride) {
    const int64_t slot = i / per_row;
    const int col = (int)(i - slot * per_row) * V;
    if (flag != nullptr && flag[slot] == 0) continue;
    const int64_t id = ids[slot];
    const int64_t row = id < 0 ? id + num_nodes : id;
    if (row < 0 || row >= num_nodes) continue;
    const int64_t at = row * dim + col;
    float g[V], p[V], m[V], v[V];
    load<float, V>(grad + slot * dim + col, g);
    load<T, V>(param + at, p);
    load<float, V>(mu + at, m);
    load<float, V>(nu + at, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float gf = round_to<T>(g[j]);
      m[j] = __fadd_rn(__fmul_rn(h.b1, m[j]), __fmul_rn(h.omb1, gf));
      v[j] = __fadd_rn(__fmul_rn(h.b2, v[j]),
                       __fmul_rn(h.omb2, __fmul_rn(gf, gf)));
      const float mhat = __fdiv_rn(m[j], h.bc1);
      const float vhat = __fdiv_rn(v[j], h.bc2);
      const float upd = __fdiv_rn(__fmul_rn(h.lr, mhat),
                                  __fadd_rn(__fsqrt_rn(vhat), h.eps));
      p[j] = __fsub_rn(p[j], upd);
    }
    store<T, V>(param + at, p);
    store<float, V>(mu + at, m);
    store<float, V>(nu + at, v);
  }
}

inline int grid_for(int64_t items) {
  int64_t blocks = (items + kThreads - 1) / kThreads;
  return (int)(blocks < 1 ? 1 : (blocks < kMaxGrid ? blocks : kMaxGrid));
}

template <typename T>
int dense(const Hyper& h, int64_t n, const float* grad, void* param, void* mu,
          void* nu, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  adam_dense_kernel<T><<<grid_for(n / V > 0 ? n / V : 1), kThreads, 0,
                         stream>>>(h, n, grad, (T*)param, (T*)mu, (T*)nu);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int rows(const Hyper& h, int64_t num_slots, int32_t num_nodes, int32_t dim,
         const int32_t* ids, const uint8_t* flag, const float* grad,
         void* param, float* mu, float* nu, cudaStream_t stream) {
  adam_rows_kernel<T, V><<<grid_for(num_slots * (dim / V)), kThreads, 0,
                           stream>>>(h, num_slots, num_nodes, dim, ids, flag,
                                     grad, (T*)param, mu, nu);
  return (int)cudaGetLastError();
}

}  // namespace adam
}  // namespace trw

namespace {
trw::adam::Hyper hyper(float lr, float b1, float omb1, float b2, float omb2,
                       float eps, float bc1, float bc2) {
  return trw::adam::Hyper{lr, b1, omb1, b2, omb2, eps, bc1, bc2};
}
}  // namespace

// K18, dense entry: n elements of param, mu, nu (the tables' type, 16-byte
// aligned) and grad (float32).
extern "C" int trw_adam_dense(int64_t n, int32_t elem_bytes, float lr,
                              float b1, float omb1, float b2, float omb2,
                              float eps, float bc1, float bc2,
                              const float* grad, void* param, void* mu,
                              void* nu, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const auto h = hyper(lr, b1, omb1, b2, omb2, eps, bc1, bc2);
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 4)
    return trw::adam::dense<float>(h, n, grad, param, mu, nu, st);
  if (elem_bytes == 2)
    return trw::adam::dense<__nv_bfloat16>(h, n, grad, param, mu, nu, st);
  return (int)cudaErrorInvalidValue;
}

// K18, rows entry: num_slots slots of (ids, flag or null, grad rows (M, D)
// float32) over param (N, D) of the tables' type and float32 mu, nu (N, D).
// vec = 1, or 16 / elem_bytes with D a multiple of it and rows 16-byte
// aligned.
extern "C" int trw_adam_rows(int64_t num_slots, int32_t num_nodes, int32_t dim,
                             int32_t elem_bytes, int32_t vec, float lr,
                             float b1, float omb1, float b2, float omb2,
                             float eps, float bc1, float bc2,
                             const int32_t* ids, const uint8_t* flag,
                             const float* grad, void* param, float* mu,
                             float* nu, void* stream) {
  if (num_slots < 1 || num_nodes < 1 || dim < 1)
    return (int)cudaErrorInvalidValue;
  const auto h = hyper(lr, b1, omb1, b2, omb2, eps, bc1, bc2);
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 4 && vec == 4 && dim % 4 == 0)
    return trw::adam::rows<float, 4>(h, num_slots, num_nodes, dim, ids, flag,
                                     grad, param, mu, nu, st);
  if (elem_bytes == 2 && vec == 8 && dim % 8 == 0)
    return trw::adam::rows<__nv_bfloat16, 8>(h, num_slots, num_nodes, dim,
                                             ids, flag, grad, param, mu, nu,
                                             st);
  if (vec != 1) return (int)cudaErrorInvalidValue;
  if (elem_bytes == 4)
    return trw::adam::rows<float, 1>(h, num_slots, num_nodes, dim, ids, flag,
                                     grad, param, mu, nu, st);
  if (elem_bytes == 2)
    return trw::adam::rows<__nv_bfloat16, 1>(h, num_slots, num_nodes, dim,
                                             ids, flag, grad, param, mu, nu,
                                             st);
  return (int)cudaErrorInvalidValue;
}
