// What the two sources of K16/K17 share (sgns_windows.cu: the per-window
// pass; sgns_windows_owner.cu: the histogram of the out slots and the owner
// passes): the launch constants, a group's share of a row, 16-byte row
// loads, float row stores and atomic row adds, the group sum, the dispatch
// on the load width and the number of row pieces a lane holds, and the
// layout of K17's counting sort.  The KGE kernels K19 and K20 (kge.cuh)
// take their rows the same way.

#pragma once

#include <type_traits>

#include "sgns_loss.cuh"

namespace trw {
namespace win {

constexpr int kThreads = 256;
constexpr int kMaxDim = 512;
constexpr int kMaxGrid = 4096;

// A group of lanes reads one row: on the vector path 128 elements a step
// (bfloat16: 16 lanes of 8 elements, one 16-byte load each; float32: 32
// lanes of 4), on the scalar path (D no multiple of the width, or tables
// not 16-byte aligned) 32 elements, one a lane.
template <int V>
struct Lanes {
  static constexpr int G = V == 8 ? 16 : 32;
};

// Lane `lane` of a group holds elements (k * G + lane) * V + j, k < K,
// j < V, those below D.
template <int V>
__device__ __forceinline__ int piece_at(int k, int lane) {
  return (k * Lanes<V>::G + lane) * V;
}

template <typename T, int V>
struct RowIO;

template <>
struct RowIO<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct RowIO<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[4]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
};

template <>
struct RowIO<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[1]) {
    v[0] = __uint_as_float((uint32_t)r << 16);
  }
};

template <>
struct RowIO<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[1]) {
    v[0] = r;
  }
};

// V float32 values to p (16-byte stores where V > 1).
template <int V>
__device__ __forceinline__ void store_floats(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

// V float32 values added to p (float4 atomics where V > 1, sm_90's vector
// atomics).
template <int V>
__device__ __forceinline__ void atomic_add_floats(float* p,
                                                  const float (&v)[V]) {
  if constexpr (V == 1) {
    atomicAdd(p, v[0]);
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      atomicAdd(reinterpret_cast<float4*>(p) + i,
                make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                            v[4 * i + 3]));
  }
}

// The sum of x over the G lanes of a group (the whole warp takes part).
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int m = G / 2; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// Run f(integral_constant<V>, integral_constant<K>) for rows of `dim`
// elements of T: V the load width (16 bytes, or 1 element where `vec` is 1),
// K the pieces a lane holds (1, 2 or 4 on the vector path, 16 on the scalar
// one).
template <int V>
using IntV = std::integral_constant<int, V>;

template <typename T, typename F>
int with_width(int vec, int dim, F&& f) {
  constexpr int kWide = 16 / (int)sizeof(T);
  if (vec == 1) return f(IntV<1>(), IntV<kMaxDim / 32>());
  if (vec != kWide) return (int)cudaErrorInvalidValue;
  const int k = (dim + 127) / 128;
  if (k <= 1) return f(IntV<kWide>(), IntV<1>());
  if (k <= 2) return f(IntV<kWide>(), IntV<2>());
  return f(IntV<kWide>(), IntV<4>());
}

inline int grid_for(int64_t items, int per_block) {
  const int64_t blocks = (items + per_block - 1) / per_block;
  return (int)(blocks < kMaxGrid ? (blocks < 1 ? 1 : blocks) : kMaxGrid);
}

// K17's counting sort of the out slots (slot s = b * 2 CO + c of window b:
// c < CO the positive pos[b, c], else the negative neg[b, c - CO]) by the
// row they address: sort[0, N) the histogram (consumed by the scatter),
// sort[N] the number of heavy rows (zero on entry), sort[N + 1, 2 N + 2)
// the offsets, the exclusive scan of the histogram, written by the wrapper.
// Entry entries[offsets[r] + i] of row r is (the slot's source row, the bits
// of its weight g = dloss/dlogit): the window's in row (skip-gram, a row of
// in_emb) or the window itself (CBOW, a row of the (B, D) h buffer).
struct Sort {
  int32_t* sort;
  int2* entries;         // (B * 2 CO)
  int32_t* heavy;        // rows of more than heavy_slots slots
  int32_t heavy_slots;
};

// Slot s's out row.
__device__ __forceinline__ int64_t out_slot_row(const int32_t* pos,
                                                const int32_t* neg, int cols,
                                                int num_nodes, int64_t s) {
  const int64_t per = 2 * (int64_t)cols, w = s / per;
  const int c = (int)(s - w * per);
  return table_row(c < cols ? __ldg(pos + w * cols + c)
                            : __ldg(neg + w * cols + c - cols),
                   num_nodes);
}

// One call of K17 (or of the fused loss and gradients): every buffer the
// passes read and write, allocated by the wrapper.  Layout shared with
// bindings.py's _WindowsGradCall.
struct GradCall {
  const int32_t* in_ids;  // (B, CI)
  const int32_t* pos;     // (B, CO)
  const int32_t* neg;     // (B, CO)
  const void* in_emb;     // (N, D) float32 or bfloat16
  const void* out_emb;
  float* partial;         // the loss's partial sums, or null (no loss)
  float* loss;
  const float* grad_loss;  // device scalar, or null for 1
  float* h;               // CBOW: (B, D), each window's h; else null
  float* grad_in;         // (N, D) float32, zero on entry
  float* grad_out;        // (N, D) float32
  int32_t* sort;          // (2 N + 2), zero on entry: see Sort
  int2* entries;
  int32_t* heavy;
  int64_t num_windows;
  int32_t in_cols, out_cols, num_nodes, dim, elem_bytes, vec, cbow,
      heavy_slots;
};

// sgns_windows_owner.cu: the histogram of the out slots (before the
// per-window pass, which scatters them), and the owner passes after it.
int launch_histogram(const GradCall& c, cudaStream_t stream);
int launch_owners(const GradCall& c, cudaStream_t stream);

}  // namespace win
}  // namespace trw
