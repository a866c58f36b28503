// K17's histogram and owner passes: the gradient of the per-window SGNS
// loss summed by the rows that receive it (see sgns_windows.cu for the
// loss, the per-window pass and what they replace).
//
// Row r of out_emb's gradient is
//   grad_out[r] = sum over the out slots s that address r of g[s] * h_b,
// g[s] the slot's dloss/dlogit, h_b its window's in row (skip-gram, read
// from in_emb) or the mean of its context rows (CBOW, written by the pass).
//
// Bound on this card: bytes.  The atomic version added g * h into the dense
// float32 table for every slot: 6.8 M read-modify-writes of 512-byte rows at
// the bench shape, each fetching its row from device memory, after a
// zero-fill of the table.  Here the slots are bucketed by row with a
// counting sort: a histogram with integer atomics into an (N) count array
// that fits L2 (before the per-window pass: the ids depend only on the
// windows), the wrapper's exclusive scan, and the pass's placement of each
// slot's (source row, g) entry.  Then a group of lanes owns each row: it
// reads its entries, gathers their source rows (16-byte loads, up to four
// slots in flight), sums g * h in float32 registers and writes the row once
// with 16-byte stores; a row with no slot is written as zeros by the same
// pass, so the table needs no zero-fill and no atomic touches it.  A row of
// more than heavy_slots slots (a hub among the positives) is left to a
// second pass in which a block of 256 threads owns it: each group sums a
// strided share of the entries, and the shares are added in group order
// through shared memory.
//
// The pass places a row's slots in the order its atomics return, so the
// order of a row's sum, and its last bits, can change from run to run: K17
// is held to its plain version within K6's limit, 1e-4 of the largest entry.

#include "sgns_windows.cuh"

namespace trw {
namespace win {

constexpr int kHeavyGrid = 264;  // blocks of the heavy pass, 2 an SM

__global__ void __launch_bounds__(kThreads)
windows_hist_kernel(const int32_t* __restrict__ pos,
                    const int32_t* __restrict__ neg, int64_t slots,
                    int32_t cols, int32_t num_nodes,
                    int32_t* __restrict__ counts) {
  for (int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x; s < slots;
       s += (int64_t)gridDim.x * kThreads)
    atomicAdd(counts + out_slot_row(pos, neg, cols, num_nodes, s), 1);
}

// One owner pass: row r's entries entries[offsets[r] .. offsets[r + 1]),
// each (source row, weight bits).
struct Owner {
  const int32_t* offsets;  // (N + 1)
  const int2* entries;
  const int32_t* heavy_count;
  const int32_t* heavy;
  float* grad;             // (N, D)
  int32_t num_nodes, dim, heavy_slots;
};

// acc += weight * source row for the entries first, first + stride, ...
// below end, in that order, up to four in flight (eight measured no faster:
// PERF.md).
template <typename S, int V, int K>
__device__ __forceinline__ void owner_sum(const Owner& o,
                                          const S* __restrict__ src, int lane,
                                          int first, int end, int stride,
                                          float (&acc)[K][V]) {
  using IO = RowIO<S, V>;
  using Raw = typename IO::Raw;
  constexpr int kU = K >= 4 ? 1 : 4 / K;
  for (int i = first; i < end; i += kU * stride) {
    int64_t rows[kU];
    float wt[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = i + u * stride;
      rows[u] = -1;
      wt[u] = 0.0f;
      if (j < end) {
        const int2 e = __ldg(o.entries + j);
        rows[u] = e.x;
        wt[u] = __int_as_float(e.y);
      }
    }
    Raw r[kU][K];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        r[u][k] = Raw{};
        const int at = piece_at<V>(k, lane);
        if (rows[u] >= 0 && at < o.dim)
          r[u][k] = IO::load(src + rows[u] * o.dim + at);
      }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (rows[u] < 0) continue;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float v[V];
        IO::unpack(r[u][k], v);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[k][j] = fmaf(wt[u], v[j], acc[k][j]);
      }
    }
  }
}

// A group of lanes a row, every row of the table but the heavy ones.
template <typename S, int V, int K>
__global__ void __launch_bounds__(kThreads)
windows_owner_kernel(Owner o, const S* __restrict__ src) {
  constexpr int G = Lanes<V>::G, kGroups = kThreads / G;
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  for (int64_t r = (int64_t)blockIdx.x * kGroups + group; r < o.num_nodes;
       r += (int64_t)gridDim.x * kGroups) {
    const int c0 = __ldg(o.offsets + r), c1 = __ldg(o.offsets + r + 1);
    if (c1 - c0 > o.heavy_slots) continue;
    float acc[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[k][j] = 0.0f;
    owner_sum<S, V, K>(o, src, lane, c0, c1, 1, acc);
    float* dst = o.grad + r * o.dim;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int at = piece_at<V>(k, lane);
      if (at < o.dim) store_floats<V>(dst + at, acc[k]);
    }
  }
}

// A block a heavy row: group i sums slots i, i + groups, ...; the groups'
// sums are added in group order.
template <typename S, int V, int K>
__global__ void __launch_bounds__(kThreads)
windows_owner_heavy_kernel(Owner o, const S* __restrict__ src) {
  constexpr int G = Lanes<V>::G, kGroups = kThreads / G;
  __shared__ float part[kGroups][kMaxDim];
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  const int count = *o.heavy_count;
  for (int i = blockIdx.x; i < count; i += gridDim.x) {
    const int64_t r = o.heavy[i];
    const int c0 = o.offsets[r], c1 = o.offsets[r + 1];
    float acc[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[k][j] = 0.0f;
    owner_sum<S, V, K>(o, src, lane, c0 + group, c1, kGroups, acc);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int at = piece_at<V>(k, lane);
      if (at < o.dim)
#pragma unroll
        for (int j = 0; j < V; ++j) part[group][at + j] = acc[k][j];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < o.dim; e += kThreads) {
      float s = 0.0f;
      for (int q = 0; q < kGroups; ++q) s += part[q][e];
      o.grad[r * o.dim + e] = s;
    }
    __syncthreads();
  }
}

int launch_histogram(const GradCall& c, cudaStream_t stream) {
  const int64_t slots = c.num_windows * 2 * c.out_cols;
  windows_hist_kernel<<<grid_for(slots, kThreads), kThreads, 0, stream>>>(
      c.pos, c.neg, slots, c.out_cols, c.num_nodes, c.sort);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_owner(const Owner& o, const S* src, int vec, cudaStream_t stream) {
  return with_width<S>(vec, o.dim, [&](auto v, auto k) -> int {
    constexpr int V = decltype(v)::value, K = decltype(k)::value;
    constexpr int kGroups = kThreads / Lanes<V>::G;
    windows_owner_kernel<S, V, K>
        <<<grid_for(o.num_nodes, kGroups), kThreads, 0, stream>>>(o, src);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    windows_owner_heavy_kernel<S, V, K>
        <<<kHeavyGrid, kThreads, 0, stream>>>(o, src);
    return (int)cudaGetLastError();
  });
}

int launch_owners(const GradCall& c, cudaStream_t stream) {
  const Owner o{c.sort + c.num_nodes + 1, c.entries, c.sort + c.num_nodes,
                c.heavy, c.grad_out, c.num_nodes, c.dim, c.heavy_slots};
  if (c.cbow)  // the (B, D) h buffer
    return launch_owner<float>(o, c.h, c.dim % 4 == 0 ? 4 : 1, stream);
  if (c.elem_bytes == 4)
    return launch_owner<float>(o, (const float*)c.in_emb, c.vec, stream);
  return launch_owner<__nv_bfloat16>(o, (const __nv_bfloat16*)c.in_emb,
                                     c.vec, stream);
}

}  // namespace win
}  // namespace trw
