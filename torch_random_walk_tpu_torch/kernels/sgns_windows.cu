// K16 and K17: the per-window SGNS loss, forward (K16) and backward (K17), in
// its skip-gram and its CBOW form, and the two in one call (the train
// step's value and gradient).  This file holds the per-window pass, K16's
// body; sgns_windows_owner.cu holds K17's bucketing and owner passes.
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
// which the card's arithmetic would limit.  A group of lanes takes one
// window (a half-warp for bfloat16 tables: 16 lanes of one 16-byte load
// make a row of 128; a warp for float32), reads a batch of the window's
// ids first and then issues the batch's row loads (4 rows at D <= 128 in
// K16, 2 in K17's pass, which keeps them until dh) before the batch's
// first shuffle reduction, so each lane has them all in flight.  (8 and 4
// rows a batch spilled registers and measured slower: PERF.md.)  D that
// is no multiple of the load width takes one element a lane a step.
// D <= 512.
//
// K16's mean is deterministic: each group sums its windows in grid-stride
// order, each block its groups in order into partial[block], and the
// single-block reduction of K5 (launch_reduce_partials) sums the partials in
// a fixed order; the grid depends only on B and the load width.  So equal
// inputs give equal loss bits, and the fused call's loss (the same body with
// its gradient outputs on) equals K16's bit for bit.
//
// K17's pass (kGrad) runs after the histogram of the out slots and the
// wrapper's scan of it (sgns_windows_owner.cu).  For each out slot it
// takes the slot's place in its row's bucket (one returning atomic on the
// row's count, issued before the rows are gathered so that its latency
// hides behind them), computes g = dloss/dlogit times grad_loss / B and
// writes (the slot's source row, g) there, so the owner passes read one
// 8-byte entry and then one source row a slot: no atomic touches an out
// row.  The window's dh = sum
// of g * out row (divided by CI for CBOW) is added to each in row with one
// atomic row add (float4 atomicAdd, sm_90's vector atomics) into the
// zeroed in-row gradient: one read-modify-write a window in skip-gram,
// where the atomic version made nine.  (Bucketing the in rows too, and
// summing them by their owners from a (B, D) buffer of dh, measured slower
// in both forms: PERF.md.)  CBOW also writes each window's h for its out
// rows' owners.

#include "sgns_windows.cuh"

namespace trw {
namespace win {

struct Windows {
  const int32_t* in_ids;  // (B, CI)
  const int32_t* pos;     // (B, CO)
  const int32_t* neg;     // (B, CO)
  int64_t num_windows;    // B
  int32_t in_cols, out_cols, num_nodes, dim;
};

// Pass (a)'s gradient outputs (kGrad only).
struct WindowGrads {
  const float* grad_loss;  // device scalar, or null for 1
  float* h;                // CBOW: (B, D); else null
  float* grad_in;          // (N, D), zero on entry
  Sort sort;               // the out slots' scan in, their entries out
};

// An out slot's place in its row's bucket (filled from the back), taken
// by one returning atomic on the row's count before the window's rows are
// gathered, so that its latency hides behind them.
struct Place {
  int64_t row = -1;
  int32_t left = 0, start = 0, total = 0;
};

__device__ __forceinline__ Place reserve_slot(const Sort& st, int num_nodes,
                                              int64_t row) {
  const int32_t* offsets = st.sort + num_nodes + 1;
  Place p;
  p.row = row;
  p.left = atomicSub(st.sort + row, 1);
  p.start = __ldg(offsets + row);
  p.total = __ldg(offsets + row + 1) - p.start;
  return p;
}

// Write the slot's entry (src, g); the first slot of a heavy row lists it.
__device__ __forceinline__ void place_slot(const Sort& st, int num_nodes,
                                           const Place& p, int32_t src,
                                           float g) {
  st.entries[p.start + p.left - 1] = make_int2(src, __float_as_int(g));
  if (p.left == p.total && p.total > st.heavy_slots)
    st.heavy[atomicAdd(st.sort + num_nodes, 1)] = (int32_t)p.row;
}

// Lane `lane`'s pieces of rows[u] (row index, or -1: nothing loaded).
template <typename T, int V, int K, int B>
__device__ __forceinline__ void load_rows(
    const T* table, const int64_t (&rows)[B], int lane, int dim,
    typename RowIO<T, V>::Raw (&r)[B][K]) {
#pragma unroll
  for (int u = 0; u < B; ++u)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r[u][k] = typename RowIO<T, V>::Raw{};
      const int at = piece_at<V>(k, lane);
      if (rows[u] >= 0 && at < dim)
        r[u][k] = RowIO<T, V>::load(table + rows[u] * dim + at);
    }
}

template <typename T, int V, int K, bool kCbow, bool kGrad>
__global__ void __launch_bounds__(kThreads)
windows_pass_kernel(Windows w, const T* __restrict__ in_emb,
                    const T* __restrict__ out_emb, WindowGrads gr,
                    float* __restrict__ partial) {
  using IO = RowIO<T, V>;
  using Raw = typename IO::Raw;
  constexpr int G = Lanes<V>::G, kGroups = kThreads / G;
  // Rows a lane holds at once (a batch): 4 pieces for K16, 2 for K17's
  // pass, which keeps them until dh.
  constexpr int kBatch = kGrad ? 2 : 4;
  constexpr int kRows = K >= kBatch ? 1 : kBatch / K;
  __shared__ float red[kGroups];
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  const int dim = w.dim, n = w.num_nodes;
  const int in_cols = kCbow ? w.in_cols : 1;
  const int out_cols = kCbow ? 1 : w.out_cols, rows_out = 2 * out_cols;
  float scale = 0.0f;
  if constexpr (kGrad)
    scale = (gr.grad_loss ? __ldg(gr.grad_loss) : 1.0f) /
            (float)w.num_windows;
  const int64_t step = (int64_t)gridDim.x * kGroups;
  // Every group of a warp runs the same trips (the shuffles take the whole
  // warp); a group past the last window runs them idle.
  const int64_t first = (int64_t)blockIdx.x * kGroups + group;
  const int64_t trips =
      (w.num_windows - ((int64_t)blockIdx.x * kGroups + (group & ~(32 / G - 1)))
       + step - 1) / step;
  float sum = 0.0f;
  for (int64_t t = 0; t < trips; ++t) {
    const int64_t b = first + t * step;
    const bool active = b < w.num_windows;
    float h[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) h[k][j] = 0.0f;
    for (int c0 = 0; c0 < in_cols; c0 += kRows) {
      int64_t rows[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        rows[u] = active && c0 + u < in_cols
                      ? table_row(__ldg(w.in_ids + b * in_cols + c0 + u), n)
                      : -1;
      Raw r[kRows][K];
      load_rows<T, V, K, kRows>(in_emb, rows, lane, dim, r);
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (rows[u] < 0) continue;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float v[V];
          IO::unpack(r[u][k], v);
#pragma unroll
          for (int j = 0; j < V; ++j) h[k][j] += v[j];
        }
      }
    }
    if (kCbow) {
      const float cols = (float)in_cols;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) h[k][j] = h[k][j] / cols;
    }
    // The source row of the window's out slots for their owners.
    const int32_t src =
        kCbow ? (int32_t)b
              : (active ? (int32_t)table_row(__ldg(w.in_ids + b), n) : 0);
    float acc = 0.0f;
    float dh[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) dh[k][j] = 0.0f;
    for (int c0 = 0; c0 < rows_out; c0 += kRows) {
      int64_t rows[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int c = c0 + u;
        rows[u] = -1;
        if (active && c < rows_out) {
          const int32_t id =
              c < out_cols ? __ldg(w.pos + b * out_cols + c)
                           : __ldg(w.neg + b * out_cols + c - out_cols);
          rows[u] = table_row(id, n);
        }
      }
      Place mine;  // lane u < kRows places the batch's slot u
      if constexpr (kGrad) {
        if (lane < kRows && active && c0 + lane < rows_out)
          mine = reserve_slot(gr.sort, n,
                              out_slot_row(w.pos, w.neg, out_cols, n,
                                           b * rows_out + c0 + lane));
      }
      Raw r[kRows][K];
      load_rows<T, V, K, kRows>(out_emb, rows, lane, dim, r);
      float x[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        x[u] = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float v[V];
          IO::unpack(r[u][k], v);
#pragma unroll
          for (int j = 0; j < V; ++j) x[u] = fmaf(h[k][j], v[j], x[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) x[u] = group_sum<G>(x[u]);
      float gs[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        gs[u] = 0.0f;
        if (rows[u] < 0) continue;
        const bool positive = c0 + u < out_cols;
        acc += log_sigmoid(positive ? x[u] : -x[u]);
        if constexpr (kGrad) {
          // d(-logsig(x))/dx = -sigmoid(-x); d(-logsig(-x))/dx = sigmoid(x).
          gs[u] = positive ? -scale * sigmoid(-x[u]) : scale * sigmoid(x[u]);
          if (lane == u) place_slot(gr.sort, n, mine, src, gs[u]);
        }
      }
      if constexpr (kGrad) {
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (rows[u] < 0) continue;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            float v[V];
            IO::unpack(r[u][k], v);
#pragma unroll
            for (int j = 0; j < V; ++j)
              dh[k][j] = fmaf(gs[u], v[j], dh[k][j]);
          }
        }
      }
    }
    if (active) sum += acc;
    if constexpr (kGrad) {
      if (active) {
        if (kCbow) {
          const float cols = (float)in_cols;
#pragma unroll
          for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int j = 0; j < V; ++j) dh[k][j] = dh[k][j] / cols;
            const int at = piece_at<V>(k, lane);
            if (at < dim) store_floats<V>(gr.h + b * dim + at, h[k]);
          }
        }
        for (int c = 0; c < in_cols; ++c) {
          float* dst = gr.grad_in +
                       table_row(__ldg(w.in_ids + b * in_cols + c), n) * dim;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int at = piece_at<V>(k, lane);
            if (at < dim) atomic_add_floats<V>(dst + at, dh[k]);
          }
        }
      }
    }
  }
  if (partial == nullptr) return;
  if (lane == 0) red[group] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < kGroups; ++i) s += red[i];
    partial[blockIdx.x] = s;
  }
}

inline int groups_per_block(int vec) {
  return kThreads / (vec == 8 ? Lanes<8>::G : Lanes<4>::G);
}

template <typename T, bool kCbow, bool kGrad>
int launch_pass(const Windows& w, int vec, const void* in_emb,
                const void* out_emb, const WindowGrads& gr, float* partial,
                cudaStream_t stream) {
  const int grid = grid_for(w.num_windows, groups_per_block(vec));
  return with_width<T>(vec, w.dim, [&](auto v, auto k) -> int {
    constexpr int V = decltype(v)::value, K = decltype(k)::value;
    windows_pass_kernel<T, V, K, kCbow, kGrad><<<grid, kThreads, 0, stream>>>(
        w, (const T*)in_emb, (const T*)out_emb, gr, partial);
    return (int)cudaGetLastError();
  });
}

template <typename T, bool kGrad>
int dispatch_pass(const Windows& w, int vec, int cbow, const void* in_emb,
                  const void* out_emb, const WindowGrads& gr, float* partial,
                  cudaStream_t stream) {
  return cbow ? launch_pass<T, true, kGrad>(w, vec, in_emb, out_emb, gr,
                                            partial, stream)
              : launch_pass<T, false, kGrad>(w, vec, in_emb, out_emb, gr,
                                             partial, stream);
}

bool valid(const Windows& w, int vec, int cbow) {
  return w.num_windows >= 1 && w.dim >= 1 && w.dim <= kMaxDim &&
         w.num_nodes >= 1 && (cbow ? w.in_cols >= 1 : w.out_cols >= 1) &&
         (vec == 1 || w.dim % vec == 0);
}

// Pass (a): the loss's partial sums where `partial` is set (and the loss
// from them where `loss` is), and with kGrad the gradient outputs.
template <bool kGrad>
int run_pass(const Windows& w, int elem_bytes, int vec, int cbow,
             const void* in_emb, const void* out_emb, const WindowGrads& gr,
             float* partial, float* loss, cudaStream_t stream) {
  if (!valid(w, vec, cbow)) return (int)cudaErrorInvalidValue;
  int rc;
  if (elem_bytes == 4)
    rc = dispatch_pass<float, kGrad>(w, vec, cbow, in_emb, out_emb, gr,
                                     partial, stream);
  else if (elem_bytes == 2)
    rc = dispatch_pass<__nv_bfloat16, kGrad>(w, vec, cbow, in_emb, out_emb,
                                             gr, partial, stream);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0 || loss == nullptr) return rc;
  return (int)launch_reduce_partials(
      partial, grid_for(w.num_windows, groups_per_block(vec)),
      (double)w.num_windows, loss, stream);
}

}  // namespace win
}  // namespace trw

using trw::win::GradCall;

extern "C" int trw_sgns_windows_grid(int64_t num_windows, int32_t vec) {
  return trw::win::grid_for(num_windows, trw::win::groups_per_block(vec));
}

// K16.  loss[0] = the mean window loss; partial holds
// trw_sgns_windows_grid(num_windows, vec) floats of scratch.
extern "C" int trw_sgns_windows_loss_fwd(
    const int32_t* in_ids, const int32_t* pos, const int32_t* neg,
    int64_t num_windows, int32_t in_cols, int32_t out_cols, const void* in_emb,
    const void* out_emb, int32_t num_nodes, int32_t dim, int32_t elem_bytes,
    int32_t vec, int32_t cbow, float* partial, float* loss, void* stream) {
  trw::win::Windows w{in_ids, pos, neg, num_windows, in_cols, out_cols,
                      num_nodes, dim};
  return trw::win::run_pass<false>(w, elem_bytes, vec, cbow, in_emb, out_emb,
                                   trw::win::WindowGrads{}, partial, loss,
                                   (cudaStream_t)stream);
}

// K17, first half: the histogram of the out slots into c->sort, zero on
// entry.
extern "C" int trw_sgns_windows_grads_begin(const GradCall* c, void* stream) {
  if (c->grad_in == nullptr || c->grad_out == nullptr ||
      c->sort == nullptr || c->entries == nullptr || c->heavy == nullptr ||
      (c->cbow && c->h == nullptr) ||
      (c->loss != nullptr && c->partial == nullptr))
    return (int)cudaErrorInvalidValue;
  return trw::win::launch_histogram(*c, (cudaStream_t)stream);
}

// K17, second half, once the wrapper has written the offsets (the exclusive
// scan of the histogram): pass (a) (with the loss where c->loss is set),
// which places every out slot and adds the in rows' gradient, then the
// owner passes, which write every row of grad_out once.
extern "C" int trw_sgns_windows_grads_end(const GradCall* c, void* stream) {
  trw::win::Windows w{c->in_ids, c->pos, c->neg, c->num_windows,
                      c->in_cols, c->out_cols, c->num_nodes, c->dim};
  trw::win::WindowGrads gr{
      c->grad_loss, c->h, c->grad_in,
      trw::win::Sort{c->sort, c->entries, c->heavy, c->heavy_slots}};
  int rc = trw::win::run_pass<true>(w, c->elem_bytes, c->vec, c->cbow,
                                    c->in_emb, c->out_emb, gr, c->partial,
                                    c->loss, (cudaStream_t)stream);
  if (rc != 0) return rc;
  return trw::win::launch_owners(*c, (cudaStream_t)stream);
}
