// K20: the KGE co-occurrence losses over composed triple vectors, skip-gram
// and CBOW (template flag), and their gradient, in one pass over the
// windows.
//
// Replaces the XLA programs of torch_random_walk_tpu/models/kge.py::
// KGEModel.skipgram_loss_fn (:223) and cbow_loss_fn (:245) and their
// jax.value_and_grad in skipgram_train_step (:377) and cbow_train_step
// (:385); XLA fuses them on the TPU, and they have no Pallas counterpart.
// A triple (h, r, t) is embedded as the composition (kge.py:_compose:207)
//   c(h, r, t) = E[h] + R[r] + E[t],
// each component outside [0, n) of its table left out, summed in the
// tables' type (a bfloat16 sum rounded after each add, as JAX's is), with
// the in tables (E_in, R_in) or the out tables (E_out, R_out).  Logits are
// float32 dot products.  The padding id marks a slot by its relation.
// Skip-gram, window b of (targets (B, 3), pos and neg (B, C, 3)):
//   u = c_in(target), loss_b = -(sum over c with pos[b, c].r != pad of
//       logsig(u . c_out(pos[b, c]))
//       + sum over c of logsig(-u . c_out(neg[b, c])))
//   weight: targets[b].r != pad; negatives are never masked.
// CBOW, window b of (pos and neg (B, 3), windows (B, C, 3)):
//   m = (sum over c with windows[b, c].r != pad of c_out(windows[b, c]))
//       / max(that count, 1), the sum and the division in the tables' type;
//   loss_b = -(logsig(m . c_in(pos[b])) + logsig(-m . c_in(neg[b])))
//   weight: pos[b].r != pad.
// loss = (sum of weight * loss_b) / max(sum of weights, 1), the count taken
// on the device (count_kernel).  A window of weight 0 adds nothing to the
// loss or the gradient and is skipped whole.
//
// Bound on this card: bytes.  A skip-gram window reads up to 3 (1 + 2 C)
// rows (39 at W = 3) and does 2 D flops a composed slot.  A group of lanes
// takes a window (a half-warp of 16-byte loads for bfloat16 rows of 128, a
// warp for float32), issues a composition's three row loads together and
// keeps u and its gradient in registers over the window's slots.  The
// gradient rows are float32 tables zeroed by the wrapper.  Adding each
// composed gradient to its three source rows with float4 atomics makes 39
// row adds a skip-gram window at W = 3, 13 of them on relation rows (on a
// KG of 16 relations about a million on each address a step), and 24 a
// CBOW window.  This design uses that every out slot's gradient is a
// multiple of one vector (skip-gram: g_s u; CBOW: dm / n):
//   - a group takes its slots in rounds of G (lane i holding slot i's rows
//     and coefficient) and merges the rows that repeat within a round by
//     shuffles: each distinct row gets (the sum of its occurrences'
//     coefficients) times the vector in one add.  A positive's tail is the
//     next positive's head, a composition with h == t counts twice, a
//     negative equal to a row of the window merges too, and a CBOW context
//     row gets its multiplicity; the in rows (skip-gram's target, CBOW's
//     positive and negative, multiples of du and m) merge the same way;
//   - the relation rows go to the block's sums in shared memory, flushed
//     once at its end (kge.cuh RelGrad): the leading rows whose sums in
//     both relation tables fit kRelSharedBytes (the wrapper's choice,
//     rel_shared_rows); rows past them, in larger vocabularies, are added
//     to the tables, merged as the entity rows.
// At W = 3 on walks a skip-gram window makes at most 22 global row adds
// (2 in rows, at most 8 distinct positive and 12 negative entity rows), a
// CBOW window at most 12.  Masked slots, windows of weight 0 and components
// outside [0, n) add nothing.  D <= 512; D no multiple of the load width
// takes one element a lane a step.  The groups of a warp run apart (kge.cuh
// group_reduce), so a skipped window or slot costs its group nothing more.
//
// The loss is deterministic as K19's: group, block and finish sums in fixed
// orders over a grid that depends only on B and the load width.

#include "kge.cuh"

namespace trw {
namespace kge {

// One call of K20.  Layout shared with bindings.py's _KgeWindowsCall.
struct WindowsCall {
  const void* ent_in;       // (N_e, D) float32 or bfloat16
  const void* rel_in;       // (N_r, D)
  const void* ent_out;
  const void* rel_out;
  const int32_t* center;    // skip-gram: targets (B, 3);
                            // CBOW: windows (B, C, 3)
  const int32_t* pos;       // skip-gram: (B, C, 3); CBOW: (B, 3)
  const int32_t* neg;       // skip-gram: (B, C, 3); CBOW: (B, 3)
  int32_t* count;           // zero on entry
  float* partial;           // one a block
  float* loss;
  const float* grad_loss;   // device scalar, or null for 1
  float* grad_ent_in;       // float32, zero on entry; null: no gradient
  float* grad_rel_in;
  float* grad_ent_out;
  float* grad_rel_out;
  int64_t num_windows;
  int32_t cols, num_ent, num_rel, dim, padding_idx, cbow, elem_bytes, vec;
  int32_t rel_shared_rows;  // leading relation rows whose gradient the
                            // block sums in shared memory (kRelSharedBytes)
};

// A window's weight: its (B, 3) triple's relation is not the padding.
struct RelationWeight {
  const int32_t* triples;
  int32_t pad;
  __device__ int operator()(int64_t i) const {
    return __ldg(triples + 3 * i + 1) != pad;
  }
};

// Tables of one side (in or out) and their gradients.
template <typename T>
struct Side {
  const T* ent;
  const T* rel;
  float* grad_ent;
  RelGrad grad_rel;
};

// Lane `lane`'s pieces of c(ids) on `side`; rows[i] the component's row, or
// -1 where it lies outside its table.
template <typename T, int V, int K>
__device__ __forceinline__ void compose(const Side<T>& side,
                                        const int32_t* ids, int32_t num_ent,
                                        int32_t num_rel, int dim, int lane,
                                        float (&out)[K][V],
                                        int32_t (&rows)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int32_t id = __ldg(ids + i);
    const int32_t n = i == 1 ? num_rel : num_ent;
    rows[i] = id >= 0 && id < n ? id : -1;
  }
  float a[K][V], r[K][V], t[K][V];
  if (rows[0] >= 0)
    load_pieces<T, V, K>(side.ent + (int64_t)rows[0] * dim, lane, dim, a);
  else
    zero_pieces(a);
  if (rows[1] >= 0)
    load_pieces<T, V, K>(side.rel + (int64_t)rows[1] * dim, lane, dim, r);
  else
    zero_pieces(r);
  if (rows[2] >= 0)
    load_pieces<T, V, K>(side.ent + (int64_t)rows[2] * dim, lane, dim, t);
  else
    zero_pieces(t);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j)
      out[k][j] = round_to<T>(round_to<T>(a[k][j] + r[k][j]) + t[k][j]);
}

template <int K, int V>
__device__ __forceinline__ float lane_dot(const float (&a)[K][V],
                                          const float (&b)[K][V]) {
  float x = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) x = fmaf(a[k][j], b[k][j], x);
  return x;
}

// out = s * a (+ out where `add`).
template <int K, int V>
__device__ __forceinline__ void scaled(float s, const float (&a)[K][V],
                                       float (&out)[K][V], bool add) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j)
      out[k][j] = add ? fmaf(s, a[k][j], out[k][j]) : s * a[k][j];
}

// The row adds of a round of n <= G composed slots of `side`, lane i < n
// holding slot i's rows (-1: none, the slot skipped or the component
// outside its table) and its coefficient c, every other lane -1: each
// distinct entity row of the round gets (the sum of c over its occurrences,
// h and t alike) times x in one float4 atomic row add; each distinct
// relation row likewise, to the block's sum or the table.  The first
// occurrence adds.  Group-collective: every lane of the group calls it.
template <typename T, int V, int K>
__device__ __forceinline__ void merged_adds(const Side<T>& side,
                                            const int32_t (&rows)[3],
                                            float c, int n, int dim,
                                            int lane,
                                            const float (&x)[K][V]) {
  constexpr int G = Lanes<V>::G;
  const unsigned mask = group_mask<G>();
  float coef[3] = {0.0f, 0.0f, 0.0f};
  bool lead[3] = {rows[0] >= 0, rows[1] >= 0,
                  rows[2] >= 0 && rows[2] != rows[0]};
  for (int j = 0; j < n; ++j) {
    const int32_t hj = __shfl_sync(mask, rows[0], j, G);
    const int32_t rj = __shfl_sync(mask, rows[1], j, G);
    const int32_t tj = __shfl_sync(mask, rows[2], j, G);
    const float cj = __shfl_sync(mask, c, j, G);
#pragma unroll
    for (int i = 0; i < 3; i += 2) {
      const bool at_h = hj == rows[i], at_t = tj == rows[i];
      if (at_h) coef[i] += cj;
      if (at_t) coef[i] += cj;
      if (j < lane && (at_h || at_t)) lead[i] = false;
    }
    if (rj == rows[1]) {
      coef[1] += cj;
      if (j < lane) lead[1] = false;
    }
  }
  const int first = (threadIdx.x & 31) & ~(G - 1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    for (unsigned leaders = __ballot_sync(mask, lead[i]) >> first;
         leaders != 0; leaders &= leaders - 1) {
      const int from = __ffs(leaders) - 1;
      const int32_t row = __shfl_sync(mask, rows[i], from, G);
      float v[K][V];
      scaled(__shfl_sync(mask, coef[i], from, G), x, v, false);
      if (i == 1)
        add_rel<V, K>(side.grad_rel, row, lane, v);
      else
        add_pieces<V, K>(side.grad_ent + (int64_t)row * dim, lane, dim, v);
    }
  }
}

template <typename T, int V, int K, bool kCbow, bool kGrad>
__global__ void __launch_bounds__(kThreads)
kge_windows_kernel(WindowsCall c) {
  constexpr int G = Lanes<V>::G, kGroups = kThreads / G;
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  const int dim = c.dim, cols = c.cols, pad = c.padding_idx;
  const int32_t ne = c.num_ent, nr = c.num_rel;
  const int stride = rel_stride(dim, V);
  const int rows = kGrad ? c.rel_shared_rows : 0;
  float* shared = rel_sum_buffer();
  const Side<T> in{static_cast<const T*>(c.ent_in),
                   static_cast<const T*>(c.rel_in), c.grad_ent_in,
                   RelGrad{c.grad_rel_in, shared, dim, stride, rows}};
  const Side<T> out{static_cast<const T*>(c.ent_out),
                    static_cast<const T*>(c.rel_out), c.grad_ent_out,
                    RelGrad{c.grad_rel_out, shared + rows * stride, dim,
                            stride, rows}};
  float scale = 0.0f;
  if constexpr (kGrad) {
    scale = mean_scale(c.grad_loss, c.count);
    if (rows > 0) {
      zero_shared(shared, 2 * rows * stride);
      __syncthreads();
    }
  }
  float sum = 0.0f;
  for (int64_t b = (int64_t)blockIdx.x * kGroups + group; b < c.num_windows;
       b += (int64_t)gridDim.x * kGroups) {
    if constexpr (!kCbow) {
      const int32_t* tg = c.center + 3 * b;
      if (__ldg(tg + 1) == pad) continue;  // weight 0
      float u[K][V], du[K][V];
      int32_t urows[3];
      compose<T, V, K>(in, tg, ne, nr, dim, lane, u, urows);
      zero_pieces(du);
      float acc = 0.0f;
      int32_t mine[3] = {-1, -1, -1};  // lane i: the round's slot i
      float mine_c = 0.0f;
      for (int s = 0; s < 2 * cols; ++s) {
        const bool positive = s < cols;
        const int32_t* q = positive ? c.pos + 3 * (b * cols + s)
                                    : c.neg + 3 * (b * cols + s - cols);
        if (!positive || __ldg(q + 1) != pad) {  // masked positives: none
          float v[K][V];
          int32_t vrows[3];
          compose<T, V, K>(out, q, ne, nr, dim, lane, v, vrows);
          const float x = group_reduce<G>(lane_dot(u, v));
          acc += log_sigmoid(positive ? x : -x);
          if constexpr (kGrad) {
            // d(-logsig(x))/dx = -sigmoid(-x); d(-logsig(-x))/dx =
            // sigmoid(x).  The slot's out rows get g u, its in rows g v.
            const float g =
                positive ? -scale * sigmoid(-x) : scale * sigmoid(x);
            scaled(g, v, du, true);
            if (lane == s % G) {
#pragma unroll
              for (int j = 0; j < 3; ++j) mine[j] = vrows[j];
              mine_c = g;
            }
          }
        }
        if constexpr (kGrad) {
          if (s % G == G - 1 || s == 2 * cols - 1) {  // the round's end
            merged_adds(out, mine, mine_c, s % G + 1, dim, lane, u);
#pragma unroll
            for (int j = 0; j < 3; ++j) mine[j] = -1;
            mine_c = 0.0f;
          }
        }
      }
      sum += acc;
      if constexpr (kGrad) {
#pragma unroll
        for (int j = 0; j < 3; ++j) mine[j] = lane == 0 ? urows[j] : -1;
        merged_adds(in, mine, 1.0f, 1, dim, lane, du);
      }
    } else {
      const int32_t* pt = c.pos + 3 * b;
      if (__ldg(pt + 1) == pad) continue;  // weight 0
      float m[K][V];
      zero_pieces(m);
      int real = 0;
      for (int s = 0; s < cols; ++s) {
        const int32_t* q = c.center + 3 * (b * cols + s);
        if (__ldg(q + 1) == pad) continue;
        float v[K][V];
        int32_t vrows[3];
        compose<T, V, K>(out, q, ne, nr, dim, lane, v, vrows);
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int j = 0; j < V; ++j) m[k][j] += v[k][j];
        ++real;
      }
      const float denom = (float)(real > 1 ? real : 1);
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j)
          m[k][j] = round_to<T>(round_to<T>(m[k][j]) / denom);
      float up[K][V], un[K][V];
      int32_t prows[3], nrows[3];
      compose<T, V, K>(in, pt, ne, nr, dim, lane, up, prows);
      compose<T, V, K>(in, c.neg + 3 * b, ne, nr, dim, lane, un, nrows);
      const float xp = group_reduce<G>(lane_dot(m, up));
      const float xn = group_reduce<G>(lane_dot(m, un));
      sum += log_sigmoid(xp) + log_sigmoid(-xn);
      if constexpr (kGrad) {
        // The positive's in rows get gp m, the negative's gn m (lanes 0
        // and 1); every unmasked context slot's out rows dm / denom.
        const float gp = -scale * sigmoid(-xp), gn = scale * sigmoid(xn);
        int32_t mine[3];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          mine[j] = lane == 0 ? prows[j] : (lane == 1 ? nrows[j] : -1);
        merged_adds(in, mine, lane == 0 ? gp : gn, 2, dim, lane, m);
        float dm[K][V];
        scaled(gp, up, dm, false);
        scaled(gn, un, dm, true);
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int j = 0; j < V; ++j) dm[k][j] = dm[k][j] / denom;
        for (int base = 0; base < cols; base += G) {
          const int n = cols - base < G ? cols - base : G;
#pragma unroll
          for (int j = 0; j < 3; ++j) mine[j] = -1;
          if (lane < n) {
            const int32_t* q = c.center + 3 * (b * cols + base + lane);
            if (__ldg(q + 1) != pad) {
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                const int32_t id = __ldg(q + j);
                mine[j] = id >= 0 && id < (j == 1 ? nr : ne) ? id : -1;
              }
            }
          }
          merged_adds(out, mine, 1.0f, n, dim, lane, dm);
        }
      }
    }
  }
  if constexpr (kGrad) {
    if (rows > 0) {
      __syncthreads();
      flush_rel<V, K>(in.grad_rel);
      flush_rel<V, K>(out.grad_rel);
    }
  }
  block_partial<kGroups>(sum, group, lane, c.partial);
}

inline int groups_per_block(int vec) {
  return kThreads / (vec == 8 ? Lanes<8>::G : Lanes<4>::G);
}

inline int windows_grid(int64_t num_windows, int vec) {
  return win::grid_for(num_windows, groups_per_block(vec));
}

template <typename T, bool kCbow, bool kGrad>
int launch_pass(const WindowsCall& c, cudaStream_t stream) {
  const int grid = windows_grid(c.num_windows, c.vec);
  const size_t shared =
      kGrad ? rel_shared_bytes(c.rel_shared_rows, c.dim, c.vec, 2) : 0;
  return win::with_width<T>(c.vec, c.dim, [&](auto v, auto k) -> int {
    constexpr int V = decltype(v)::value, K = decltype(k)::value;
    kge_windows_kernel<T, V, K, kCbow, kGrad>
        <<<grid, kThreads, shared, stream>>>(c);
    return (int)cudaGetLastError();
  });
}

template <typename T, bool kGrad>
int dispatch_form(const WindowsCall& c, cudaStream_t stream) {
  return c.cbow ? launch_pass<T, true, kGrad>(c, stream)
                : launch_pass<T, false, kGrad>(c, stream);
}

bool valid_call(const WindowsCall& c, bool grad) {
  return c.num_windows >= 1 && c.cols >= 1 && c.dim >= 1 &&
         c.dim <= kMaxDim && c.num_ent >= 1 && c.num_rel >= 1 &&
         (c.vec == 1 || c.dim % c.vec == 0) && c.count != nullptr &&
         c.partial != nullptr && c.loss != nullptr &&
         (!grad || (c.grad_ent_in != nullptr && c.grad_rel_in != nullptr &&
                    c.grad_ent_out != nullptr && c.grad_rel_out != nullptr)) &&
         c.rel_shared_rows >= 0 && c.rel_shared_rows <= c.num_rel &&
         rel_shared_bytes(c.rel_shared_rows, c.dim, c.vec, 2) <=
             kRelSharedBytes;
}

int run(const WindowsCall& c, bool grad, cudaStream_t stream) {
  if (!valid_call(c, grad)) return (int)cudaErrorInvalidValue;
  int rc = (int)launch_count(
      RelationWeight{c.cbow ? c.pos : c.center, c.padding_idx}, c.num_windows,
      c.count, stream);
  if (rc != 0) return rc;
  if (c.elem_bytes == 4)
    rc = grad ? dispatch_form<float, true>(c, stream)
              : dispatch_form<float, false>(c, stream);
  else if (c.elem_bytes == 2)
    rc = grad ? dispatch_form<__nv_bfloat16, true>(c, stream)
              : dispatch_form<__nv_bfloat16, false>(c, stream);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)launch_finish(Mean{c.count, c.partial, c.loss},
                            windows_grid(c.num_windows, c.vec), stream);
}

}  // namespace kge
}  // namespace trw

// The number of partial sums (blocks) of a call on num_windows windows.
extern "C" int trw_kge_windows_grid(int64_t num_windows, int32_t vec) {
  return trw::kge::windows_grid(num_windows, vec);
}

// K20, loss only: loss[0] = the masked mean.
extern "C" int trw_kge_windows_loss(const trw::kge::WindowsCall* c,
                                    void* stream) {
  return trw::kge::run(*c, false, (cudaStream_t)stream);
}

// K20, the loss and its gradient times grad_loss in one pass: the four
// float32 gradient tables, zero on entry.
extern "C" int trw_kge_windows_loss_and_grads(const trw::kge::WindowsCall* c,
                                              void* stream) {
  return trw::kge::run(*c, true, (cudaStream_t)stream);
}
