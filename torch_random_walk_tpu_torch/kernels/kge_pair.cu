// K19: the KGE pair loss (logistic NEG over TransE, DistMult or RotatE
// scores) and its gradient, in one pass over the positives.
//
// Replaces the XLA programs of torch_random_walk_tpu/models/kge.py::
// KGEModel._pair_loss_tabs (:186) and its jax.value_and_grad in
// pair_train_step (:269) and pair_train_step_sparse (:350); XLA fuses them on
// the TPU, and they have no Pallas counterpart.  For positive b with
// (clipped) triple (h, r, t), weight w_b (1 where its unclipped relation is
// not the padding) and negatives (h'_k, r'_k, t'_k), k < K:
//   per_b = -(logsig(s(h, r, t)) + sum over k of logsig(-s(h'_k, r'_k, t'_k)))
//   loss  = (sum over b of w_b per_b) / max(sum over b of w_b, 1)
// with s (kge.py:_score_tabs:150):
//   TransE   margin - ||e_h + w_r - e_t||  (e_h + w_r, then - e_t, each
//            rounded to the tables' type as JAX's bfloat16 arithmetic rounds)
//   DistMult sum of e_h * w_r * e_t        (the products rounded the same way)
//   RotatE   margin - sqrt(sum |e_h o e^{i theta_r} - e_t|^2 + 1e-12), the
//            entity rows D/2 complex pairs (real half first), the relation
//            rows D/2 phases; float32.
// Masked positives enter with weight 0, as in JAX: their terms are computed
// and multiplied by 0.  At ||d|| = 0 JAX's TransE gradient is NaN (the
// derivative of sqrt at 0 times a zero vector); the gradient here is
// formed in the same order, ct * (0.5 / norm) * (2 d), and is NaN there too.
// The count of weighted positives is taken on the device (count_kernel) and
// read by the pass: no value goes back to the host.
//
// Bound on this card: bytes.  A positive reads its three rows and one new
// row a negative (a corrupted negative shares two of its three rows with its
// positive) and does a few flops an element.  A group of lanes takes one
// positive (a half-warp of 16-byte loads for bfloat16 rows of 128, a warp
// for float32) and keeps e_h, w_r and e_t in registers across the K
// negatives, loading only a negative's rows that differ from the
// positive's.  The gradient rows are float32 tables zeroed by the wrapper.
// Adding the positive's three rows and each negative's own row with float4
// atomics makes up to 7 row adds a positive, and every positive of a
// relation adds to the same relation row: on a KG of 16 relations some
// 80 000 float4 atomics on each of its addresses a step.  So:
//   - the relation rows' gradient summed by each block in shared memory
//     (the rows a negative shares with its positive summed in registers
//     first), flushed to the table once at the block's end: no global add
//     on a relation row inside the item loop, for the leading rows that fit
//     kRelSharedBytes (the wrapper's choice from the shapes,
//     rel_shared_rows; rows past them, in larger vocabularies, keep the
//     float4 row adds, where they contend far less);
//   - the entity rows a negative shares with its positive summed in
//     registers and added once a positive (h == t: once), a negative's own
//     row at once: at most 6 global row adds a positive at K = 4.
// D <= 512; D no multiple of the load width (RotatE: D/2) takes one element
// a lane a step.
//
// The loss is deterministic: each group sums its positives in grid-stride
// order, each block its groups in order, and the finish kernel the blocks'
// partials in one fixed order; the grid depends only on B and the load
// width.  The gradients' sums follow the atomics' order.

#include "kge.cuh"

namespace trw {
namespace kge {

enum Score : int { kTransE = 0, kDistMult = 1, kRotatE = 2 };

// One call of K19: inputs, outputs and scratch as device pointers.  Layout
// shared with bindings.py's _KgePairCall.
struct PairCall {
  const void* ent;          // (N_e, D) float32 or bfloat16
  const void* rel;          // (N_r, P): P = D, or D / 2 for RotatE
  const int32_t* pos;       // (B, 3), components in range
  const int32_t* neg;       // (B, K, 3)
  const uint8_t* valid;     // (B,)
  int32_t* count;           // zero on entry
  float* partial;           // one a block
  float* loss;
  const float* grad_loss;   // device scalar, or null for 1
  float* grad_ent;          // (N_e, D) float32, zero on entry; null: no grad
  float* grad_rel;          // (N_r, P) float32, zero on entry
  int64_t num_pos;
  int32_t num_neg, num_ent, num_rel, dim, score, elem_bytes, vec;
  int32_t rel_shared_rows;  // leading relation rows whose gradient the
                            // block sums in shared memory (kRelSharedBytes)
  float margin;
};

struct ValidWeight {
  const uint8_t* valid;
  __device__ int operator()(int64_t i) const { return __ldg(valid + i) != 0; }
};

// A triple's rows as a lane holds them: S entity segments (RotatE: the real
// and imaginary halves) of K pieces of V elements, and the relation row.
template <int S, int K, int V>
struct Rows {
  float h[S][K][V], r[K][V], t[S][K][V];
};

template <typename T, int S, int K, int V>
__device__ __forceinline__ void load_entity(const T* ent, int32_t row,
                                            int dim, int len, int lane,
                                            float (&out)[S][K][V]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
    load_pieces<T, V, K>(ent + (int64_t)row * dim + s * len, lane, len,
                         out[s]);
}

template <int S, int K, int V>
__device__ __forceinline__ void add_entity(float* grad, int32_t row, int dim,
                                           int len, int lane,
                                           const float (&g)[S][K][V]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
    add_pieces<V, K>(grad + (int64_t)row * dim + s * len, lane, len, g[s]);
}

template <int K, int V>
__device__ __forceinline__ void accumulate(float (&acc)[K][V],
                                           const float (&g)[K][V]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] += g[k][j];
}

template <int S, int K, int V>
__device__ __forceinline__ void accumulate(float (&acc)[S][K][V],
                                           const float (&g)[S][K][V]) {
#pragma unroll
  for (int s = 0; s < S; ++s) accumulate(acc[s], g[s]);
}

// The lane's share of the score's sum, and the residual the gradient
// needs (TransE: d; RotatE: the real and imaginary parts of d).  Products
// and sums are explicit (no contraction left to the compiler), so that the
// loss-only and the gradient instantiations give the same loss bits.
template <typename T, int kScore, int S, int K, int V>
__device__ __forceinline__ float lane_part(const Rows<S, K, V>& x,
                                           float (&d)[S][K][V]) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (kScore == kTransE) {
        const float e = round_to<T>(
            __fsub_rn(round_to<T>(__fadd_rn(x.h[0][k][j], x.r[k][j])),
                      x.t[0][k][j]));
        d[0][k][j] = e;
        acc = fmaf(e, e, acc);
      } else if constexpr (kScore == kDistMult) {
        acc = __fadd_rn(acc, round_to<T>(__fmul_rn(
                                 round_to<T>(__fmul_rn(x.h[0][k][j],
                                                       x.r[k][j])),
                                 x.t[0][k][j])));
      } else {
        float sn, cs;
        sincosf(x.r[k][j], &sn, &cs);
        const float re = x.h[0][k][j], im = x.h[S - 1][k][j];
        const float dr =
            __fsub_rn(fmaf(re, cs, __fmul_rn(-im, sn)), x.t[0][k][j]);
        const float di =
            __fsub_rn(fmaf(re, sn, __fmul_rn(im, cs)), x.t[S - 1][k][j]);
        d[0][k][j] = dr;
        d[S - 1][k][j] = di;
        acc = fmaf(dr, dr, fmaf(di, di, acc));
      }
    }
  return acc;
}

// The score from the group's sum; `norm` gets the norm (TransE, RotatE).
template <int kScore>
__device__ __forceinline__ float score_of(float total, float margin,
                                          float& norm) {
  if constexpr (kScore == kTransE) {
    norm = sqrtf(total);
    return margin - norm;
  } else if constexpr (kScore == kRotatE) {
    norm = sqrtf(total + 1e-12f);
    return margin - norm;
  } else {
    norm = 0.0f;
    return total;
  }
}

// g = c * ds/d(rows) for c = dloss/ds.  TransE and RotatE form it as JAX's
// norm does, ct * (0.5 / norm) * (2 d), NaN at norm 0 (TransE).  Each
// rounding's own derivative is taken as 1, and a product's factor is the
// value the forward pass used (DistMult's tail: e_h * w_r rounded to T).
template <typename T, int kScore, int S, int K, int V>
__device__ __forceinline__ void score_grad(const Rows<S, K, V>& x,
                                           const float (&d)[S][K][V],
                                           float norm, float c,
                                           Rows<S, K, V>& g) {
  const float kk = -c * (0.5f / norm);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (kScore == kTransE) {
        const float gd = kk * (2.0f * d[0][k][j]);
        g.h[0][k][j] = gd;
        g.r[k][j] = gd;
        g.t[0][k][j] = -gd;
      } else if constexpr (kScore == kDistMult) {
        g.h[0][k][j] = c * (x.r[k][j] * x.t[0][k][j]);
        g.r[k][j] = c * (x.h[0][k][j] * x.t[0][k][j]);
        g.t[0][k][j] = c * round_to<T>(x.h[0][k][j] * x.r[k][j]);
      } else {
        float sn, cs;
        sincosf(x.r[k][j], &sn, &cs);
        const float re = x.h[0][k][j], im = x.h[S - 1][k][j];
        const float gr = kk * (2.0f * d[0][k][j]);
        const float gi = kk * (2.0f * d[S - 1][k][j]);
        g.h[0][k][j] = gr * cs + gi * sn;
        g.h[S - 1][k][j] = gi * cs - gr * sn;
        g.r[k][j] = gr * (-re * sn - im * cs) + gi * (re * cs - im * sn);
        g.t[0][k][j] = -gr;
        g.t[S - 1][k][j] = -gi;
      }
    }
}

__device__ __forceinline__ int32_t clamp_id(int32_t id, int32_t n) {
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

// The float32 RotatE passes' blocks an SM: unbounded, ptxas gives the
// loss-only pass 72 registers (3 blocks an SM) and the gradient pass 110
// (2), each slower than with the registers of one more block (PERF.md).
template <typename T, int kScore, bool kGrad>
constexpr int kMinBlocks =
    std::is_same_v<T, float> && kScore == kRotatE ? (kGrad ? 3 : 4) : 1;

template <typename T, int V, int K, int kScore, bool kGrad>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, kScore, kGrad>))
kge_pair_kernel(PairCall c) {
  constexpr int S = kScore == kRotatE ? 2 : 1;
  constexpr int G = Lanes<V>::G, kGroups = kThreads / G;
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  const T* ent = static_cast<const T*>(c.ent);
  const T* rel = static_cast<const T*>(c.rel);
  const int dim = c.dim, len = kScore == kRotatE ? c.dim / 2 : c.dim;
  const int num_neg = c.num_neg;
  float scale = 0.0f;
  const RelGrad rel_grad{c.grad_rel, rel_sum_buffer(), len,
                         rel_stride(len, V), kGrad ? c.rel_shared_rows : 0};
  if constexpr (kGrad) {
    scale = mean_scale(c.grad_loss, c.count);
    if (rel_grad.shared_rows > 0) {
      zero_shared(rel_grad.shared, rel_grad.shared_rows * rel_grad.stride);
      __syncthreads();
    }
  }
  float sum = 0.0f;
  for (int64_t b = (int64_t)blockIdx.x * kGroups + group; b < c.num_pos;
       b += (int64_t)gridDim.x * kGroups) {
    const int32_t* p = c.pos + 3 * b;
    const int32_t ph = clamp_id(__ldg(p), c.num_ent);
    const int32_t pr = clamp_id(__ldg(p + 1), c.num_rel);
    const int32_t pt = clamp_id(__ldg(p + 2), c.num_ent);
    const float w = __ldg(c.valid + b) != 0 ? 1.0f : 0.0f;
    Rows<S, K, V> x;
    load_entity<T, S, K, V>(ent, ph, dim, len, lane, x.h);
    load_pieces<T, V, K>(rel + (int64_t)pr * len, lane, len, x.r);
    load_entity<T, S, K, V>(ent, pt, dim, len, lane, x.t);
    float d[S][K][V];
    float norm;
    const float s_pos = score_of<kScore>(
        group_reduce<G>(lane_part<T, kScore>(x, d)), c.margin, norm);
    float acc = log_sigmoid(s_pos);
    Rows<S, K, V> gsum;  // the positive's rows' gradient
    if constexpr (kGrad) {
      Rows<S, K, V> g;
      score_grad<T, kScore>(x, d, norm, -scale * w * sigmoid(-s_pos), g);
      gsum = g;
    }
    for (int k = 0; k < num_neg; ++k) {
      const int32_t* q = c.neg + 3 * (b * num_neg + k);
      const int32_t nh = clamp_id(__ldg(q), c.num_ent);
      const int32_t nr = clamp_id(__ldg(q + 1), c.num_rel);
      const int32_t nt = clamp_id(__ldg(q + 2), c.num_ent);
      Rows<S, K, V> y;
      if (nh == ph) {
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int i = 0; i < K; ++i)
#pragma unroll
            for (int j = 0; j < V; ++j) y.h[s][i][j] = x.h[s][i][j];
      } else {
        load_entity<T, S, K, V>(ent, nh, dim, len, lane, y.h);
      }
      if (nr == pr) {
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
          for (int j = 0; j < V; ++j) y.r[i][j] = x.r[i][j];
      } else {
        load_pieces<T, V, K>(rel + (int64_t)nr * len, lane, len, y.r);
      }
      if (nt == pt) {
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int i = 0; i < K; ++i)
#pragma unroll
            for (int j = 0; j < V; ++j) y.t[s][i][j] = x.t[s][i][j];
      } else {
        load_entity<T, S, K, V>(ent, nt, dim, len, lane, y.t);
      }
      float e[S][K][V];
      float nnorm;
      const float s_neg = score_of<kScore>(
          group_reduce<G>(lane_part<T, kScore>(y, e)), c.margin, nnorm);
      acc += log_sigmoid(-s_neg);
      if constexpr (kGrad) {
        Rows<S, K, V> g;
        score_grad<T, kScore>(y, e, nnorm, scale * w * sigmoid(s_neg), g);
        if (nh == ph) accumulate(gsum.h, g.h);
        else add_entity(c.grad_ent, nh, dim, len, lane, g.h);
        if (nr == pr) accumulate(gsum.r, g.r);
        else add_rel<V, K>(rel_grad, nr, lane, g.r);
        if (nt == pt) accumulate(gsum.t, g.t);
        else add_entity(c.grad_ent, nt, dim, len, lane, g.t);
      }
    }
    sum = __fadd_rn(sum, __fmul_rn(acc, w));
    if constexpr (kGrad) {
      if (ph == pt) {
        accumulate(gsum.h, gsum.t);
      } else {
        add_entity(c.grad_ent, pt, dim, len, lane, gsum.t);
      }
      add_entity(c.grad_ent, ph, dim, len, lane, gsum.h);
      add_rel<V, K>(rel_grad, pr, lane, gsum.r);
    }
  }
  if constexpr (kGrad) {
    if (rel_grad.shared_rows > 0) {
      __syncthreads();
      flush_rel<V, K>(rel_grad);
    }
  }
  block_partial<kGroups>(sum, group, lane, c.partial);
}

inline int rel_len(const PairCall& c) {
  return c.score == kRotatE ? c.dim / 2 : c.dim;
}

inline int groups_per_block(int vec) {
  return kThreads / (vec == 8 ? Lanes<8>::G : Lanes<4>::G);
}

inline int pair_grid(int64_t num_pos, int vec) {
  return win::grid_for(num_pos, groups_per_block(vec));
}

template <typename T, int kScore, bool kGrad>
int launch_pass(const PairCall& c, cudaStream_t stream) {
  const int grid = pair_grid(c.num_pos, c.vec);
  const int len = rel_len(c);
  const size_t shared =
      kGrad ? rel_shared_bytes(c.rel_shared_rows, len, c.vec, 1) : 0;
  return win::with_width<T>(c.vec, len, [&](auto v, auto k) -> int {
    constexpr int V = decltype(v)::value, K = decltype(k)::value;
    kge_pair_kernel<T, V, K, kScore, kGrad>
        <<<grid, kThreads, shared, stream>>>(c);
    return (int)cudaGetLastError();
  });
}

template <typename T, bool kGrad>
int dispatch_score(const PairCall& c, cudaStream_t stream) {
  switch (c.score) {
    case kTransE:
      return launch_pass<T, kTransE, kGrad>(c, stream);
    case kDistMult:
      return launch_pass<T, kDistMult, kGrad>(c, stream);
    case kRotatE:
      return launch_pass<T, kRotatE, kGrad>(c, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool valid_call(const PairCall& c, bool grad) {
  const int len = rel_len(c);
  return c.num_pos >= 1 && c.num_neg >= 0 && c.dim >= 1 &&
         c.dim <= kMaxDim && len >= 1 &&
         (c.score != kRotatE || c.dim % 2 == 0) && c.num_ent >= 1 &&
         c.num_rel >= 1 && (c.vec == 1 || len % c.vec == 0) &&
         c.count != nullptr && c.partial != nullptr && c.loss != nullptr &&
         (!grad || (c.grad_ent != nullptr && c.grad_rel != nullptr)) &&
         c.rel_shared_rows >= 0 && c.rel_shared_rows <= c.num_rel &&
         rel_shared_bytes(c.rel_shared_rows, len, c.vec, 1) <=
             kRelSharedBytes;
}

int run(const PairCall& c, bool grad, cudaStream_t stream) {
  if (!valid_call(c, grad)) return (int)cudaErrorInvalidValue;
  int rc = (int)launch_count(ValidWeight{c.valid}, c.num_pos, c.count, stream);
  if (rc != 0) return rc;
  if (c.elem_bytes == 4)
    rc = grad ? dispatch_score<float, true>(c, stream)
              : dispatch_score<float, false>(c, stream);
  else if (c.elem_bytes == 2)
    rc = grad ? dispatch_score<__nv_bfloat16, true>(c, stream)
              : dispatch_score<__nv_bfloat16, false>(c, stream);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)launch_finish(Mean{c.count, c.partial, c.loss},
                            pair_grid(c.num_pos, c.vec), stream);
}

}  // namespace kge
}  // namespace trw

// The number of partial sums (blocks) of a call on num_pos positives.
extern "C" int trw_kge_pair_grid(int64_t num_pos, int32_t vec) {
  return trw::kge::pair_grid(num_pos, vec);
}

// K19, loss only: loss[0] = the masked mean.
extern "C" int trw_kge_pair_loss(const trw::kge::PairCall* c, void* stream) {
  return trw::kge::run(*c, false, (cudaStream_t)stream);
}

// K19, the loss and its gradient times grad_loss in one pass: the two
// float32 gradient tables, zero on entry.
extern "C" int trw_kge_pair_loss_and_grads(const trw::kge::PairCall* c,
                                           void* stream) {
  return trw::kge::run(*c, true, (cudaStream_t)stream);
}
