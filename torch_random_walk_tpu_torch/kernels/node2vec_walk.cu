// K2: node2vec p/q-biased CSR random walks, one thread per walker, each
// running its own round loop.  One kernel, a template flag for the sampler.
//
// Replaces two XLA hot loops of the JAX package, neither of them Pallas:
//   MIXTURE == false  ops/node2vec.py::node2vec_walk_csr (rejection sampler,
//                     float32 draw against prob_0/1/2);
//   MIXTURE == true   ops/node2vec.py::node2vec_walk_csr_mixture, the oracle
//                     of ops/fatwalk.py::_node2vec_freerun(sampler="mixture")
//                     (integer quotient draw with an exact point mass at t).
// The JAX versions run rounds in lock step over the whole frontier and keep
// each walker's first accepted candidate; a walker's draws depend only on
// (key, wid, step, round), so a private loop that stops at the first accepted
// round gives the same walk.
//
// Bound on this card: bytes, and latency before bytes.  A round is a chain of
// dependent random reads: the candidate's col word, then a binary search over
// t's sorted row.  Trip counts differ per walker, so warps diverge; the
// design accepts that and keeps many independent walkers in flight.  The
// multiplicity of t in v's row (mixture) is found once per step, not once per
// round.

#include <cstdint>
#include <cuda_runtime.h>

#include "csr.cuh"

namespace trw {

struct BiasedParams {
  // rejection: float32 acceptance thresholds (ops/common.py::
  // node2vec_accept_probs, rounded to float32 as JAX bakes them).
  float prob_0, prob_1, prob_2;
  // mixture: integer weights of ops/fatwalk.py::_mixture_consts.
  uint32_t mi, ei, wt_i, w1_i, w2_i;
  int32_t search_iters;
  int32_t max_rounds;
};

template <bool MIXTURE>
__global__ void node2vec_walk_csr_kernel(Csr g, const int32_t* __restrict__ targets,
                                         int32_t* __restrict__ walks,
                                         uint8_t* __restrict__ exhausted,
                                         int32_t num_walkers, int32_t walk_length,
                                         uint32_t k0, uint32_t k1,
                                         uint32_t walker_offset, BiasedParams prm) {
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= num_walkers) return;
  uint32_t wid = (uint32_t)tid + walker_offset;
  int32_t* out = walks + tid * ((int64_t)walk_length + 1);
  const bool has_edges = g.num_edges > 0;

  int32_t t = targets[tid];
  out[0] = t;
  // First hop: a plain uniform draw at (step 1, round 0).
  int32_t v = t;
  if (has_edges) {
    uint32_t bits = threefry2x32(k0, k1, wid, step_round_counter(1, 0)).x0;
    if (MIXTURE) {
      Row r = row_of(g, t);
      uint32_t deg = r.deg();
      uint32_t pos = randint(bits, max(prm.mi * deg, 1u));
      if (deg > 0) v = col_at(g, r.start + (int64_t)(int32_t)(pos / prm.mi));
    } else {
      v = sample_neighbor(g, t, bits);
    }
  }
  out[1] = v;  // walk_length >= 1 is checked by the wrapper

  bool any_exhausted = false;
  for (int32_t s = 2; s <= walk_length; ++s) {
    int32_t sel = v;
    bool resolved = !has_edges;
    if (has_edges) {
      Row rv = row_of(g, v);
      uint32_t deg = rv.deg();
      uint32_t g_spike = 0, g_total = 0;
      if (MIXTURE) {
        uint32_t mult = (uint32_t)(bound(g, rv.start, rv.end, t, true, prm.search_iters) -
                                   bound(g, rv.start, rv.end, t, false, prm.search_iters));
        mult = min(mult, 0xFFFFu);
        g_spike = prm.ei * mult;
        g_total = prm.mi * deg + g_spike;
      }
      for (int32_t rnd = 0; rnd < prm.max_rounds; ++rnd) {
        U32x2 b = threefry2x32(k0, k1, wid, step_round_counter(s, (uint32_t)rnd));
        int32_t cand;
        bool accept;
        if (MIXTURE) {
          uint32_t pos = randint(b.x0, max(g_total, 1u));
          bool dead = deg == 0;
          bool spike = pos < g_spike && !dead;
          if (dead) {
            cand = v;
            accept = true;
          } else if (spike) {
            cand = t;
            accept = true;
          } else {
            uint32_t base = pos - g_spike;
            uint32_t sub = base % prm.mi;
            cand = col_at(g, rv.start + (int64_t)(int32_t)(base / prm.mi));
            uint32_t thr = cand == t ? prm.wt_i
                           : (is_neighbor(g, cand, t, prm.search_iters) ? prm.w1_i
                                                                        : prm.w2_i);
            accept = sub < thr;
          }
        } else {
          cand = deg > 0 ? col_at(g, rv.start + (int64_t)randint(b.x0, deg)) : v;
          float r = uniform24(b.x1);
          float thr = cand == t ? prm.prob_0
                      : (is_neighbor(g, cand, t, prm.search_iters) ? prm.prob_1
                                                                   : prm.prob_2);
          accept = r < thr;
        }
        if (accept) {
          sel = cand;
          resolved = true;
          break;
        }
      }
    }
    // Round budget spent: the walker keeps v, as the JAX oracles do, and is
    // reported so that the graph entry point can mark the walk incomplete.
    any_exhausted |= !resolved;
    out[s] = sel;
    t = v;
    v = sel;
  }
  exhausted[tid] = any_exhausted ? 1 : 0;
}

}  // namespace trw

extern "C" int trw_node2vec_walk_csr(const int32_t* row_ptr, const int32_t* col_idx,
                                     int32_t num_nodes, int64_t num_edges,
                                     const int32_t* targets, int32_t* walks,
                                     uint8_t* exhausted, int32_t num_walkers,
                                     int32_t walk_length, uint32_t k0, uint32_t k1,
                                     uint32_t walker_offset, int32_t mixture,
                                     float prob_0, float prob_1, float prob_2,
                                     uint32_t mi, uint32_t ei, uint32_t wt_i,
                                     uint32_t w1_i, uint32_t w2_i,
                                     int32_t search_iters, int32_t max_rounds,
                                     void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((num_walkers + threads - 1) / threads);
  trw::Csr g{row_ptr, col_idx, num_nodes, num_edges};
  trw::BiasedParams prm{prob_0, prob_1, prob_2, mi, ei, wt_i, w1_i, w2_i,
                        search_iters, max_rounds};
  cudaStream_t st = (cudaStream_t)stream;
  if (mixture) {
    trw::node2vec_walk_csr_kernel<true><<<blocks, threads, 0, st>>>(
        g, targets, walks, exhausted, num_walkers, walk_length, k0, k1,
        walker_offset, prm);
  } else {
    trw::node2vec_walk_csr_kernel<false><<<blocks, threads, 0, st>>>(
        g, targets, walks, exhausted, num_walkers, walk_length, k0, k1,
        walker_offset, prm);
  }
  return (int)cudaGetLastError();
}
