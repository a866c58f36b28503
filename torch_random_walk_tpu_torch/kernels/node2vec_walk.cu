// K2: node2vec p/q-biased CSR random walks, one thread per walker, each lane
// running free through its own walk.  One kernel, a template flag for the
// sampler.
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
// Bound on this card: chains of dependent random reads, and the load slots
// they take.  A round reads a candidate's col word, then, for some draws,
// binary-searches t's sorted row; a step boundary reads the new v's row
// bounds and, for the mixture, searches v's row for t.  A warp waits for the
// longest chain among its lanes.  At the bench shape (131 072 walkers, all
// resident) a quarter of the walkers still take two thirds of the time: the
// chains, not the bytes, set it (chip_smoke.py's walk_times line).
//
// What the design does about it:
// - Free-running lanes (the structure of ops/fatwalk.py::_node2vec_freerun):
//   one loop per lane, one round (s, rnd) of the lane's own step per
//   iteration.  The lane that accepts (or spends its budget) does the step's
//   boundary work in the same iteration: stores out[s], shifts t <- v <- sel,
//   loads the new v's row bounds and, for the mixture, the multiplicity of t
//   in that row.  A warp runs the largest total of rounds over its lanes, not
//   the sum over steps of each step's largest (rounds per step are geometric:
//   3.92 for rejection, 1.97 for the mixture at the bench shape).
// - No search where the draw decides alone: with thresholds {x1, x2} for a
//   neighbour of t or not, a draw below min(x1, x2) accepts and one at or
//   above max(x1, x2) rejects either way (the acceptance band of
//   _node2vec_freerun).  At p = 0.5, q = 2 that skips three quarters of the
//   rejection sampler's searches and half of the mixture's.
// - t's row bounds are v's of the step before, carried in registers, and the
//   search answers from its last probe (csr.cuh::is_neighbor).
// - The multiplicity of t in v's row is one lower-bound search and a scan of
//   at most kScan words; a second search runs only past that.
// - The walk is stored a whole 32-byte sector at a time from eight registers
//   (csr.cuh::RowWriter, shared with K1), which cut both samplers' time by
//   a quarter on the H100.  The likely cause (no counters on the card to
//   show it): single 4-byte stores leave the 42 MB of walks in partly
//   written sectors, which L2 must fill from device memory when it evicts
//   them.
// Measured and not kept (PERF.md): 64 or 256 threads a block (no
// change), staging 16 bytes in shared memory or 64 bytes in registers
// (slower than 32), one load per lane per iteration as a state machine
// (slower: the warp issues every phase's code each iteration), two rejection
// rounds per iteration (no change), candidate reads past L1 (no change).

#include <cstdint>
#include <cuda_runtime.h>

#include "csr.cuh"

namespace trw {

constexpr int kThreads = 128;
constexpr int64_t kScan = 4;

struct BiasedParams {
  // rejection: float32 acceptance thresholds (ops/common.py::
  // node2vec_accept_probs, rounded to float32 as JAX bakes them).
  float prob_0, prob_1, prob_2;
  // mixture: integer weights of ops/fatwalk.py::_mixture_consts.
  uint32_t mi, ei, wt_i, w1_i, w2_i;
  int32_t search_iters;
  int32_t max_rounds;
};

// The mixture's integer masses of one step: the point mass at t and the
// row's total.
struct StepMass {
  uint32_t spike, total;
};

// Multiplicity of t in v's row, as ops/node2vec.py::_count_in_row gives it
// (upper minus lower bound, both by `iters` halvings), clamped to 16 bits.
__device__ __forceinline__ uint32_t multiplicity(const Csr& g, Row rv,
                                                 int32_t t, int iters) {
  int64_t lo = bound(g, rv.start, rv.end, t, false, iters);
  uint32_t deg = rv.deg();
  bool converged = iters >= 32 || (iters >= 0 && (deg >> iters) == 0);
  int64_t hi;
  if (converged) {
    // lo is t's first index: count the run forward, and search on only
    // past kScan (upper bounds of [lo, end) and of the row are one index).
    hi = lo;
    int64_t stop = min(rv.end, lo + kScan);
    while (hi < stop && col_at(g, hi) == t) ++hi;
    if (hi == lo + kScan && hi < rv.end && col_at(g, hi) == t)
      hi = bound(g, hi, rv.end, t, true, iters);
  } else {
    hi = bound(g, rv.start, rv.end, t, true, iters);
  }
  return min((uint32_t)(hi - lo), 0xFFFFu);
}

template <bool MIXTURE>
__device__ __forceinline__ StepMass step_mass(const Csr& g, Row rv, int32_t t,
                                              const BiasedParams& prm) {
  if (!MIXTURE) return {0, 0};
  uint32_t spike = prm.ei * multiplicity(g, rv, t, prm.search_iters);
  return {spike, prm.mi * rv.deg() + spike};
}

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

  RowWriter w{out, (int32_t)(((uintptr_t)out >> 2) & 7), walk_length, {}};
  int32_t t = targets[tid];
  if (g.num_edges == 0) {  // no edges: every walker stays in place
    for (int32_t s = 0; s <= walk_length; ++s) out[s] = t;
    exhausted[tid] = 0;
    return;
  }
  w.put(0, t);
  // First hop: a plain uniform draw at (step 1, round 0).
  Row rt = row_of(g, t);
  int32_t v = t;
  {
    uint32_t bits = threefry2x32(k0, k1, wid, step_round_counter(1, 0)).x0;
    uint32_t deg = rt.deg();
    if (MIXTURE) {
      uint32_t pos = randint(bits, max(prm.mi * deg, 1u));
      if (deg > 0) v = col_at(g, rt.start + (int64_t)(int32_t)(pos / prm.mi));
    } else if (deg > 0) {
      v = col_at(g, rt.start + (int64_t)randint(bits, deg));
    }
  }
  w.put(1, v);  // walk_length >= 1 is checked by the wrapper

  // Thresholds for a candidate other than t: neighbour of t or not.
  const float p_lo = fminf(prm.prob_1, prm.prob_2);
  const float p_hi = fmaxf(prm.prob_1, prm.prob_2);
  const uint32_t w_lo = min(prm.w1_i, prm.w2_i);
  const uint32_t w_hi = max(prm.w1_i, prm.w2_i);

  Row rv = row_of(g, v);
  StepMass mass = step_mass<MIXTURE>(g, rv, t, prm);
  bool any_exhausted = false;
  int32_t s = 2, rnd = 0;
  while (s <= walk_length) {
    U32x2 b = threefry2x32(k0, k1, wid, step_round_counter(s, (uint32_t)rnd));
    uint32_t deg = rv.deg();
    int32_t cand;
    bool accept;
    if (MIXTURE) {
      uint32_t pos = randint(b.x0, max(mass.total, 1u));
      if (deg == 0) {
        cand = v;
        accept = true;
      } else if (pos < mass.spike) {
        cand = t;
        accept = true;
      } else {
        uint32_t base = pos - mass.spike;
        uint32_t sub = base % prm.mi;
        cand = col_at(g, rv.start + (int64_t)(int32_t)(base / prm.mi));
        if (cand == t) accept = sub < prm.wt_i;
        else if (sub < w_lo) accept = true;
        else if (sub >= w_hi) accept = false;
        else accept = sub < (is_neighbor(g, rt, cand, prm.search_iters) ? prm.w1_i
                                                                        : prm.w2_i);
      }
    } else {
      cand = deg > 0 ? col_at(g, rv.start + (int64_t)randint(b.x0, deg)) : v;
      float r = uniform24(b.x1);
      if (cand == t) accept = r < prm.prob_0;
      else if (r < p_lo) accept = true;
      else if (r >= p_hi) accept = false;
      else accept = r < (is_neighbor(g, rt, cand, prm.search_iters) ? prm.prob_1
                                                                    : prm.prob_2);
    }
    accept = accept && rnd < prm.max_rounds;
    if (accept || rnd + 1 >= prm.max_rounds) {
      // Step boundary.  Round budget spent: the walker keeps v, as the JAX
      // oracles do, and is reported so that the graph entry point can mark
      // the walk incomplete.
      any_exhausted |= !accept;
      int32_t sel = accept ? cand : v;
      w.put(s, sel);
      t = v;
      rt = rv;
      v = sel;
      rnd = 0;
      if (++s <= walk_length) {
        rv = row_of(g, v);
        mass = step_mass<MIXTURE>(g, rv, t, prm);
      }
    } else {
      ++rnd;
    }
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
  const int threads = trw::kThreads;
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

// Launch geometry of K2: out[0] = threads per block (those of the launch
// above when `threads` <= 0), out[1] = blocks of that size resident on one
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int trw_node2vec_walk_geometry(int32_t mixture, int32_t threads,
                                          int32_t* out) {
  int n = threads > 0 ? threads : trw::kThreads;
  int blocks = 0;
  cudaError_t err =
      mixture ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, trw::node2vec_walk_csr_kernel<true>, n, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, trw::node2vec_walk_csr_kernel<false>, n, 0);
  out[0] = n;
  out[1] = blocks;
  return (int)err;
}
