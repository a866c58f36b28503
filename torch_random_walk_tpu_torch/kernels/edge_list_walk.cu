// K7 and K8: edge-list random walks with padding/restart semantics, one
// thread per walker.
//
// Replace two XLA programs of the JAX package, neither of them Pallas:
//   K7  ops/fatwalk.py::uniform_walk_edge_list_fat (oracle
//       ops/edge_list_walk.py::uniform_walk_edge_list; the two agree value
//       for value, so one kernel serves both entry points);
//   K8  ops/fatwalk.py::node2vec_walk_edge_list_freerun, reached through
//       node2vec_walk_edge_list_fat (FAT == true), and its oracle
//       ops/edge_list_walk.py::biased_walk_edge_list (FAT == false).  The
//       two differ only in the membership test: the fat engine's cuckoo
//       edge set looks t up by its own id, the oracle clamps t into
//       [0, N) and never counts t == padding.
// For walker w at node cur and step s, bits = threefry(key, wid, s << 16 |
// round):
//   cur == padding      -> its jump node (the target if restart, else
//                          padding)
//   cur has no edges    -> padding
//   else                -> edges[start(cur) + mulhi(bits, cnt(cur))].tail
// K8 draws candidates that way and accepts a candidate equal to t or to
// padding with prob_0 (a padding candidate then moves to the jump node), a
// neighbour of t with prob_1, any other with prob_2.
//
// Bound on this card: chains of dependent random reads, as K1's and K2's:
// each step's read depends on the last.  K8's step reads cur's 8-byte range,
// then one tail that depends on it, and adds, for the rounds whose draw
// falls between the two thresholds, a binary search over t's tails.  K7 on a
// graph reads one 8-byte packed edge row a step, which holds the next node
// and its range, so its chain is one load a step (K1's is two); on raw
// arrays it reads the range, then column 1 of the edge rows.
//
// What the design does about it (K1's and K2's structure):
// - one thread per walker, free-running: K8's lane runs one round of its own
//   step per iteration and does the step boundary (store, t <- v <- sel, the
//   new v's range) in the accepting iteration;
// - K7 on a graph reads the JAX fat engine's packed rows (EdgeListGraph.
//   edge_tab: (tail, start_tail, cnt_tail) in two words, unpacked by shifts
//   of the layout's field widths) and the index only for the target; a graph
//   without them (the layout does not fit, or no fat tables) reads its tails
//   column and the index;
// - the range as one aligned 8-byte load (the index is (N, 2) int32);
// - K8 reads its draws' tails and its searches' probes from the graph's
//   (E,) int32 tails column (EdgeListGraph.tails; the raw-array entry makes
//   it per call), K2's layout: a 32-byte sector holds 8 tails, where the
//   8-byte [head, tail] rows hold 4, so the last probes of a search touch
//   half the sectors and L2 holds twice the tails;
// - no search where the draw decides alone (below min(prob_1, prob_2) it
//   accepts, at or above the max it rejects either way), and the search
//   answers from its last probe;
// - the walk stored a whole 32-byte sector at a time from registers
//   (csr.cuh::RowWriter).
// On the H100 at the bench shape (PERF.md §6): the tails column took K8 from
// 1.63 to 1.34 ms; the packed rows took K7's graph entry from 0.49 to 0.34
// ms, below K1's 0.40.  Measured and not kept: for K7 on a graph with packed
// rows, the tails column and the index (0.45 ms: the index read is a second
// link of the chain, though the 16 MB index mostly hits L2), 16-byte
// unpacked [tail, start, cnt, 0] rows (0.37 ms: twice the table's bytes, 40
// registers), and on raw arrays a tails column copied per call (the copy
// alone costs more than the gain);
// for K8, L2::evict_last loads of the range index (no change, and the
// priority would outlive the launch).

#include <cstdint>
#include <cuda_runtime.h>

#include "csr.cuh"
#include "ranges.cuh"

namespace trw {

constexpr int kEdgeThreads = 128;

// An edge list as its range index and its tails: K7 reads them as column 1
// of the (E, 2) [head, tail] rows (STRIDE 2), K8 from the graph's (E,) tails
// column (STRIDE 1), which packs twice the tails into a sector.
template <int STRIDE>
struct EdgeList {
  RangeIndex idx;
  const int32_t* __restrict__ tails;  // tail of edge i at tails[STRIDE * i]
  int64_t num_edges;
};

// Tail of edge i, clamped into the edge list (0 for an empty list, whose
// lanes the callers mask, as ops/common.py::gather_rows does).
template <int S>
__device__ __forceinline__ int32_t tail_at(const EdgeList<S>& g, int64_t i) {
  if (g.num_edges == 0) return 0;
  i = min(max(i, (int64_t)0), g.num_edges - 1);
  return g.tails[S * i];
}

// One draw from node `cur`, whose range `r` the caller holds
// (ops/common.py::sample_edge_neighbor).
template <int S>
__device__ __forceinline__ int32_t edge_step(const EdgeList<S>& g, int32_t cur,
                                             const Range& r, int32_t jump,
                                             int32_t pad, uint32_t bits) {
  if (cur == pad) return jump;
  if (!r.has) return pad;
  return tail_at(g, draw_in(r, bits, max(g.num_edges, (int64_t)1)));
}

// Does the node whose range is `rt` have an edge to cand?  The fixed-trip
// lower-bound search of ops/common.py::is_neighbor_edge over the tails of
// [start, end), answered as csr.cuh::is_neighbor answers it.  A range
// without edges (or a t the caller ruled out) answers false.
template <int S>
__device__ __forceinline__ bool is_neighbor_edge(const EdgeList<S>& g,
                                                 const Range& rt, int32_t cand,
                                                 int iters) {
  if (!rt.has) return false;
  int64_t lo = rt.start, hi = rt.end;
  bool hit = false;
  for (int it = 0; it < iters && lo < hi; ++it) {
    int64_t mid = (lo + hi) >> 1;
    int32_t val = tail_at(g, mid);
    if (val < cand) {
      lo = mid + 1;
    } else {
      hi = mid;
      hit = val == cand;
    }
  }
  if (lo >= rt.end) return false;
  return lo < hi ? tail_at(g, lo) == cand : hit;
}

// K7 on raw arrays (STRIDE 2: the (E, 2) [head, tail] rows) or on a graph
// without packed rows (STRIDE 1: its tails column): a step reads cur's
// range from the index, then one tail.
template <int S>
__global__ void __launch_bounds__(kEdgeThreads) uniform_walk_edge_list_kernel(
    EdgeList<S> g, const int32_t* __restrict__ targets, int32_t* __restrict__ walks,
    int32_t num_walkers, int32_t walk_length, uint32_t k0, uint32_t k1,
    uint32_t walker_offset, int32_t pad, int32_t restart) {
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= num_walkers) return;
  uint32_t wid = (uint32_t)tid + walker_offset;
  int32_t* out = walks + tid * ((int64_t)walk_length + 1);
  RowWriter w{out, (int32_t)(((uintptr_t)out >> 2) & 7), walk_length, {}};
  int32_t cur = targets[tid];
  const int32_t jump = restart ? cur : pad;
  w.put(0, cur);
  for (int32_t s = 1; s <= walk_length; ++s) {
    if (cur == pad) {
      cur = jump;
    } else {
      Range r = range_of(g.idx, cur);
      uint32_t bits = threefry2x32(k0, k1, wid, step_round_counter(s, 0)).x0;
      cur = edge_step(g, cur, r, jump, pad, bits);
    }
    w.put(s, cur);
  }
}

// A walker's node and the range it draws its next edge from (cnt 0: the
// node has no out-edges), as the JAX fat engine carries them.
struct Hop {
  int32_t node;
  int64_t start;
  uint32_t cnt;
};

// The graph's packed edge rows, which carry the next node's range: the JAX
// package's (E, 2) uint32 layout, fields of node_bits, start_bits and
// deg_bits from bit 0 up, each below 32 bits.
struct EdgeRows {
  const uint2* __restrict__ rows;
  int64_t num_edges;  // >= 1
  uint32_t node_bits, start_bits, deg_bits;
};

__device__ __forceinline__ Hop hop_at(const EdgeRows& t, int64_t e) {
  uint2 wd = t.rows[e];
  uint64_t v = (uint64_t)wd.x | ((uint64_t)wd.y << 32);
  uint32_t node = (uint32_t)v & ((1u << t.node_bits) - 1u);
  v >>= t.node_bits;
  uint32_t start = (uint32_t)v & ((1u << t.start_bits) - 1u);
  v >>= t.start_bits;
  return {(int32_t)node, (int64_t)start,
          (uint32_t)v & ((1u << t.deg_bits) - 1u)};
}

// K7 on a graph's packed rows: one gather a step, which gives the next node
// and its range (ops/fatwalk.py::uniform_walk_edge_list_fat); the index is
// read once, for the target's range.
__global__ void __launch_bounds__(kEdgeThreads) uniform_walk_edge_rows_kernel(
    RangeIndex idx, EdgeRows t, const int32_t* __restrict__ targets,
    int32_t* __restrict__ walks, int32_t num_walkers, int32_t walk_length,
    uint32_t k0, uint32_t k1, uint32_t walker_offset, int32_t pad,
    int32_t restart) {
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= num_walkers) return;
  uint32_t wid = (uint32_t)tid + walker_offset;
  int32_t* out = walks + tid * ((int64_t)walk_length + 1);
  RowWriter w{out, (int32_t)(((uintptr_t)out >> 2) & 7), walk_length, {}};
  const int32_t target = targets[tid];
  const Range r = range_of(idx, target);
  Hop h{target, r.start, r.has ? r.cnt() : 0u};
  const Hop jump = restart ? h : Hop{pad, 0, 0u};
  w.put(0, target);
  for (int32_t s = 1; s <= walk_length; ++s) {
    if (h.node == pad) {
      h = jump;
    } else if (h.cnt == 0) {
      h = Hop{pad, 0, 0u};
    } else {
      uint32_t bits = threefry2x32(k0, k1, wid, step_round_counter(s, 0)).x0;
      int64_t e = h.start + (int64_t)randint(bits, h.cnt);
      h = hop_at(t, min(max(e, (int64_t)0), t.num_edges - 1));
    }
    w.put(s, h.node);
  }
}

struct EdgeBiasedParams {
  // ops/common.py::node2vec_accept_probs, rounded to float32.
  float prob_0, prob_1, prob_2;
  int32_t search_iters;
  int32_t max_rounds;
  int32_t pad;
  int32_t restart;
};

// t's range for the membership test, or none: the fat engine's edge set
// knows t only for 0 <= t < N; the oracle rules out t == padding.
template <bool FAT, int S>
__device__ __forceinline__ Range member_range(const EdgeList<S>& g, int32_t t,
                                              Range rt, int32_t pad) {
  bool valid = FAT ? (uint32_t)t < (uint32_t)g.idx.num_nodes : t != pad;
  rt.has = rt.has && valid;
  return rt;
}

template <bool FAT>
__global__ void __launch_bounds__(kEdgeThreads) biased_walk_edge_list_kernel(
    EdgeList<1> g, const int32_t* __restrict__ targets, int32_t* __restrict__ walks,
    uint8_t* __restrict__ exhausted, int32_t num_walkers, int32_t walk_length,
    uint32_t k0, uint32_t k1, uint32_t walker_offset, EdgeBiasedParams prm) {
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= num_walkers) return;
  uint32_t wid = (uint32_t)tid + walker_offset;
  int32_t* out = walks + tid * ((int64_t)walk_length + 1);
  RowWriter w{out, (int32_t)(((uintptr_t)out >> 2) & 7), walk_length, {}};
  const int32_t pad = prm.pad;
  int32_t t = targets[tid];
  const int32_t jump = prm.restart ? t : pad;
  w.put(0, t);
  // First hop: a plain draw at (step 1, round 0).
  Range rt = range_of(g.idx, t);
  int32_t v = edge_step(
      g, t, rt, jump, pad,
      threefry2x32(k0, k1, wid, step_round_counter(1, 0)).x0);
  w.put(1, v);  // walk_length >= 1 is checked by the wrapper

  const float p_lo = fminf(prm.prob_1, prm.prob_2);
  const float p_hi = fmaxf(prm.prob_1, prm.prob_2);
  Range mt = member_range<FAT>(g, t, rt, pad);
  Range rv = range_of(g.idx, v);
  bool any_exhausted = false;
  int32_t s = 2, rnd = 0;
  while (s <= walk_length) {
    U32x2 b = threefry2x32(k0, k1, wid, step_round_counter(s, (uint32_t)rnd));
    int32_t cand = edge_step(g, v, rv, jump, pad, b.x0);
    float r = uniform24(b.x1);
    bool accept;
    if (cand == t || cand == pad) accept = r < prm.prob_0;
    else if (r < p_lo) accept = true;
    else if (r >= p_hi) accept = false;
    else accept = r < (is_neighbor_edge(g, mt, cand, prm.search_iters)
                           ? prm.prob_1 : prm.prob_2);
    accept = accept && rnd < prm.max_rounds;
    if (accept || rnd + 1 >= prm.max_rounds) {
      // Step boundary.  Round budget spent: the walker keeps v, as the JAX
      // oracle does, and is reported, so that the graph entry point can
      // mark the walk incomplete.
      any_exhausted |= !accept;
      int32_t sel = !accept ? v : (cand == pad && cand != t) ? jump : cand;
      w.put(s, sel);
      t = v;
      mt = member_range<FAT>(g, t, rv, pad);
      v = sel;
      rnd = 0;
      if (++s <= walk_length) rv = range_of(g.idx, v);
    } else {
      ++rnd;
    }
  }
  exhausted[tid] = any_exhausted ? 1 : 0;
}

}  // namespace trw

// K7's tables, by `layout`: 0 the raw (E, 2) [head, tail] rows, 1 the (E,)
// tails column (both with the range index), 2 the packed (E, 2) rows with
// their three bit widths.
extern "C" int trw_uniform_walk_edge_list(
    const int32_t* index, const int32_t* table, int32_t layout,
    int32_t num_nodes, int64_t num_edges, uint32_t node_bits,
    uint32_t start_bits, uint32_t deg_bits, const int32_t* targets,
    int32_t* walks, int32_t num_walkers, int32_t walk_length, uint32_t k0,
    uint32_t k1, uint32_t walker_offset, int32_t pad, int32_t restart,
    void* stream) {
  const int threads = trw::kEdgeThreads;
  const unsigned blocks = (unsigned)((num_walkers + threads - 1) / threads);
  const trw::RangeIndex idx{reinterpret_cast<const int2*>(index), num_nodes};
  const trw::EdgeRows rows{reinterpret_cast<const uint2*>(table), num_edges,
                           node_bits, start_bits, deg_bits};
  cudaStream_t st = (cudaStream_t)stream;
  switch (layout) {
    case 0:
      trw::uniform_walk_edge_list_kernel<2><<<blocks, threads, 0, st>>>(
          trw::EdgeList<2>{idx, table + 1, num_edges}, targets, walks,
          num_walkers, walk_length, k0, k1, walker_offset, pad, restart);
      break;
    case 1:
      trw::uniform_walk_edge_list_kernel<1><<<blocks, threads, 0, st>>>(
          trw::EdgeList<1>{idx, table, num_edges}, targets, walks,
          num_walkers, walk_length, k0, k1, walker_offset, pad, restart);
      break;
    case 2:
      trw::uniform_walk_edge_rows_kernel<<<blocks, threads, 0, st>>>(
          idx, rows, targets, walks, num_walkers, walk_length, k0, k1,
          walker_offset, pad, restart);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int trw_biased_walk_edge_list(
    const int32_t* index, const int32_t* tails, int32_t num_nodes,
    int64_t num_edges, const int32_t* targets, int32_t* walks,
    uint8_t* exhausted, int32_t num_walkers, int32_t walk_length, uint32_t k0,
    uint32_t k1, uint32_t walker_offset, int32_t pad, int32_t restart,
    int32_t fat, float prob_0, float prob_1, float prob_2,
    int32_t search_iters, int32_t max_rounds, void* stream) {
  const int threads = trw::kEdgeThreads;
  const unsigned blocks = (unsigned)((num_walkers + threads - 1) / threads);
  trw::EdgeList<1> g{{reinterpret_cast<const int2*>(index), num_nodes}, tails,
                     num_edges};
  trw::EdgeBiasedParams prm{prob_0, prob_1, prob_2, search_iters, max_rounds,
                            pad, restart};
  cudaStream_t st = (cudaStream_t)stream;
  if (fat) {
    trw::biased_walk_edge_list_kernel<true><<<blocks, threads, 0, st>>>(
        g, targets, walks, exhausted, num_walkers, walk_length, k0, k1,
        walker_offset, prm);
  } else {
    trw::biased_walk_edge_list_kernel<false><<<blocks, threads, 0, st>>>(
        g, targets, walks, exhausted, num_walkers, walk_length, k0, k1,
        walker_offset, prm);
  }
  return (int)cudaGetLastError();
}
