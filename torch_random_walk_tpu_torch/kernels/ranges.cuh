// Access to an (N, 2) [start, end-inclusive] range index, (-1, -1) for a
// node without out-edges, as the edge-list kernels (K7, K8) and the triples
// walk (K9) read it (K7 on packed rows and K9 on triple_tab under the fat
// semantics only for the target).  All index arithmetic is done in 64 bits; ids are int32.
#pragma once

#include <cstdint>

#include "threefry.cuh"

namespace trw {

struct RangeIndex {
  const int2* __restrict__ index;  // (num_nodes, 2); num_nodes >= 1
  int32_t num_nodes;
};

// One node's range as ops/common.py::edge_ranges and sample_range_inclusive
// read it: the ends clamped at 0, end exclusive, and whether the row is a
// real range (both ends >= 0).
struct Range {
  int64_t start;
  int64_t end;  // exclusive: max(end-inclusive, 0) + 1
  bool has;
  // The draw's bound: end - start + 1 of the clamped ends, at least 1.
  __device__ __forceinline__ uint32_t cnt() const {
    int64_t n = end - start;
    return n < 1 ? 1u : (uint32_t)n;
  }
};

// Range of node v; an id outside [0, num_nodes) is clamped, as the JAX
// gathers clamp it.
__device__ __forceinline__ Range range_of(const RangeIndex& g, int32_t v) {
  int32_t c = min(max(v, 0), g.num_nodes - 1);
  int2 r = g.index[c];
  return {(int64_t)max(r.x, 0), (int64_t)max(r.y, 0) + 1,
          r.x >= 0 && r.y >= 0};
}

// Uniform index in the range drawn from `bits`
// (ops/common.py::sample_range_inclusive), clamped into [0, rows).
__device__ __forceinline__ int64_t draw_in(const Range& r, uint32_t bits,
                                           int64_t rows) {
  int64_t i = r.start + (int64_t)randint(bits, r.cnt());
  return min(max(i, (int64_t)0), rows - 1);
}

}  // namespace trw
