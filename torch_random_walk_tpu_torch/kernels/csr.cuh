// CSR row access and the walk-row writer shared by the walk kernels.  row_ptr
// and col_idx are int32 (graphs below 2^31 edges); all index arithmetic is
// done in 64 bits.
#pragma once

#include <cstdint>

#include "threefry.cuh"

namespace trw {

struct Csr {
  const int32_t* __restrict__ row_ptr;  // (num_nodes + 1,)
  const int32_t* __restrict__ col_idx;  // (num_edges,), sorted within rows
  int32_t num_nodes;
  int64_t num_edges;
};

struct Row {
  int64_t start;
  int64_t end;
  __device__ __forceinline__ uint32_t deg() const {
    return (uint32_t)(end - start);
  }
};

// Row of node v.  An id outside [0, num_nodes) is clamped, as the JAX
// package's gathers clamp it, so that a bad target cannot read out of bounds.
__device__ __forceinline__ Row row_of(const Csr& g, int32_t v) {
  int32_t c = min(max(v, 0), g.num_nodes - 1);
  return {(int64_t)g.row_ptr[c], (int64_t)g.row_ptr[c + 1]};
}

__device__ __forceinline__ int32_t col_at(const Csr& g, int64_t idx) {
  idx = min(max(idx, (int64_t)0), g.num_edges - 1);
  return g.col_idx[idx];
}

// Uniform out-neighbour of cur drawn from `bits`; a dead end stays at cur
// (ops/common.py::sample_csr_neighbor).
__device__ __forceinline__ int32_t sample_neighbor(const Csr& g, int32_t cur,
                                                   uint32_t bits) {
  Row r = row_of(g, cur);
  uint32_t deg = r.deg();
  if (deg == 0) return cur;
  return col_at(g, r.start + (int64_t)randint(bits, deg));
}

// First index in [lo, hi) whose value is >= x (strict == false) or > x
// (strict == true), by at most `iters` halvings: the fixed-trip-count search
// of ops/common.py::is_neighbor_csr and ops/node2vec.py::_count_in_row,
// which is idle once lo == hi, so leaving the loop early gives the same
// index.
__device__ __forceinline__ int64_t bound(const Csr& g, int64_t lo, int64_t hi,
                                         int32_t x, bool strict, int iters) {
  for (int it = 0; it < iters && lo < hi; ++it) {
    int64_t mid = (lo + hi) >> 1;
    int32_t val = col_at(g, mid);
    bool go_right = strict ? (val <= x) : (val < x);
    if (go_right) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Is cand an out-neighbour of t, whose row `rt` the caller holds?  The search
// is bound(g, rt.start, rt.end, cand, false, iters), answered as
// ops/common.py::is_neighbor_csr answers it: lo < end && col[lo] == cand.
// Where the search converges, the last probe that moved hi read col[lo], so
// no further load is needed; only a search cut short by `iters` reads it.
__device__ __forceinline__ bool is_neighbor(const Csr& g, Row rt, int32_t cand,
                                            int iters) {
  int64_t lo = rt.start, hi = rt.end;
  bool hit = false;
  for (int it = 0; it < iters && lo < hi; ++it) {
    int64_t mid = (lo + hi) >> 1;
    int32_t val = col_at(g, mid);
    if (val < cand) {
      lo = mid + 1;
    } else {
      hi = mid;
      hit = val == cand;
    }
  }
  return lo < hi ? col_at(g, lo) == cand : hit;
}

// A lane's walk positions, held in registers and stored a 32-byte sector at a
// time where the row's alignment allows (scalar stores at its ragged ends):
// a sector written whole needs no fill from device memory when L2 evicts it.
// put(s, v) is called once for each s = 0..last, in order.  K1 and K2 share
// it.
struct RowWriter {
  int32_t* out;
  int32_t align;  // word offset of out[0] within its sector
  int32_t last;
  int32_t r[8];   // r[7] is the newest position
  __device__ __forceinline__ void put(int32_t s, int32_t val) {
#pragma unroll
    for (int k = 0; k < 7; ++k) r[k] = r[k + 1];
    r[7] = val;
    int32_t slot = (align + s) & 7;
    if (slot == 7 || s == last) {
      int32_t first = s - slot;
      if (slot == 7 && first >= 0) {
        int4* dst = reinterpret_cast<int4*>(out + first);
        dst[0] = make_int4(r[0], r[1], r[2], r[3]);
        dst[1] = make_int4(r[4], r[5], r[6], r[7]);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          int32_t p = s - 7 + k;
          if (p >= max(first, 0)) out[p] = r[k];
        }
      }
    }
  }
};

}  // namespace trw
