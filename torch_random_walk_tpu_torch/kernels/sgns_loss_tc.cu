// K5 and K6 for bfloat16 tables on Hopper's tensor cores (mma.sync
// m16n8k16, bf16 in, float32 accumulate).  The function is the one the
// header of sgns_loss.cu states; this file is its build for bfloat16 tables,
// the trainer's type.  float32 tables keep the CUDA-core loops there.
//
// Tiles.  A block is persistent and takes tiles blockIdx.x, + gridDim.x, ...
// A tile is up to `rows` center rows (128 for D <= 128) made of whole walks:
// wpt walks of C centers each (9 at C = 13).  A walk with more centers than
// fit is cut into tiles of nc centers, each with the 2*hw context rows on
// either side.  So a walk's positive pairs and its du rows stay inside one
// tile; a do row is complete in one tile unless the walk is cut.
//
// Shared memory.  The chunk's negative rows Vn are staged once per launch,
// and each tile's center rows U (from in_emb) and walk rows O (from out_emb)
// go through a ring of two stages by cp.async (16, 8 or 4 bytes a copy,
// as the row width and the tables' alignment allow; 2-byte rows are copied
// by plain loads).  Row strides are an odd number of 16-byte units, so the
// eight rows an ldmatrix phase reads fall in eight distinct bank groups; D
// is padded with zeros to the MMA depth of 16.
//
// K5 (16 warps): two warps hold 16 center rows and each walks half of the S
// negatives, 16 at a time: the logits x = U Vn^T stay in the accumulator
// registers, where log sigmoid(-x) is taken, masked and summed.  The
// positive pairs (2*hw dot products a center) run on the CUDA cores from the
// staged rows, one thread a pair.  Per-tile sums go into partial[tile] in a
// fixed order; reduce_partials_kernel adds them in float64, so equal inputs
// give equal loss bits.
//
// K6, two kernels in one call:
//   rows pass (walk tiles): recomputes x, forms g = neg_scale * sigmoid(x) in
//     registers, splits it into a bf16 high and low part, and uses the
//     accumulator fragments as the A fragments of du = g Vn (as
//     FlashAttention-2 does for P V): g never goes through shared memory.
//     The positive pairs' dloss/dlogit go through shared memory, are added to
//     du in registers and form do on the CUDA cores.  du and do rows are
//     added to the float32 gradient tables by float4 atomics (float2 or
//     scalar where D is not a multiple of 4).
//   negatives pass (flat tiles of 128 center rows): x^T = Vn U^T with the
//     warp's 16 negatives as A, then dVn += g^T U from the same registers;
//     each warp keeps its 16 x 128 slice of dVn across all of the block's
//     tiles and adds it to the gradient table once.
// The split of g keeps its error near 2^-16 of g: the only operand that is
// not already a bf16 value.  Where a warp's accumulator would exceed 128
// columns (D > 128) the warps split D between them; D > 512 is refused by K6.
//
// Bound on this card at the trainer's shape: bytes (the gathered rows), not
// operations; the 57 GFLOP of K5 take 0.06 ms at the bf16 tensor-core peak.

#include "sgns_loss.cuh"

namespace trw {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;     // K6's rows pass; tiles are sized for it
constexpr int kWarps = kThreads / 32;
constexpr int kFwdThreads = 512;  // K5: two warps a 16-row tile, S split
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kNegThreads = 512;  // K6's negatives pass
constexpr int kNegWarps = kNegThreads / 32;
constexpr int kMaxNT = 16;        // 8-column tiles of a warp's accumulator
constexpr int kORowCap = 160;     // walk rows a stage holds, unless hw needs more
constexpr int kNegTileRows = 128;

// Elements between rows of a staged row of e elements: a multiple of 8 (16
// bytes) and an odd number of 16-byte units.
__host__ __device__ inline int row_stride(int e) {
  int s = round_up(e, 8);
  return (s / 8) % 2 ? s : s + 8;
}

struct Plan {
  LossShape sh;
  int d16, us, os;      // MMA depth; strides of U/Vn and of O rows
  int nwd, rows, dsl;   // K6's warps along D, tile rows, K6's columns a warp
  int nc, wpt, tpw, no; // centers per walk in a tile, walks per tile,
                        // tiles per walk, O rows per walk
  int tiles;
  int stages, vrows, chunk, vec;
  // byte offsets in dynamic shared memory; stage-relative for u..oid
  int vn, stage, stage_bytes, u, o, uid, oid, gp, red, bytes;
};

// --- planning (host) ---------------------------------------------------------

inline int warps_along_d(int d16) {
  return d16 <= 128 ? 1 : d16 <= 256 ? 2 : 4;
}

inline void layout(Plan& p, int kind) {
  int at = 0;
  auto take = [&at](int bytes) {
    int start = at;
    at += round_up(bytes, 16);
    return start;
  };
  p.vn = take(p.vrows * p.us * 2);
  int orows = kind == kNeg ? 0 : p.wpt * p.no;
  int s = 0;
  p.u = s;
  s += round_up(p.rows * p.us * 2, 16);
  p.o = s;
  s += round_up(orows * p.os * 2, 16);
  p.uid = s;
  s += round_up(p.rows * 8, 16);
  p.oid = s;
  s += round_up(orows * 8, 16);
  p.stage_bytes = s;
  p.stage = take(p.stages * s);
  p.gp = take(kind == kRows ? p.wpt * p.nc * 2 * p.sh.hw * 4 : 0);
  p.red = take(kind == kFwd ? kFwdWarps * 4 : 0);
  p.bytes = at;
}

// Walk tiles from a budget of `ro` O rows a stage.
inline bool set_tiles(Plan& p, int ro) {
  const LossShape& sh = p.sh;
  int c = sh.centers, l1 = sh.length1;
  if (c <= p.rows && l1 <= ro) {
    p.nc = c;
    p.wpt = p.rows / c < ro / l1 ? p.rows / c : ro / l1;
    p.tpw = 1;
    p.no = l1;
  } else {
    int nc = ro - 2 * sh.hw;
    nc = nc < p.rows ? nc : p.rows;
    p.nc = nc < c ? nc : c;
    if (p.nc < 1) return false;
    p.wpt = 1;
    p.tpw = (c + p.nc - 1) / p.nc;
    p.no = p.nc + 2 * sh.hw;
  }
  int64_t tiles = p.tpw == 1
                      ? ((int64_t)sh.num_walks + p.wpt - 1) / p.wpt
                      : (int64_t)sh.num_walks * p.tpw;
  if (tiles >= ((int64_t)1 << 31)) return false;
  p.tiles = (int)tiles;
  return true;
}

// The largest chunk of negatives (<= num_neg) the geometry leaves room for.
inline int fit_chunk(Plan p, int kind, int num_neg, int limit) {
  int want = num_neg;
  if (kind == kNeg) {
    int cap = 16 * (kNegWarps / p.nwd);
    want = want < cap ? want : cap;
  }
  p.vrows = 0;
  layout(p, kind);
  int room = (limit - p.bytes) / (p.us * 2) / 16 * 16;
  int chunk = want < room ? want : room;
  return chunk < 1 ? 0 : chunk;
}

inline bool make_plan(Plan& p, const LossShape& sh, int num_neg, int kind,
                      int limit) {
  p = Plan{};
  p.sh = sh;
  if (sh.centers < 1 || sh.dim < 1 || num_neg < 1 || sh.num_walks < 1)
    return false;
  p.d16 = round_up(sh.dim, 16);
  p.us = row_stride(p.d16);
  p.os = row_stride(sh.dim);
  p.nwd = warps_along_d(p.d16);
  p.dsl = round_up((p.d16 + p.nwd - 1) / p.nwd, 8);
  if (kind != kFwd && p.dsl > 8 * kMaxNT) return false;
  int target = round_up(num_neg, 16) < 256 ? round_up(num_neg, 16) : 256;
  if (kind == kNeg) {
    p.rows = kNegTileRows;
    int64_t tiles = ((int64_t)sh.num_walks * sh.centers + p.rows - 1) / p.rows;
    if (tiles >= ((int64_t)1 << 31)) return false;
    p.tiles = (int)tiles;
    for (int stages = 2; stages >= 1; --stages) {
      p.stages = stages;
      p.chunk = fit_chunk(p, kind, num_neg, limit);
      if (p.chunk > 0) {
        p.vrows = round_up(p.chunk, 16);
        layout(p, kind);
        return true;
      }
    }
    return false;
  }
  p.rows = 16 * (kWarps / p.nwd);
  int rcap = kORowCap > 2 * sh.hw + 1 ? kORowCap : 2 * sh.hw + 1;
  const int vn_targets[2] = {target, 16};
  for (int stages = 2; stages >= 1; --stages) {
    p.stages = stages;
    for (int vt : vn_targets) {
      for (int ro = rcap; ro >= 2 * sh.hw + 1; --ro) {
        if (!set_tiles(p, ro)) continue;
        p.vrows = vt;
        layout(p, kind);
        if (p.bytes > limit) continue;
        p.chunk = fit_chunk(p, kind, num_neg, limit);
        if (p.chunk < 1) return false;
        p.vrows = round_up(p.chunk, 16);
        layout(p, kind);
        return true;
      }
    }
  }
  return false;
}

// Bytes of one gather copy: the largest of 16, 8, 4 that divides the row
// width and both tables' addresses; 2 means plain loads.
inline int copy_bytes(const void* a, const void* b, int dim) {
  uintptr_t m = (uintptr_t)a | (uintptr_t)b | (uintptr_t)(dim * 2);
  return m % 16 == 0 ? 16 : m % 8 == 0 ? 8 : m % 4 == 0 ? 4 : 2;
}

// --- device helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void copy_piece(void* dst, const void* src,
                                           int bytes) {
  switch (bytes) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(dst)), "l"(src));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                       smem_addr(dst)), "l"(src));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(dst)), "l"(src));
      break;
    default:
      *reinterpret_cast<bf16*>(dst) = *reinterpret_cast<const bf16*>(src);
  }
}

__device__ __forceinline__ void zero_piece(void* dst, int bytes) {
  switch (bytes) {
    case 16: *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0); break;
    case 8: *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0); break;
    case 4: *reinterpret_cast<uint32_t*>(dst) = 0; break;
    default: *reinterpret_cast<uint16_t*>(dst) = 0;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x[nt][e] = A[a_row + g + 8*(e >= 2)] . B[b_row + 8*nt + 2*q + (e & 1)] over
// ksteps*16 columns, for the warp's 16 rows of A and 16 rows of B (g = lane/4,
// q = lane%4: the accumulator layout of m16n8k16).  A and B are shared-memory
// addresses of row-major bf16 rows `stride` bytes apart.
__device__ __forceinline__ void product_tile(uint32_t a, uint32_t b,
                                             int stride, int ksteps,
                                             float (&x)[2][4]) {
  const int lane = threadIdx.x & 31;
  a += ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + (lane >> 4) * 16;
  b += ((lane & 7) + (lane >> 4) * 8) * stride + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nt][e] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < ksteps; ++k) {
    uint32_t fa[4], fb[4];
    ldsm_x4(a + k * 32, fa);
    ldsm_x4(b + k * 32, fb);
    mma(x[0], fa, fb[0], fb[1]);
    mma(x[1], fa, fb[2], fb[3]);
  }
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The float32 values g (accumulator layout) as the A fragments of the next
// product over these 16 columns: a bf16 high part and the bf16 rounding of
// what it leaves.
__device__ __forceinline__ void split_to_a(const float (&g)[2][4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  bf16 h[2][4], l[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[nt][e] = __float2bfloat16_rn(g[nt][e]);
      l[nt][e] = __float2bfloat16_rn(g[nt][e] - __bfloat162float(h[nt][e]));
    }
  hi[0] = pack(h[0][0], h[0][1]);
  hi[1] = pack(h[0][2], h[0][3]);
  hi[2] = pack(h[1][0], h[1][1]);
  hi[3] = pack(h[1][2], h[1][3]);
  lo[0] = pack(l[0][0], l[0][1]);
  lo[1] = pack(l[0][2], l[0][3]);
  lo[2] = pack(l[1][0], l[1][1]);
  lo[3] = pack(l[1][2], l[1][3]);
}

// acc[nt] += (hi + lo) (16 x 16) * B[k_row + k][col0 + 8*nt + n] for nt < nd,
// B row-major bf16 rows `stride` bytes apart (read transposed by ldmatrix).
__device__ __forceinline__ void accumulate(float (&acc)[kMaxNT][4],
                                           const uint32_t (&hi)[4],
                                           const uint32_t (&lo)[4],
                                           uint32_t b, int stride, int nd) {
  const int lane = threadIdx.x & 31;
  b += ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + (lane >> 4) * 16;
#pragma unroll
  for (int pr = 0; pr < kMaxNT / 2; ++pr) {
    uint32_t fb[4];
    if (2 * pr + 1 < nd) {
      ldsm_x4_t(b + pr * 32, fb);
      mma(acc[2 * pr], hi, fb[0], fb[1]);
      mma(acc[2 * pr], lo, fb[0], fb[1]);
      mma(acc[2 * pr + 1], hi, fb[2], fb[3]);
      mma(acc[2 * pr + 1], lo, fb[2], fb[3]);
    } else if (2 * pr < nd) {
      ldsm_x2_t(b + pr * 32, fb);
      mma(acc[2 * pr], hi, fb[0], fb[1]);
      mma(acc[2 * pr], lo, fb[0], fb[1]);
    }
  }
}

// Adds v[0..3] to p[0..3], the part of it before column `room` of a row of
// `dim` floats, with as few atomic instructions as the alignment allows.
__device__ __forceinline__ void add_piece(float* p, const float (&v)[4],
                                          int room, int dim) {
  if ((dim & 3) == 0) {
    if (room >= 4)
      atomicAdd(reinterpret_cast<float4*>(p),
                make_float4(v[0], v[1], v[2], v[3]));
  } else if ((dim & 1) == 0) {
    if (room >= 2)
      atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
    if (room >= 4)
      atomicAdd(reinterpret_cast<float2*>(p + 2), make_float2(v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < room) atomicAdd(p + i, v[i]);
  }
}

// Adds a warp's accumulator (rows row0 + g and row0 + g + 8, columns col0 +
// 8*nt + 2*q + {0, 1}) to grad[rid * dim + column] for columns < dim.  Lanes
// q and q^1 swap half their rows first, so that each lane holds four
// consecutive columns of one row.  rid(row) < 0 skips the row.
template <typename RowId>
__device__ __forceinline__ void scatter(const float (&acc)[kMaxNT][4], int nd,
                                        int row0, int col0, int dim,
                                        float* __restrict__ grad, RowId rid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const bool even = (q & 1) == 0;
  const int64_t row = rid(row0 + g + (even ? 0 : 8));
#pragma unroll
  for (int nt = 0; nt < kMaxNT; ++nt) {
    if (nt < nd) {
      float s0 = even ? acc[nt][2] : acc[nt][0];
      float s1 = even ? acc[nt][3] : acc[nt][1];
      float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      float v[4];
      v[0] = even ? acc[nt][0] : r0;
      v[1] = even ? acc[nt][1] : r1;
      v[2] = even ? r0 : acc[nt][2];
      v[3] = even ? r1 : acc[nt][3];
      int c = col0 + nt * 8 + 2 * (q & ~1);
      if (row >= 0) add_piece(grad + row * dim + c, v, dim - c, dim);
    }
  }
}

// Offset from its center of context k < 2*hw: -hw .. -1, then 1 .. hw.
__device__ __forceinline__ int context_offset(int k, int hw) {
  return k < hw ? k - hw : k - hw + 1;
}

struct Tile {
  int w0, nw, c0, ncl;  // first walk, walks, first center, centers a walk
};

__device__ __forceinline__ Tile tile_of(const Plan& p, int t) {
  Tile tl;
  if (p.tpw == 1) {
    tl.w0 = t * p.wpt;
    tl.nw = p.sh.num_walks - tl.w0 < p.wpt ? p.sh.num_walks - tl.w0 : p.wpt;
    tl.c0 = 0;
    tl.ncl = p.sh.centers;
  } else {
    tl.w0 = t / p.tpw;
    tl.nw = 1;
    tl.c0 = (t - tl.w0 * p.tpw) * p.nc;
    tl.ncl = p.sh.centers - tl.c0 < p.nc ? p.sh.centers - tl.c0 : p.nc;
  }
  return tl;
}

// Is row r of the tile a center?  Rows are walk-major: r = wi * nc + ci.
__device__ __forceinline__ bool is_center(const Plan& p, const Tile& tl,
                                          int r) {
  int wi = r / p.nc, ci = r - wi * p.nc;
  return wi < tl.nw && ci < tl.ncl;
}

// a . b over the first d8 = round_up(D, 8) columns of two staged rows by one
// thread, 16 bytes a load (the padding is zero; rows start on 16 bytes and
// are an odd number of 16-byte units apart, so eight threads on eight rows
// meet no bank conflict).
__device__ __forceinline__ float row_dot(const bf16* a, const bf16* b,
                                         int d8) {
  float s0 = 0.0f, s1 = 0.0f;
  for (int d = 0; d < d8; d += 8) {
    uint4 x = *reinterpret_cast<const uint4*>(a + d);
    uint4 y = *reinterpret_cast<const uint4*>(b + d);
    const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 xf = __bfloat1622float2(xa[i]), yf = __bfloat1622float2(ya[i]);
      s0 = fmaf(xf.x, yf.x, s0);
      s1 = fmaf(xf.y, yf.y, s1);
    }
  }
  return s0 + s1;
}

// The logit of positive pair pr of the tile (row r = pr / 2hw, context k),
// or false if row r holds no center.
__device__ __forceinline__ bool pair_logit(const Plan& p, const Tile& tl,
                                           const bf16* u, const bf16* o,
                                           int pr, float* x) {
  const int hw = p.sh.hw, r = pr / (2 * hw), k = pr - r * 2 * hw;
  if (!is_center(p, tl, r)) return false;
  const int wi = r / p.nc, ci = r - wi * p.nc;
  *x = row_dot(u + r * p.us,
               o + (wi * p.no + ci + hw + context_offset(k, hw)) * p.os,
               round_up(p.sh.dim, 8));
  return true;
}

__device__ void zero_shared(unsigned char* smem, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);
}

// Copies rows ids[r] of a table into rows r of dst (stride elements apart);
// a row of id < 0 is zeroed when `zero` is set and left alone otherwise.
__device__ void gather(bf16* dst, int stride, const int64_t* ids, int n,
                       const bf16* __restrict__ table, int dim, int vec,
                       bool zero) {
  const int pieces = dim * 2 / vec;
  for (int i = threadIdx.x; i < n * pieces; i += blockDim.x) {
    int r = i / pieces, k = i - r * pieces;
    unsigned char* d =
        reinterpret_cast<unsigned char*>(dst + (int64_t)r * stride) + k * vec;
    int64_t id = ids[r];
    if (id >= 0)
      copy_piece(d,
                 reinterpret_cast<const unsigned char*>(table + id * dim) +
                     k * vec,
                 vec);
    else if (zero)
      zero_piece(d, vec);
  }
}

// The chunk's negative rows -> Vn (rows beyond the chunk stay zero).
__device__ void stage_negatives(const Plan& p, unsigned char* smem,
                                const bf16* __restrict__ out_emb,
                                const int32_t* __restrict__ neg_ids) {
  bf16* vn = reinterpret_cast<bf16*>(smem + p.vn);
  const int pieces = p.sh.dim * 2 / p.vec;
  for (int i = threadIdx.x; i < p.chunk * pieces; i += blockDim.x) {
    int s = i / pieces, k = i - s * pieces;
    int64_t id = table_row(neg_ids[s], p.sh.num_nodes);
    copy_piece(reinterpret_cast<unsigned char*>(vn + s * p.us) + k * p.vec,
               reinterpret_cast<const unsigned char*>(out_emb +
                                                      id * p.sh.dim) +
                   k * p.vec,
               p.vec);
  }
}

// Walk tile t -> stage: its ids, then its U and O rows (asynchronously).
__device__ void stage_walk_tile(const Plan& p, unsigned char* stage, int t,
                                const int32_t* __restrict__ walks,
                                const bf16* __restrict__ in_emb,
                                const bf16* __restrict__ out_emb) {
  const LossShape& sh = p.sh;
  const Tile tl = tile_of(p, t);
  int64_t* uid = reinterpret_cast<int64_t*>(stage + p.uid);
  int64_t* oid = reinterpret_cast<int64_t*>(stage + p.oid);
  for (int r = threadIdx.x; r < p.rows; r += blockDim.x) {
    int wi = r / p.nc, ci = r - wi * p.nc;
    uid[r] = wi < tl.nw && ci < tl.ncl
                 ? table_row(walks[(int64_t)(tl.w0 + wi) * sh.length1 + sh.hw +
                                   tl.c0 + ci],
                             sh.num_nodes)
                 : -1;
  }
  for (int r = threadIdx.x; r < p.wpt * p.no; r += blockDim.x) {
    int wi = r / p.no, oj = r - wi * p.no;
    oid[r] = wi < tl.nw && tl.c0 + oj < sh.length1
                 ? table_row(walks[(int64_t)(tl.w0 + wi) * sh.length1 + tl.c0 +
                                   oj],
                             sh.num_nodes)
                 : -1;
  }
  __syncthreads();
  gather(reinterpret_cast<bf16*>(stage + p.u), p.us, uid, p.rows, in_emb,
         sh.dim, p.vec, true);
  gather(reinterpret_cast<bf16*>(stage + p.o), p.os, oid, p.wpt * p.no,
         out_emb, sh.dim, p.vec, false);
}

// Flat tile t of center rows (row m = b * C + c) -> stage.
__device__ void stage_flat_tile(const Plan& p, unsigned char* stage, int t,
                                const int32_t* __restrict__ walks,
                                const bf16* __restrict__ in_emb) {
  const LossShape& sh = p.sh;
  const int64_t total = (int64_t)sh.num_walks * sh.centers;
  int64_t* uid = reinterpret_cast<int64_t*>(stage + p.uid);
  for (int r = threadIdx.x; r < p.rows; r += blockDim.x) {
    int64_t m = (int64_t)t * p.rows + r;
    int64_t b = m / sh.centers;
    uid[r] = m < total
                 ? table_row(walks[b * sh.length1 + sh.hw + (m - b * sh.centers)],
                             sh.num_nodes)
                 : -1;
  }
  __syncthreads();
  gather(reinterpret_cast<bf16*>(stage + p.u), p.us, uid, p.rows, in_emb,
         sh.dim, p.vec, true);
}

// --- K5 ----------------------------------------------------------------------

extern "C" __global__ void __launch_bounds__(kFwdThreads, 1)
trw_sgns_loss_fwd_bf16(const Plan p, const int32_t* __restrict__ walks,
                       const bf16* __restrict__ in_emb,
                       const bf16* __restrict__ out_emb,
                       const int32_t* __restrict__ neg_ids, int first,
                       float* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LossShape& sh = p.sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int pairs = p.wpt * p.nc * 2 * sh.hw;
  const int nsw = kFwdWarps / (p.rows / 16);  // warps along S
  const int wm = warp / nsw, wsn = warp - wm * nsw, r0 = wm * 16;
  const int stride = p.us * 2, ksteps = p.d16 / 16;
  float* red = reinterpret_cast<float*>(smem + p.red);
  const uint32_t vn = smem_addr(smem + p.vn);

  zero_shared(smem, p.bytes);
  __syncthreads();
  stage_negatives(p, smem, out_emb, neg_ids);
  int t = blockIdx.x;
  if (t < p.tiles)
    stage_walk_tile(p, smem + p.stage, t, walks, in_emb, out_emb);
  cp_async_commit();
  for (int i = 0; t < p.tiles; ++i, t += gridDim.x) {
    const int st = p.stages == 2 ? (i & 1) : 0;
    const int next = t + gridDim.x;
    if (p.stages == 2) {
      if (next < p.tiles)
        stage_walk_tile(p, smem + p.stage + (st ^ 1) * p.stage_bytes, next,
                        walks, in_emb, out_emb);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unsigned char* stage = smem + p.stage + st * p.stage_bytes;
    const bf16* u = reinterpret_cast<const bf16*>(stage + p.u);
    const bf16* o = reinterpret_cast<const bf16*>(stage + p.o);
    const Tile tl = tile_of(p, t);

    float sum = 0.0f;
    if (first) {
      for (int pr = threadIdx.x; pr < pairs; pr += kFwdThreads) {
        float x;
        if (pair_logit(p, tl, u, o, pr, &x)) sum += log_sigmoid(x);
      }
    }
    const bool va = is_center(p, tl, r0 + g), vb = is_center(p, tl, r0 + g + 8);
    float neg = 0.0f;
    if (r0 < p.wpt * p.nc) {
      const uint32_t ua = smem_addr(u + r0 * p.us);
      for (int sc = wsn; sc < p.vrows / 16; sc += nsw) {
        float x[2][4];
        product_tile(ua, vn + sc * 16 * stride, stride, ksteps, x);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int s = sc * 16 + nt * 8 + 2 * q + (e & 1);
            if ((e < 2 ? va : vb) && s < p.chunk)
              neg += log_sigmoid(-x[nt][e]);
          }
      }
    }
    sum = fmaf(sh.neg_weight, neg, sum);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    if (lane == 0) red[warp] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.0f;
      for (int w = 0; w < kFwdWarps; ++w) total += red[w];
      partial[t] = first ? total : partial[t] + total;
    }
    __syncthreads();
    if (p.stages == 1 && next < p.tiles) {
      stage_walk_tile(p, smem + p.stage, next, walks, in_emb, out_emb);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

// --- K6, rows pass: du and do -----------------------------------------------

extern "C" __global__ void __launch_bounds__(kThreads, 1)
trw_sgns_loss_bwd_rows_bf16(const Plan p, const int32_t* __restrict__ walks,
                            const bf16* __restrict__ in_emb,
                            const bf16* __restrict__ out_emb,
                            const int32_t* __restrict__ neg_ids, int first,
                            const float* __restrict__ grad_loss,
                            float* __restrict__ grad_in,
                            float* __restrict__ grad_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LossShape& sh = p.sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int hw = sh.hw, pairs = p.wpt * p.nc * 2 * hw;
  const int wm = warp / p.nwd, wd = warp - wm * p.nwd;
  const int r0 = wm * 16, d0 = wd * p.dsl;
  const int nd = (p.d16 - d0 < p.dsl ? p.d16 - d0 : p.dsl) / 8;
  const int stride = p.us * 2, ksteps = p.d16 / 16;
  // loss = -(sum of log-sigmoids) / (B * C)
  const float scale =
      grad_loss[0] / ((float)sh.num_walks * (float)sh.centers);
  const float neg_scale = scale * sh.neg_weight;
  float* gp = reinterpret_cast<float*>(smem + p.gp);
  const uint32_t vn = smem_addr(smem + p.vn);

  zero_shared(smem, p.bytes);
  __syncthreads();
  stage_negatives(p, smem, out_emb, neg_ids);
  int t = blockIdx.x;
  if (t < p.tiles)
    stage_walk_tile(p, smem + p.stage, t, walks, in_emb, out_emb);
  cp_async_commit();
  for (int i = 0; t < p.tiles; ++i, t += gridDim.x) {
    const int st = p.stages == 2 ? (i & 1) : 0;
    const int next = t + gridDim.x;
    if (p.stages == 2) {
      if (next < p.tiles)
        stage_walk_tile(p, smem + p.stage + (st ^ 1) * p.stage_bytes, next,
                        walks, in_emb, out_emb);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unsigned char* stage = smem + p.stage + st * p.stage_bytes;
    const bf16* u = reinterpret_cast<const bf16*>(stage + p.u);
    const bf16* o = reinterpret_cast<const bf16*>(stage + p.o);
    const int64_t* uid = reinterpret_cast<const int64_t*>(stage + p.uid);
    const int64_t* oid = reinterpret_cast<const int64_t*>(stage + p.oid);
    const Tile tl = tile_of(p, t);

    // 1. dloss/dlogit of the positive pairs: gp = -scale * sigmoid(-x).
    if (first) {
      for (int pr = threadIdx.x; pr < pairs; pr += kThreads) {
        float x;
        if (pair_logit(p, tl, u, o, pr, &x)) gp[pr] = -scale * sigmoid(-x);
      }
    }
    __syncthreads();

    // 2. do[j] = sum over the pairs (c, j) of gp * u[c], four columns a
    //    thread.
    if (first && hw > 0) {
      const int quads = (sh.dim + 3) / 4;
      for (int item = threadIdx.x; item < p.wpt * p.no * quads;
           item += kThreads) {
        int j = item / quads, c = (item - j * quads) * 4;
        if (oid[j] < 0) continue;
        int wi = j / p.no, oj = j - wi * p.no;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int k = 0; k < 2 * hw; ++k) {
          int cl = oj - hw - context_offset(k, hw);
          if (cl < 0 || cl >= tl.ncl) continue;
          int r = wi * p.nc + cl;
          float w = gp[r * 2 * hw + k];
          const bf16* ur = u + r * p.us + c;
          float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ur));
          float2 b = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ur + 2));
          v[0] = fmaf(w, a.x, v[0]);
          v[1] = fmaf(w, a.y, v[1]);
          v[2] = fmaf(w, b.x, v[2]);
          v[3] = fmaf(w, b.y, v[3]);
        }
        add_piece(grad_out + oid[j] * sh.dim + c, v, sh.dim - c, sh.dim);
      }
    }

    // 3. du = g Vn on the tensor cores (+ the positive pairs), per warp 16
    //    rows by its columns d0 .. d0 + 8*nd.
    if (r0 < p.wpt * p.nc && nd > 0) {
      const bool va = is_center(p, tl, r0 + g),
                 vb = is_center(p, tl, r0 + g + 8);
      float acc[kMaxNT][4];
#pragma unroll
      for (int nt = 0; nt < kMaxNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
      const uint32_t ua = smem_addr(u + r0 * p.us);
      for (int sc = 0; sc < p.vrows / 16; ++sc) {
        float x[2][4];
        product_tile(ua, vn + sc * 16 * stride, stride, ksteps, x);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int s = sc * 16 + nt * 8 + 2 * q + (e & 1);
            x[nt][e] = (e < 2 ? va : vb) && s < p.chunk
                           ? neg_scale * sigmoid(x[nt][e])
                           : 0.0f;
          }
        uint32_t hi[4], lo[4];
        split_to_a(x, hi, lo);
        accumulate(acc, hi, lo, vn + sc * 16 * stride + d0 * 2, stride, nd);
      }
      if (first && hw > 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          int r = r0 + g + 8 * half;
          if (!(half ? vb : va)) continue;
          int wi = r / p.nc, ci = r - wi * p.nc;
          for (int k = 0; k < 2 * hw; ++k) {
            float w = gp[r * 2 * hw + k];
            const bf16* orow =
                o + (wi * p.no + ci + hw + context_offset(k, hw)) * p.os;
#pragma unroll
            for (int nt = 0; nt < kMaxNT; ++nt) {
              int c = d0 + nt * 8 + 2 * q;
              if (nt < nd && c < sh.dim) {
                float2 y = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(orow + c));
                acc[nt][2 * half] = fmaf(w, y.x, acc[nt][2 * half]);
                acc[nt][2 * half + 1] = fmaf(w, y.y, acc[nt][2 * half + 1]);
              }
            }
          }
        }
      }
      scatter(acc, nd, r0, d0, sh.dim, grad_in,
              [&](int r) -> int64_t { return uid[r]; });
    }
    __syncthreads();
    if (p.stages == 1 && next < p.tiles) {
      stage_walk_tile(p, smem + p.stage, next, walks, in_emb, out_emb);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

// --- K6, negatives pass: dVn ------------------------------------------------

extern "C" __global__ void __launch_bounds__(kNegThreads, 1)
trw_sgns_loss_bwd_neg_bf16(const Plan p, const int32_t* __restrict__ walks,
                           const bf16* __restrict__ in_emb,
                           const bf16* __restrict__ out_emb,
                           const int32_t* __restrict__ neg_ids,
                           const float* __restrict__ grad_loss,
                           float* __restrict__ grad_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LossShape& sh = p.sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ws = warp / p.nwd, wd = warp - ws * p.nwd;
  const int s0 = ws * 16, d0 = wd * p.dsl;
  const int nd = (p.d16 - d0 < p.dsl ? p.d16 - d0 : p.dsl) / 8;
  const bool active = s0 < p.chunk && nd > 0;
  const int stride = p.us * 2, ksteps = p.d16 / 16;
  const int64_t total = (int64_t)sh.num_walks * sh.centers;
  const float neg_scale = grad_loss[0] /
                          ((float)sh.num_walks * (float)sh.centers) *
                          sh.neg_weight;
  const bool va = s0 + g < p.chunk, vb = s0 + g + 8 < p.chunk;
  const uint32_t vs = smem_addr(smem + p.vn) + s0 * stride;

  float acc[kMaxNT][4];
#pragma unroll
  for (int nt = 0; nt < kMaxNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

  zero_shared(smem, p.bytes);
  __syncthreads();
  stage_negatives(p, smem, out_emb, neg_ids);
  int t = blockIdx.x;
  if (t < p.tiles) stage_flat_tile(p, smem + p.stage, t, walks, in_emb);
  cp_async_commit();
  for (int i = 0; t < p.tiles; ++i, t += gridDim.x) {
    const int st = p.stages == 2 ? (i & 1) : 0;
    const int next = t + gridDim.x;
    if (p.stages == 2) {
      if (next < p.tiles)
        stage_flat_tile(p, smem + p.stage + (st ^ 1) * p.stage_bytes, next,
                        walks, in_emb);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const bf16* u = reinterpret_cast<const bf16*>(
          smem + p.stage + st * p.stage_bytes + p.u);
      const int64_t left = total - (int64_t)t * p.rows;
      const int valid = left < p.rows ? (int)left : p.rows;
      for (int mc = 0; mc * 16 < valid; ++mc) {
        const uint32_t um = smem_addr(u + mc * 16 * p.us);
        float x[2][4];  // x^T: rows are negatives, columns centers
        product_tile(vs, um, stride, ksteps, x);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int m = mc * 16 + nt * 8 + 2 * q + (e & 1);
            x[nt][e] = (e < 2 ? va : vb) && m < valid
                           ? neg_scale * sigmoid(x[nt][e])
                           : 0.0f;
          }
        uint32_t hi[4], lo[4];
        split_to_a(x, hi, lo);
        accumulate(acc, hi, lo, um + d0 * 2, stride, nd);
      }
    }
    __syncthreads();
    if (p.stages == 1 && next < p.tiles) {
      stage_flat_tile(p, smem + p.stage, next, walks, in_emb);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  if (active)
    scatter(acc, nd, s0, d0, sh.dim, grad_out, [&](int s) -> int64_t {
      return s < p.chunk ? table_row(neg_ids[s], sh.num_nodes) : -1;
    });
}

// --- launch ------------------------------------------------------------------

template <typename K>
inline cudaError_t occupancy(K kernel, int threads, int smem, int* per_sm,
                             int* sms) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  return *per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// The plan of one launch over negatives [s0, s0 + n) of a kernel's chunking.
inline Plan for_launch(Plan p, int kind, int n, int vec) {
  p.chunk = n;
  p.vrows = round_up(n, 16);
  p.vec = vec;
  layout(p, kind);
  return p;
}

template <typename K>
inline cudaError_t grid_of(K kernel, int threads, const Plan& p, int* grid,
                           int* per_sm) {
  int sms = 0;
  cudaError_t err = occupancy(kernel, threads, p.bytes, per_sm, &sms);
  if (err != cudaSuccess) return err;
  int64_t want = (int64_t)sms * *per_sm;
  *grid = (int)(want < p.tiles ? want : p.tiles);
  return cudaSuccess;
}

int chunk_size(const LossShape& sh, int num_neg_ids, bool backward) {
  int limit = max_shared_bytes();
  Plan p;
  if (!backward)
    return make_plan(p, sh, num_neg_ids, kFwd, limit) ? p.chunk : 0;
  Plan q;
  if (!make_plan(p, sh, num_neg_ids, kRows, limit) ||
      !make_plan(q, sh, num_neg_ids, kNeg, limit))
    return 0;
  return p.chunk < q.chunk ? p.chunk : q.chunk;
}

int64_t num_partials(const LossShape& sh, int num_neg_ids) {
  Plan p;
  return make_plan(p, sh, num_neg_ids, kFwd, max_shared_bytes()) ? p.tiles
                                                                   : 0;
}

int describe(const LossShape& sh, int num_neg_ids, int32_t* out) {
  int limit = max_shared_bytes();
  for (int kind = kFwd; kind <= kNeg; ++kind) {
    Plan p;
    int32_t* row = out + kind * kDescribeInts;
    if (!make_plan(p, sh, num_neg_ids, kind, limit))
      return (int)cudaErrorInvalidValue;
    p = for_launch(p, kind, p.chunk, 16);
    int grid = 0, per_sm = 0;
    cudaError_t err =
        kind == kFwd ? grid_of(trw_sgns_loss_fwd_bf16, kFwdThreads, p, &grid,
                               &per_sm)
        : kind == kRows
            ? grid_of(trw_sgns_loss_bwd_rows_bf16, kThreads, p, &grid, &per_sm)
            : grid_of(trw_sgns_loss_bwd_neg_bf16, kNegThreads, p, &grid,
                      &per_sm);
    if (err != cudaSuccess) return (int)err;
    int32_t vals[kDescribeInts] = {
        p.rows, kind == kNeg ? 0 : p.wpt, kind == kNeg ? 0 : p.nc, p.tiles,
        p.chunk, (num_neg_ids + p.chunk - 1) / p.chunk, p.stages, p.bytes,
        per_sm, grid};
    for (int i = 0; i < kDescribeInts; ++i) row[i] = vals[i];
  }
  return (int)cudaSuccess;
}

int launch_fwd(const LossShape& sh, const int32_t* walks, const void* in_emb,
               const void* out_emb, const int32_t* neg_ids, int num_neg_ids,
               float* partial, float* loss, cudaStream_t stream) {
  Plan base;
  if (!make_plan(base, sh, num_neg_ids, kFwd, max_shared_bytes()))
    return (int)cudaErrorInvalidValue;
  const int vec = copy_bytes(in_emb, out_emb, sh.dim);
  for (int s0 = 0; s0 < num_neg_ids; s0 += base.chunk) {
    int n = num_neg_ids - s0 < base.chunk ? num_neg_ids - s0 : base.chunk;
    Plan p = for_launch(base, kFwd, n, vec);
    int grid = 0, per_sm = 0;
    cudaError_t err =
        grid_of(trw_sgns_loss_fwd_bf16, kFwdThreads, p, &grid, &per_sm);
    if (err != cudaSuccess) return (int)err;
    trw_sgns_loss_fwd_bf16<<<grid, kFwdThreads, p.bytes, stream>>>(
        p, walks, (const bf16*)in_emb, (const bf16*)out_emb, neg_ids + s0,
        s0 == 0, partial);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)launch_reduce_partials(
      partial, base.tiles, (double)sh.num_walks * (double)sh.centers, loss,
      stream);
}

int launch_bwd(const LossShape& sh, const int32_t* walks, const void* in_emb,
               const void* out_emb, const int32_t* neg_ids, int num_neg_ids,
               const float* grad_loss, float* grad_in, float* grad_out,
               cudaStream_t stream) {
  const int limit = max_shared_bytes();
  Plan rows, negs;
  if (!make_plan(rows, sh, num_neg_ids, kRows, limit) ||
      !make_plan(negs, sh, num_neg_ids, kNeg, limit))
    return (int)cudaErrorInvalidValue;
  const int vec = copy_bytes(in_emb, out_emb, sh.dim);
  const bf16* in = (const bf16*)in_emb;
  const bf16* out = (const bf16*)out_emb;
  for (int s0 = 0; s0 < num_neg_ids; s0 += rows.chunk) {
    int n = num_neg_ids - s0 < rows.chunk ? num_neg_ids - s0 : rows.chunk;
    Plan p = for_launch(rows, kRows, n, vec);
    int grid = 0, per_sm = 0;
    cudaError_t err =
        grid_of(trw_sgns_loss_bwd_rows_bf16, kThreads, p, &grid, &per_sm);
    if (err != cudaSuccess) return (int)err;
    trw_sgns_loss_bwd_rows_bf16<<<grid, kThreads, p.bytes, stream>>>(
        p, walks, in, out, neg_ids + s0, s0 == 0, grad_loss, grad_in,
        grad_out);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  for (int s0 = 0; s0 < num_neg_ids; s0 += negs.chunk) {
    int n = num_neg_ids - s0 < negs.chunk ? num_neg_ids - s0 : negs.chunk;
    Plan p = for_launch(negs, kNeg, n, vec);
    int grid = 0, per_sm = 0;
    cudaError_t err =
        grid_of(trw_sgns_loss_bwd_neg_bf16, kNegThreads, p, &grid, &per_sm);
    if (err != cudaSuccess) return (int)err;
    trw_sgns_loss_bwd_neg_bf16<<<grid, kNegThreads, p.bytes, stream>>>(
        p, walks, in, out, neg_ids + s0, grad_loss, grad_out);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace tc
}  // namespace trw
