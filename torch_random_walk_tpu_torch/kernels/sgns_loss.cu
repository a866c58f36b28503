// K5 and K6: the blockwise skip-gram loss with batch-shared negatives over
// whole walks, forward (K5) and backward (K6).
//
// Replaces the XLA programs of torch_random_walk_tpu/models/skipgram.py::
// SkipGramModel.walk_loss_fn + _blockwise_loss (K5) and their
// jax.value_and_grad in walk_train_step (K6); they have no Pallas
// counterpart.  For a walk of L1 = L+1 node ids, half window hw and
// C = L1 - 2*hw centers:
//   u[c]   = in_emb[walk[hw + c]]              c < C
//   o[j]   = out_emb[walk[j]]                  j < L1
//   vn[s]  = out_emb[neg_ids[s]]               s < S
//   pos    = sum over c, off in [-hw, hw] \ {0} of logsig(u[c] . o[c+hw+off])
//   neg    = (num_neg / S) * sum over c, s of logsig(-(u[c] . vn[s]))
//   loss   = -(sum over walks of pos + neg) / (B * C)
// Products and sums are float32 whatever the tables' type.  A negative id
// wraps once (id + N), as table[ids] wraps it in the JAX package.
//
// Two builds, chosen by the tables' type (explicit dispatch, not a fallback):
//   bfloat16, the trainer's type: sgns_loss_tc.cu, tiles of many walks on
//     the tensor cores (mma.sync, bf16 in, float32 accumulate), cp.async
//     gathers, float4 atomics.  Its header states the design.
//   float32: this file, the CUDA-core loops below.  TF32 would not keep the
//     kernels within 1e-5 / 1e-4 of the plain version; a bf16x3 split that
//     would let float32 share the tensor-core build is a later item.
//
// The float32 build.  Bound on this card: operations before bytes.  The rows
// a walk gathers are read once into shared memory, but every walk costs
// C*S*D multiply-adds forward and three times that backward on the CUDA
// cores.  The (C, S) logits of a walk live in registers (K5) or shared
// memory (K6) and are never written out.
//
// One block of 256 threads takes walks blockIdx.x, blockIdx.x + gridDim.x,
// ...; the negative rows are staged in shared memory once per block.
//   K5: one thread per negative s holds a tile of 8 centers in registers and
//       runs over d; the walk's sum is reduced in a fixed order (shuffle
//       tree, then the 8 warps in turn) into partial[walk], and a second
//       single-block kernel sums the partials in a fixed order, so equal
//       inputs give equal loss bits.
//   K6: recomputes the logits, keeps dloss/dlogit in shared memory, and
//       forms the row gradients in the block: du[c] and do[j] complete per
//       walk (each (row, d) owned by one thread, no atomics in shared
//       memory), then one atomicAdd per row element into the dense (N, D)
//       float32 gradient tables.  The gradient of the S negative rows is
//       summed over every walk the block owns in a register tile (128
//       accumulators a thread) and flushed once per block: S*D atomics a
//       block instead of C*S*D a walk.
// Shared negatives that do not fit (shared memory, or the register tile of
// K6) are taken in chunks: one kernel launch per chunk, the positive term
// with the first.

#include "sgns_loss.cuh"

namespace trw {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCenterTile = 8;
constexpr int kAccPerThread = 128;  // K6 register tile of the negatives' gradient
constexpr int kReduceThreads = 1024;

__device__ __forceinline__ float to_float(float x) { return x; }

// Shared-memory plan of one block, in 4-byte words; every array starts on a
// 16-byte boundary.  Rows of u, o, du, do are d4 = round_up(D, 4) floats, the
// dlogit rows sc4 = round_up(chunk, 4) floats, padded with zeros so that the
// inner loops read float4 without an edge case.  Rows of the staged negatives
// are vstride table elements, an odd number of words, so that 32 threads on
// 32 consecutive rows hit 32 banks.
struct Plan {
  int d4, cpad, sc4, vstride;
  int u, o, du, dout, g, gp, ids, nids, red, vneg;  // word offsets
  size_t bytes;
};

__host__ __device__ inline int take_words(int& at, int words) {
  int start = at;
  at += round_up(words, 4);
  return start;
}

__host__ __device__ inline Plan make_plan(int length1, int dim, int hw,
                                          int chunk, int elem_bytes,
                                          bool backward) {
  Plan p;
  int centers = length1 - 2 * hw;
  p.d4 = round_up(dim, 4);
  p.cpad = round_up(centers, kCenterTile);
  p.sc4 = round_up(chunk, 4);
  p.vstride = p.d4 + 4 / elem_bytes;
  int at = 0;
  p.u = take_words(at, p.cpad * p.d4);
  p.o = take_words(at, length1 * p.d4);
  p.du = take_words(at, backward ? centers * p.d4 : 0);
  p.dout = take_words(at, backward ? length1 * p.d4 : 0);
  p.g = take_words(at, backward ? p.cpad * p.sc4 : 0);
  p.gp = take_words(at, backward ? centers * 2 * hw : 0);
  p.ids = take_words(at, length1);
  p.nids = take_words(at, p.sc4);
  p.red = take_words(at, kWarps);
  p.vneg = take_words(at, (p.sc4 * p.vstride * elem_bytes + 3) / 4);
  p.bytes = (size_t)at * 4;
  return p;
}

// Rows of out_emb for this chunk of the shared negatives -> shared memory,
// zero beyond the chunk and beyond D.
template <typename T>
__device__ void stage_negatives(const Plan& p, const T* __restrict__ out_emb,
                                const int32_t* __restrict__ neg_ids,
                                int chunk, int dim, int num_nodes,
                                int32_t* nids, T* vneg) {
  for (int s = threadIdx.x; s < p.sc4; s += kThreads)
    nids[s] = s < chunk ? (int32_t)table_row(neg_ids[s], num_nodes) : 0;
  __syncthreads();
  for (int i = threadIdx.x; i < p.sc4 * p.vstride; i += kThreads) {
    int s = i / p.vstride, d = i - s * p.vstride;
    float v = (s < chunk && d < dim)
                  ? to_float(out_emb[(int64_t)nids[s] * dim + d]) : 0.0f;
    vneg[i] = v;
  }
}

// One walk's ids and rows -> shared memory as float32: u (cpad, d4) from
// in_emb at the centers, o (L1, d4) from out_emb at every position.
template <typename T>
__device__ void stage_walk(const Plan& p, const LossShape& sh,
                           const int32_t* __restrict__ walk,
                           const T* __restrict__ in_emb,
                           const T* __restrict__ out_emb, bool with_out,
                           int32_t* ids, float* u, float* o) {
  for (int j = threadIdx.x; j < sh.length1; j += kThreads)
    ids[j] = (int32_t)table_row(walk[j], sh.num_nodes);
  __syncthreads();
  for (int i = threadIdx.x; i < p.cpad * p.d4; i += kThreads) {
    int c = i / p.d4, d = i - c * p.d4;
    u[i] = (c < sh.centers && d < sh.dim)
               ? to_float(in_emb[(int64_t)ids[c + sh.hw] * sh.dim + d]) : 0.0f;
  }
  if (with_out) {
    for (int i = threadIdx.x; i < sh.length1 * p.d4; i += kThreads) {
      int j = i / p.d4, d = i - j * p.d4;
      o[i] = d < sh.dim ? to_float(out_emb[(int64_t)ids[j] * sh.dim + d])
                        : 0.0f;
    }
  }
}

// Logits of one negative row against a tile of kCenterTile centers.
template <typename T>
__device__ __forceinline__ void negative_logits(const Plan& p, const float* u,
                                                const T* vrow, int c0,
                                                float (&acc)[kCenterTile]) {
#pragma unroll
  for (int i = 0; i < kCenterTile; ++i) acc[i] = 0.0f;
  for (int d = 0; d < p.d4; d += 4) {
    float v0 = to_float(vrow[d]), v1 = to_float(vrow[d + 1]);
    float v2 = to_float(vrow[d + 2]), v3 = to_float(vrow[d + 3]);
#pragma unroll
    for (int i = 0; i < kCenterTile; ++i) {
      float4 x = *reinterpret_cast<const float4*>(u + (c0 + i) * p.d4 + d);
      acc[i] = fmaf(x.x, v0, fmaf(x.y, v1, fmaf(x.z, v2, fmaf(x.w, v3,
                                                               acc[i]))));
    }
  }
}

// Positive pair number pr of a walk: center c, context row j.
__device__ __forceinline__ void pair_of(int pr, int hw, int& c, int& j) {
  c = pr / (2 * hw);
  int k = pr - c * 2 * hw;
  int off = k < hw ? k - hw : k - hw + 1;
  j = c + hw + off;
}

// u[c] . o[j] by one warp; every lane returns the sum.
__device__ __forceinline__ float warp_dot(const float* a, const float* b,
                                          int n) {
  float s = 0.0f;
  for (int d = threadIdx.x & 31; d < n; d += 32) s = fmaf(a[d], b[d], s);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// --- K5 ----------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
walk_sgns_loss_fwd_kernel(LossShape sh, const int32_t* __restrict__ walks,
                          const T* __restrict__ in_emb,
                          const T* __restrict__ out_emb,
                          const int32_t* __restrict__ neg_ids, int chunk,
                          int first, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const Plan p = make_plan(sh.length1, sh.dim, sh.hw, chunk, sizeof(T), false);
  float* u = smem + p.u;
  float* o = smem + p.o;
  int32_t* ids = reinterpret_cast<int32_t*>(smem + p.ids);
  int32_t* nids = reinterpret_cast<int32_t*>(smem + p.nids);
  float* red = smem + p.red;
  T* vneg = reinterpret_cast<T*>(smem + p.vneg);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  stage_negatives<T>(p, out_emb, neg_ids, chunk, sh.dim, sh.num_nodes, nids,
                     vneg);
  for (int w = blockIdx.x; w < sh.num_walks; w += gridDim.x) {
    __syncthreads();  // the last walk's readers are done
    stage_walk<T>(p, sh, walks + (int64_t)w * sh.length1, in_emb, out_emb,
                  first != 0, ids, u, o);
    __syncthreads();
    float sum = 0.0f;
    if (first) {
      for (int pr = warp; pr < sh.centers * 2 * sh.hw; pr += kWarps) {
        int c, j;
        pair_of(pr, sh.hw, c, j);
        float x = warp_dot(u + c * p.d4, o + j * p.d4, p.d4);
        if (lane == 0) sum += log_sigmoid(x);
      }
    }
    float neg = 0.0f;
    for (int s = threadIdx.x; s < chunk; s += kThreads) {
      for (int c0 = 0; c0 < sh.centers; c0 += kCenterTile) {
        float acc[kCenterTile];
        negative_logits<T>(p, u, vneg + s * p.vstride, c0, acc);
#pragma unroll
        for (int i = 0; i < kCenterTile; ++i)
          if (c0 + i < sh.centers) neg += log_sigmoid(-acc[i]);
      }
    }
    sum = fmaf(sh.neg_weight, neg, sum);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    if (lane == 0) red[warp] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.0f;
      for (int i = 0; i < kWarps; ++i) total += red[i];
      partial[w] = first ? total : partial[w] + total;
    }
  }
}

// loss = -(sum of partial) / count, summed in one fixed order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const float* __restrict__ partial, int32_t n,
                       double count, float* __restrict__ loss) {
  __shared__ double buf[kReduceThreads];
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) s += (double)partial[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int m = kReduceThreads / 2; m > 0; m >>= 1) {
    if (threadIdx.x < m) buf[threadIdx.x] += buf[threadIdx.x + m];
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[0] = (float)(-buf[0] / count);
}

// --- K6 ----------------------------------------------------------------------

// ACC_D columns (d = lane + 32 * j) by ACC_S rows (s = warp + kWarps * i) of
// the negatives' gradient a thread.
template <typename T, int ACC_D>
__global__ void __launch_bounds__(kThreads, 1)
walk_sgns_loss_bwd_kernel(LossShape sh, const int32_t* __restrict__ walks,
                          const T* __restrict__ in_emb,
                          const T* __restrict__ out_emb,
                          const int32_t* __restrict__ neg_ids, int chunk,
                          int first, const float* __restrict__ grad_loss,
                          float* __restrict__ grad_in,
                          float* __restrict__ grad_out) {
  constexpr int ACC_S = kAccPerThread / ACC_D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const Plan p = make_plan(sh.length1, sh.dim, sh.hw, chunk, sizeof(T), true);
  float* u = smem + p.u;
  float* o = smem + p.o;
  float* du = smem + p.du;
  float* dout = smem + p.dout;
  float* g = smem + p.g;
  float* gp = smem + p.gp;
  int32_t* ids = reinterpret_cast<int32_t*>(smem + p.ids);
  int32_t* nids = reinterpret_cast<int32_t*>(smem + p.nids);
  T* vneg = reinterpret_cast<T*>(smem + p.vneg);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = sh.hw, centers = sh.centers;
  // loss = -(sum of log-sigmoids) / (B * C)
  const float scale =
      grad_loss[0] / ((float)sh.num_walks * (float)centers);
  const float neg_scale = scale * sh.neg_weight;

  float acc_neg[ACC_S][ACC_D];
#pragma unroll
  for (int i = 0; i < ACC_S; ++i)
#pragma unroll
    for (int j = 0; j < ACC_D; ++j) acc_neg[i][j] = 0.0f;

  stage_negatives<T>(p, out_emb, neg_ids, chunk, sh.dim, sh.num_nodes, nids,
                     vneg);
  for (int w = blockIdx.x; w < sh.num_walks; w += gridDim.x) {
    __syncthreads();  // the last walk's scatter is done
    stage_walk<T>(p, sh, walks + (int64_t)w * sh.length1, in_emb, out_emb,
                  first != 0, ids, u, o);
    __syncthreads();

    // 1. dloss/dlogit.  Negatives: g[c][s] = neg_scale * sigmoid(x), zero in
    //    the padding; positives: gp[pair] = -scale * sigmoid(-x).
    for (int s = threadIdx.x; s < p.sc4; s += kThreads) {
      for (int c0 = 0; c0 < p.cpad; c0 += kCenterTile) {
        float acc[kCenterTile];
        negative_logits<T>(p, u, vneg + s * p.vstride, c0, acc);
#pragma unroll
        for (int i = 0; i < kCenterTile; ++i)
          g[(c0 + i) * p.sc4 + s] = (s < chunk && c0 + i < centers)
                                        ? neg_scale * sigmoid(acc[i]) : 0.0f;
      }
    }
    if (first) {
      for (int pr = warp; pr < centers * 2 * hw; pr += kWarps) {
        int c, j;
        pair_of(pr, hw, c, j);
        float x = warp_dot(u + c * p.d4, o + j * p.d4, p.d4);
        if (lane == 0) gp[pr] = -scale * sigmoid(-x);
      }
    }
    __syncthreads();

    // 2. du[c][d] = sum_s g[c][s] * vn[s][d] (+ the positive pairs of c):
    //    one thread per (d, tile of centers).
    const int tiles = p.cpad / kCenterTile;
    for (int item = threadIdx.x; item < sh.dim * tiles; item += kThreads) {
      int tile = item / sh.dim, d = item - tile * sh.dim;
      int c0 = tile * kCenterTile;
      float acc[kCenterTile];
#pragma unroll
      for (int i = 0; i < kCenterTile; ++i) acc[i] = 0.0f;
      for (int s = 0; s < p.sc4; s += 4) {
        float v0 = to_float(vneg[s * p.vstride + d]);
        float v1 = to_float(vneg[(s + 1) * p.vstride + d]);
        float v2 = to_float(vneg[(s + 2) * p.vstride + d]);
        float v3 = to_float(vneg[(s + 3) * p.vstride + d]);
#pragma unroll
        for (int i = 0; i < kCenterTile; ++i) {
          float4 x =
              *reinterpret_cast<const float4*>(g + (c0 + i) * p.sc4 + s);
          acc[i] = fmaf(x.x, v0, fmaf(x.y, v1, fmaf(x.z, v2, fmaf(x.w, v3,
                                                                   acc[i]))));
        }
      }
#pragma unroll
      for (int i = 0; i < kCenterTile; ++i) {
        int c = c0 + i;
        if (c >= centers) break;
        float a = acc[i];
        if (first) {
          for (int k = 0; k < 2 * hw; ++k) {
            int cc, j;
            pair_of(c * 2 * hw + k, hw, cc, j);
            a = fmaf(gp[c * 2 * hw + k], o[j * p.d4 + d], a);
          }
        }
        du[c * p.d4 + d] = a;
      }
    }
    // 3. do[j][d] = sum over the pairs (c, j) of gp * u[c][d].
    if (first) {
      for (int item = threadIdx.x; item < sh.length1 * sh.dim;
           item += kThreads) {
        int j = item / sh.dim, d = item - j * sh.dim;
        float a = 0.0f;
        for (int k = 0; k < 2 * hw; ++k) {
          int off = k < hw ? k - hw : k - hw + 1;
          int c = j - hw - off;
          if (c >= 0 && c < centers)
            a = fmaf(gp[c * 2 * hw + k], u[c * p.d4 + d], a);
        }
        dout[j * p.d4 + d] = a;
      }
    }
    // 4. the negatives' gradient, summed over this block's walks.
    for (int c = 0; c < centers; ++c) {
      float uu[ACC_D];
#pragma unroll
      for (int j = 0; j < ACC_D; ++j) {
        int d = lane + 32 * j;
        uu[j] = d < p.d4 ? u[c * p.d4 + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < ACC_S; ++i) {
        int s = warp + kWarps * i;
        float gs = s < p.sc4 ? g[c * p.sc4 + s] : 0.0f;
#pragma unroll
        for (int j = 0; j < ACC_D; ++j)
          acc_neg[i][j] = fmaf(gs, uu[j], acc_neg[i][j]);
      }
    }
    __syncthreads();

    // 5. one atomic add per row element.
    for (int item = threadIdx.x; item < centers * sh.dim; item += kThreads) {
      int c = item / sh.dim, d = item - c * sh.dim;
      atomicAdd(grad_in + (int64_t)ids[c + hw] * sh.dim + d,
                du[c * p.d4 + d]);
    }
    if (first) {
      for (int item = threadIdx.x; item < sh.length1 * sh.dim;
           item += kThreads) {
        int j = item / sh.dim, d = item - j * sh.dim;
        atomicAdd(grad_out + (int64_t)ids[j] * sh.dim + d,
                  dout[j * p.d4 + d]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ACC_S; ++i) {
    int s = warp + kWarps * i;
#pragma unroll
    for (int j = 0; j < ACC_D; ++j) {
      int d = lane + 32 * j;
      if (s < chunk && d < sh.dim)
        atomicAdd(grad_out + (int64_t)nids[s] * sh.dim + d, acc_neg[i][j]);
    }
  }
}

// --- launch ------------------------------------------------------------------

// Columns of the K6 register tile for this width: 4 (D <= 128) or 16
// (D <= 512); one kernel is compiled for each.
inline int acc_columns(int dim) {
  int d4 = round_up(dim, 4);
  return d4 <= 128 ? 4 : d4 <= 512 ? 16 : 0;
}

// Largest chunk of the shared negatives one launch can take, 0 if none.
inline int chunk_size(int length1, int dim, int hw, int num_neg_ids,
                      int elem_bytes, bool backward) {
  if (length1 - 2 * hw < 1 || dim < 1 || num_neg_ids < 1) return 0;
  int chunk = num_neg_ids;
  if (backward) {
    int cols = acc_columns(dim);
    if (cols == 0) return 0;
    int cap = kAccPerThread / cols * kWarps;
    chunk = chunk < cap ? chunk : cap;
  }
  size_t limit = (size_t)max_shared_bytes();
  while (chunk >= 1 &&
         make_plan(length1, dim, hw, chunk, elem_bytes, backward).bytes > limit)
    chunk = chunk > 4 ? round_up(chunk / 2, 4) : chunk - 1;
  return chunk < 1 ? 0 : chunk;
}

template <typename K>
inline cudaError_t grid_for(K kernel, size_t smem, int num_walks, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int64_t want = (int64_t)sms * per_sm;
  *grid = (int)(want < num_walks ? want : num_walks);
  return cudaSuccess;
}

template <typename T>
int launch_fwd(const LossShape& sh, const int32_t* walks, const void* in_emb,
               const void* out_emb, const int32_t* neg_ids, int num_neg_ids,
               float* partial, float* loss, cudaStream_t stream) {
  int chunk = chunk_size(sh.length1, sh.dim, sh.hw, num_neg_ids, sizeof(T),
                         false);
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  auto kernel = walk_sgns_loss_fwd_kernel<T>;
  for (int s0 = 0; s0 < num_neg_ids; s0 += chunk) {
    int n = num_neg_ids - s0 < chunk ? num_neg_ids - s0 : chunk;
    size_t smem =
        make_plan(sh.length1, sh.dim, sh.hw, n, sizeof(T), false).bytes;
    int grid = 0;
    cudaError_t err = grid_for(kernel, smem, sh.num_walks, &grid);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, stream>>>(
        sh, walks, (const T*)in_emb, (const T*)out_emb, neg_ids + s0, n,
        s0 == 0, partial);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)launch_reduce_partials(
      partial, sh.num_walks, (double)sh.num_walks * (double)sh.centers, loss,
      stream);
}

template <typename T, int ACC_D>
int launch_bwd(const LossShape& sh, const int32_t* walks, const void* in_emb,
               const void* out_emb, const int32_t* neg_ids, int num_neg_ids,
               const float* grad_loss, float* grad_in, float* grad_out,
               cudaStream_t stream) {
  int chunk = chunk_size(sh.length1, sh.dim, sh.hw, num_neg_ids, sizeof(T),
                         true);
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  auto kernel = walk_sgns_loss_bwd_kernel<T, ACC_D>;
  for (int s0 = 0; s0 < num_neg_ids; s0 += chunk) {
    int n = num_neg_ids - s0 < chunk ? num_neg_ids - s0 : chunk;
    size_t smem =
        make_plan(sh.length1, sh.dim, sh.hw, n, sizeof(T), true).bytes;
    int grid = 0;
    cudaError_t err = grid_for(kernel, smem, sh.num_walks, &grid);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, stream>>>(
        sh, walks, (const T*)in_emb, (const T*)out_emb, neg_ids + s0, n,
        s0 == 0, grad_loss, grad_in, grad_out);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <typename T>
int launch_bwd_for_dim(const LossShape& sh, const int32_t* walks,
                       const void* in_emb, const void* out_emb,
                       const int32_t* neg_ids, int num_neg_ids,
                       const float* grad_loss, float* grad_in, float* grad_out,
                       cudaStream_t stream) {
  switch (acc_columns(sh.dim)) {
    case 4:
      return launch_bwd<T, 4>(sh, walks, in_emb, out_emb, neg_ids, num_neg_ids,
                              grad_loss, grad_in, grad_out, stream);
    case 16:
      return launch_bwd<T, 16>(sh, walks, in_emb, out_emb, neg_ids,
                               num_neg_ids, grad_loss, grad_in, grad_out,
                               stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

inline LossShape make_shape(int32_t num_walks, int32_t length1,
                            int32_t num_nodes, int32_t dim, int32_t hw,
                            int32_t num_neg_ids, float num_neg) {
  return LossShape{num_walks, length1, num_nodes, dim, hw, length1 - 2 * hw,
                   num_neg / (float)num_neg_ids};
}

cudaError_t launch_reduce_partials(const float* partial, int32_t n,
                                   double count, float* loss,
                                   cudaStream_t stream) {
  reduce_partials_kernel<<<1, kReduceThreads, 0, stream>>>(partial, n, count,
                                                           loss);
  return cudaGetLastError();
}

// describe() of the float32 build: one walk a block, K5 and K6 (no third
// kernel).
template <typename K>
int describe_one(K kernel, const LossShape& sh, int num_neg_ids,
                 bool backward, int32_t* row) {
  int chunk = chunk_size(sh.length1, sh.dim, sh.hw, num_neg_ids, 4, backward);
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  size_t smem =
      make_plan(sh.length1, sh.dim, sh.hw, chunk, 4, backward).bytes;
  int grid = 0;
  cudaError_t err = grid_for(kernel, smem, sh.num_walks, &grid);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  int32_t vals[tc::kDescribeInts] = {
      sh.centers, 1, sh.centers, sh.num_walks, chunk,
      (num_neg_ids + chunk - 1) / chunk, 1, (int32_t)smem, per_sm, grid};
  for (int i = 0; i < tc::kDescribeInts; ++i) row[i] = vals[i];
  return (int)cudaSuccess;
}

}  // namespace trw

// The largest number of shared negatives one launch takes at this shape (the
// wrapper's check: 0 means the shape does not fit the kernel at all).
// elem_bytes is 4 (float32 tables) or 2 (bfloat16).
extern "C" int trw_walk_sgns_chunk(int32_t length1, int32_t dim, int32_t hw,
                                   int32_t num_neg_ids, int32_t elem_bytes,
                                   int32_t backward) {
  if (elem_bytes == 2)
    return trw::tc::chunk_size(
        trw::make_shape(1, length1, 1, dim, hw, num_neg_ids, 1.0f),
        num_neg_ids, backward != 0);
  return trw::chunk_size(length1, dim, hw, num_neg_ids, elem_bytes,
                         backward != 0);
}

// Length of K5's float32 partial-sum scratch: one per walk (float32 tables)
// or per tile (bfloat16).
extern "C" int64_t trw_walk_sgns_partials(int32_t num_walks, int32_t length1,
                                          int32_t dim, int32_t hw,
                                          int32_t num_neg_ids,
                                          int32_t elem_bytes) {
  if (elem_bytes == 2)
    return trw::tc::num_partials(
        trw::make_shape(num_walks, length1, 1, dim, hw, num_neg_ids, 1.0f),
        num_neg_ids);
  return num_walks;
}

// How the kernels cut this shape: trw::tc::kDescribeInts ints for each of
// K5, K6's rows pass and K6's negatives pass (the float32 build has no
// third kernel: zeros), as trw::tc::describe lists them.
extern "C" int trw_walk_sgns_describe(int32_t num_walks, int32_t length1,
                                      int32_t num_nodes, int32_t dim,
                                      int32_t hw, int32_t num_neg_ids,
                                      int32_t elem_bytes, int32_t* out) {
  trw::LossShape sh = trw::make_shape(num_walks, length1, num_nodes, dim, hw,
                                      num_neg_ids, 1.0f);
  if (elem_bytes == 2) return trw::tc::describe(sh, num_neg_ids, out);
  if (elem_bytes != 4) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3 * trw::tc::kDescribeInts; ++i) out[i] = 0;
  int err = trw::describe_one(trw::walk_sgns_loss_fwd_kernel<float>, sh,
                              num_neg_ids, false, out);
  if (err != 0) return err;
  int cols = trw::acc_columns(dim);
  return cols == 4 ? trw::describe_one(
                         trw::walk_sgns_loss_bwd_kernel<float, 4>, sh,
                         num_neg_ids, true, out + trw::tc::kDescribeInts)
         : cols == 16 ? trw::describe_one(
                            trw::walk_sgns_loss_bwd_kernel<float, 16>, sh,
                            num_neg_ids, true, out + trw::tc::kDescribeInts)
                      : (int)cudaErrorInvalidValue;
}

// K5.  partial is float32 scratch of trw_walk_sgns_partials floats, loss one
// float32.
extern "C" int trw_walk_sgns_loss_fwd(
    const int32_t* walks, int32_t num_walks, int32_t length1,
    const void* in_emb, const void* out_emb, int32_t num_nodes, int32_t dim,
    int32_t elem_bytes, const int32_t* neg_ids, int32_t num_neg_ids,
    int32_t hw, float num_neg, float* partial, float* loss, void* stream) {
  trw::LossShape sh = trw::make_shape(num_walks, length1, num_nodes, dim, hw,
                                      num_neg_ids, num_neg);
  if (elem_bytes == 4)
    return trw::launch_fwd<float>(sh, walks, in_emb, out_emb, neg_ids,
                                  num_neg_ids, partial, loss,
                                  (cudaStream_t)stream);
  if (elem_bytes == 2)
    return trw::tc::launch_fwd(sh, walks, in_emb, out_emb, neg_ids,
                               num_neg_ids, partial, loss,
                               (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// K6.  grad_in and grad_out are (num_nodes, dim) float32, zeroed by the
// caller; grad_loss is the float32 gradient of the loss, on the device.
extern "C" int trw_walk_sgns_loss_bwd(
    const int32_t* walks, int32_t num_walks, int32_t length1,
    const void* in_emb, const void* out_emb, int32_t num_nodes, int32_t dim,
    int32_t elem_bytes, const int32_t* neg_ids, int32_t num_neg_ids,
    int32_t hw, float num_neg, const float* grad_loss, float* grad_in,
    float* grad_out, void* stream) {
  trw::LossShape sh = trw::make_shape(num_walks, length1, num_nodes, dim, hw,
                                      num_neg_ids, num_neg);
  if (elem_bytes == 4)
    return trw::launch_bwd_for_dim<float>(sh, walks, in_emb, out_emb, neg_ids,
                                          num_neg_ids, grad_loss, grad_in,
                                          grad_out, (cudaStream_t)stream);
  if (elem_bytes == 2)
    return trw::tc::launch_bwd(sh, walks, in_emb, out_emb, neg_ids,
                               num_neg_ids, grad_loss, grad_in, grad_out,
                               (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
