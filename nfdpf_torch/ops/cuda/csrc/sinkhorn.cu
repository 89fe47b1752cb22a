// Streaming-Sinkhorn kernels for NVIDIA Hopper (sm_90a).
//
// Both kernels work on a cost that is never stored:
//   C_ij = 0.5 * ||x_i - y_j||^2 / eps_b,   x, y in R^2,
// recomputed from the coordinates wherever a tile of it is needed, so device
// memory traffic is O((N + M) * d) per call instead of O(N * M).
//
// lse_kernel<G,...>  replaces nfdpf_tpu/ops/pallas/sinkhorn_pallas.py::_lse_kernel
//   out[b,g,i] = logsumexp_j( f[b,g,j] - 0.5*||x_i - y_j||^2 / eps_b )
//   for G potential vectors that share one distance computation.
// apply_kernel<...>  replaces nfdpf_tpu/ops/pallas/sinkhorn_pallas.py::_apply_kernel
//   out[b,i,:] = sum_j exp( r_i + c_j - 0.5*||x_i - y_j||^2 / eps_b ) * v[b,j,:]
//   (T @ v with T implicit; its VJP is the same kernel with rows and columns
//   swapped, launched from the torch.autograd.Function in sinkhorn_cuda.py).
// sinkhorn_update_kernel (below) is the rest of one iteration of the loop
// that drives K1 (ot_resample_pallas's while_loop body after the softmin),
// so that k iterations of (K1, update) can be replayed in a CUDA graph.
//
// What bounds them on an H100.  The work is N*M*(7 + 4*G) (lse) or N*M*14
// (apply) fp32 operations and one expf per group per pair, against
// O((N + M) * d) bytes: the operation bound (67 TFLOP/s) is the larger one,
// and in practice the special-function unit (one ex2 per expf) and the fp32
// pipe that expands precise expf set the pace.  At the filter's N = 100 a call is little more than
// a launch; what matters there is that the few pairs are spread over the
// whole card and that no thread waits on a chain of dependent expf.
//
// The design (one decomposition for both kernels):
//   * columns across lanes, rows across warps.  A warp owns R consecutive
//     rows; its 32 lanes stride the columns of a tile staged in shared
//     memory, C columns per lane and tile.  A lane holds R*G (lse) or R
//     (apply) independent partial results, so R*G*C expf are in flight per
//     thread with no dependency between them;
//   * lse, one tile (M <= 128, the filter's case): a two-pass logsumexp in
//     registers.  All values of the tile, their maximum by a lane-local max
//     and a 5-step xor butterfly, then the sum of expf(v - max) and a second
//     butterfly.  No rescale at all;
//   * lse, many tiles: the tile-wise recurrence of the TPU kernel, kept per
//     lane.  Per tile a lane takes the maximum of its C values, rescales its
//     running sum ONCE (s * expf(m - new_m)) and adds C independent expf.
//     The lanes' (max, sum) pairs are merged by two butterflies after the
//     last tile, so the sweep itself has no shuffle;
//   * apply: each lane accumulates (ax, ay) for its R rows over its columns;
//     one butterfly per row after the last tile;
//   * few rows, many columns: CS warps share a row group and split every
//     tile's columns; their pairs or partial sums are merged through shared
//     memory in the order cs = 0..CS-1.  The launcher picks CS in {1, 2, 4}
//     so that the grid holds at least two blocks per SM where the shape
//     allows it.  Every reduction has a fixed order and there is no atomic:
//     the same launch gives the same bits;
//   * staging: at M <= 128 the whole column set is staged once.  Beyond, the
//     tiles are double-buffered with cp.async: the copy of tile t+1 is issued
//     right after the one barrier of tile t and lands while tile t is swept;
//   * the ragged last tile is filled with f = -inf (lse) or c = -inf, v = 0
//     (apply), so the sweep has no bounds test; maxima of -inf are guarded
//     (no inf - inf);
//   * precise expf/logf (no fast-math, no __expf): the Sinkhorn loop's
//     stopping test must fire on the same iteration as the plain version's.
//     -0.5*d2/eps is a multiplication by a per-batch -0.5/eps (one IEEE
//     division per thread, none per pair): against a division per pair it
//     gave the same errors and the same stopping iterations and was 25-45 %
//     faster at large M (PERF.md has the timing of both).
// Not used, and why: TMA wants 2-D boxes of at least 16 bytes a row and pays
// off for tiles of tens of KB, these are 1-D runs of 1-4 KB; tensor cores
// would take the product T @ v, which has 2 output columns and 4 of the 14
// operations per pair, while the rest is distance arithmetic and one expf
// per pair that they cannot do.
//
// Registers (ptxas, sm_90a, CUDA 12.8), no spills in any instantiation: lse
// one tile 32; lse many tiles 124-127 (G=2: 64 tile values live per thread)
// and 64-80 (G=1); apply 47-48.  What was tried and what it cost is in
// PERF.md (rows per warp 1-8, columns per lane 2-8, the division per pair,
// the single tile read straight from global memory instead of staged).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
// Tile sizes, settled by timing the alternatives on an H100 (PERF.md).
constexpr int kSmallR = 2;        // M <= 128: rows per warp
constexpr int kSmallRG = 4;       // M <= 128: warps (row groups) per block
constexpr int kSmallC = 4;        // M <= 128: one tile of 32 * 4 columns
constexpr int kLargeR = 4;        // M > 128: rows per warp
constexpr int kLargeC = 8;        // M > 128: columns per lane and tile
constexpr int kLargeWarps = 8;    // M > 128: RG * CS warps per block

// A block is RG row groups x CS column splits, one warp each.  Warp (rg, cs)
// owns rows [row0, row0 + R) and, in every staged tile of 32*CS*C columns,
// the columns cs*32 + lane + k*32*CS for k < C.
template <int R, int RG, int CS, int C>
struct Shape {
  static constexpr int kThreads = 32 * RG * CS;
  static constexpr int kStride = 32 * CS;
  static constexpr int kTile = kStride * C;
  static constexpr int kBlockRows = R * RG;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// exp(v - guarded(m)) stays 0 when both are -inf
__device__ __forceinline__ float guarded(float m) { return m == -INFINITY ? 0.f : m; }

// -C_ij / eps_b from the per-batch scale = -0.5 / eps_b.
__device__ __forceinline__ float neg_cost(float2 xi, float2 yj, float scale) {
  const float dx = xi.x - yj.x;
  const float dy = xi.y - yj.y;
  return (dx * dx + dy * dy) * scale;
}

// ---------------------------------------------------------------------------
// K1: streaming logsumexp
// ---------------------------------------------------------------------------

// Columns [j0, j0 + TILE) of y and f into one shared-memory tile, asynchronously;
// columns past m get y = 0 and f = -inf.
template <int G, int TILE, int THREADS>
__device__ __forceinline__ void stage_lse(float2* ys, float (*fs)[TILE], const float2* yb,
                                          const float* fb, int m, int j0) {
  for (int j = threadIdx.x; j < TILE; j += THREADS) {
    const int col = j0 + j;
    if (col < m) {
      __pipeline_memcpy_async(&ys[j], &yb[col], sizeof(float2));
#pragma unroll
      for (int g = 0; g < G; ++g)
        __pipeline_memcpy_async(&fs[g][j], &fb[(size_t)g * m + col], sizeof(float));
    } else {
      ys[j] = make_float2(0.f, 0.f);
#pragma unroll
      for (int g = 0; g < G; ++g) fs[g][j] = -INFINITY;
    }
  }
}

// ONE: the launcher guarantees m <= kTile (a single tile, CS == 1).
template <int G, int R, int RG, int CS, int C, bool ONE>
__global__ void __launch_bounds__(32 * RG * CS)
lse_kernel(const float* __restrict__ eps, const float2* __restrict__ x,
           const float2* __restrict__ y, const float* __restrict__ f,
           float* __restrict__ out, int n, int m) {
  using S = Shape<R, RG, CS, C>;
  static_assert(R * G <= 32, "one lane per output of a warp");
  static_assert(!ONE || CS == 1, "a single tile is not split over warps");
  constexpr int kBufs = ONE ? 1 : 2;
  constexpr int kRed = CS > 1 ? RG * CS * R * G : 1;
  __shared__ __align__(16) float2 ys[kBufs][S::kTile];
  __shared__ __align__(16) float fs[kBufs][G][S::kTile];
  __shared__ float red_m[kRed];
  __shared__ float red_s[kRed];

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = warp / CS;
  const int cs = warp % CS;
  const int row0 = (blockIdx.x * RG + rg) * R;
  const bool live = row0 < n;                  // the same for a whole warp
  const float scale = -0.5f / eps[b];
  const float2* yb = y + (size_t)b * m;
  const float* fb = f + (size_t)b * G * m;

  float2 xr[R];
  float mx[R][G], sum[R][G];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    xr[r] = i < n ? x[(size_t)b * n + i] : make_float2(0.f, 0.f);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mx[r][g] = -INFINITY;
      sum[r][g] = 0.f;
    }
  }

  const int tiles = ONE ? 1 : (m + S::kTile - 1) / S::kTile;
  stage_lse<G, S::kTile, S::kThreads>(ys[0], fs[0], yb, fb, m, 0);
  __pipeline_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = ONE ? 0 : (t & 1);
    __pipeline_wait_prior(0);
    __syncthreads();   // tile t has landed; every warp is done with tile t-1
    if (!ONE && t + 1 < tiles) {
      stage_lse<G, S::kTile, S::kThreads>(ys[kBufs - 1 - buf], fs[kBufs - 1 - buf], yb, fb, m,
                                          (t + 1) * S::kTile);
      __pipeline_commit();
    }
    if (!live) continue;

    float val[R][G][C];
    float top[R][G];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g) top[r][g] = -INFINITY;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = cs * 32 + lane + k * S::kStride;
      const float2 yj = ys[buf][j];
      float fj[G];
#pragma unroll
      for (int g = 0; g < G; ++g) fj[g] = fs[buf][g][j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float nc = neg_cost(xr[r], yj, scale);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float v = fj[g] + nc;
          val[r][g][k] = v;
          top[r][g] = fmaxf(top[r][g], v);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc;
        float new_m;
        if (ONE) {
          new_m = warp_max(top[r][g]);
          acc = 0.f;
        } else {
          new_m = fmaxf(mx[r][g], top[r][g]);
          acc = sum[r][g] * expf(mx[r][g] - guarded(new_m));   // one rescale per tile
        }
        const float ref = guarded(new_m);
#pragma unroll
        for (int k = 0; k < C; ++k) acc += expf(val[r][g][k] - ref);
        mx[r][g] = new_m;
        sum[r][g] = acc;
      }
    }
  }

  // merge the lanes of a warp: after it every lane holds the warp's pair
  if (live) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (!ONE) {
          const float all = warp_max(mx[r][g]);
          sum[r][g] *= expf(mx[r][g] - guarded(all));
          mx[r][g] = all;
        }
        sum[r][g] = warp_sum(sum[r][g]);
      }
    }
  }

  // merge the CS warps of a row group, in the order cs = 0..CS-1
  if (CS > 1) {
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          red_m[((rg * CS + cs) * R + r) * G + g] = mx[r][g];
          red_s[((rg * CS + cs) * R + r) * G + g] = sum[r][g];
        }
    }
    __syncthreads();
    if (cs == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float all = -INFINITY;
#pragma unroll
          for (int c = 0; c < CS; ++c) all = fmaxf(all, red_m[((rg * CS + c) * R + r) * G + g]);
          const float ref = guarded(all);
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < CS; ++c)
            acc += red_s[((rg * CS + c) * R + r) * G + g]
                   * expf(red_m[((rg * CS + c) * R + r) * G + g] - ref);
          mx[r][g] = all;
          sum[r][g] = acc;
        }
    }
  }

  if (live && cs == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (lane == g * R + r && row0 + r < n)
          out[((size_t)b * G + g) * n + row0 + r] = mx[r][g] + logf(sum[r][g]);
  }
}

// ---------------------------------------------------------------------------
// K2: streaming transport apply
// ---------------------------------------------------------------------------

// Columns [j0, j0 + TILE) of y, v and c; columns past m get c = -inf, v = 0.
template <int TILE, int THREADS>
__device__ __forceinline__ void stage_apply(float2* ys, float2* vs, float* cs, const float2* yb,
                                            const float2* vb, const float* cb, int m, int j0) {
  for (int j = threadIdx.x; j < TILE; j += THREADS) {
    const int col = j0 + j;
    if (col < m) {
      __pipeline_memcpy_async(&ys[j], &yb[col], sizeof(float2));
      __pipeline_memcpy_async(&vs[j], &vb[col], sizeof(float2));
      __pipeline_memcpy_async(&cs[j], &cb[col], sizeof(float));
    } else {
      ys[j] = make_float2(0.f, 0.f);
      vs[j] = make_float2(0.f, 0.f);
      cs[j] = -INFINITY;
    }
  }
}

template <int R, int RG, int CS, int C>
__global__ void __launch_bounds__(32 * RG * CS)
apply_kernel(const float* __restrict__ eps, const float2* __restrict__ x,
             const float2* __restrict__ y, const float2* __restrict__ v,
             const float* __restrict__ r, const float* __restrict__ c,
             float2* __restrict__ out, int n, int m) {
  using S = Shape<R, RG, CS, C>;
  constexpr int kRed = CS > 1 ? RG * CS * R : 1;
  __shared__ __align__(16) float2 ys[2][S::kTile];
  __shared__ __align__(16) float2 vs[2][S::kTile];
  __shared__ __align__(16) float cols[2][S::kTile];
  __shared__ float2 red[kRed];

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = warp / CS;
  const int cs = warp % CS;
  const int row0 = (blockIdx.x * RG + rg) * R;
  const bool live = row0 < n;                  // the same for a whole warp
  const float scale = -0.5f / eps[b];
  const float2* yb = y + (size_t)b * m;
  const float2* vb = v + (size_t)b * m;
  const float* cb = c + (size_t)b * m;

  float2 xr[R];
  float rr[R], ax[R], ay[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = row0 + q;
    xr[q] = i < n ? x[(size_t)b * n + i] : make_float2(0.f, 0.f);
    rr[q] = i < n ? r[(size_t)b * n + i] : 0.f;
    ax[q] = 0.f;
    ay[q] = 0.f;
  }

  const int tiles = (m + S::kTile - 1) / S::kTile;
  stage_apply<S::kTile, S::kThreads>(ys[0], vs[0], cols[0], yb, vb, cb, m, 0);
  __pipeline_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    __pipeline_wait_prior(0);
    __syncthreads();   // tile t has landed; every warp is done with tile t-1
    if (t + 1 < tiles) {
      stage_apply<S::kTile, S::kThreads>(ys[buf ^ 1], vs[buf ^ 1], cols[buf ^ 1], yb, vb, cb, m,
                                         (t + 1) * S::kTile);
      __pipeline_commit();
    }
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = cs * 32 + lane + k * S::kStride;
      const float2 yj = ys[buf][j];
      const float2 vj = vs[buf][j];
      const float cj = cols[buf][j];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float w = expf(rr[q] + cj + neg_cost(xr[q], yj, scale));
        ax[q] += w * vj.x;
        ay[q] += w * vj.y;
      }
    }
  }

  if (live) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      ax[q] = warp_sum(ax[q]);
      ay[q] = warp_sum(ay[q]);
    }
  }

  // sum the CS warps of a row group, in the order cs = 0..CS-1
  if (CS > 1) {
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < R; ++q) red[(rg * CS + cs) * R + q] = make_float2(ax[q], ay[q]);
    }
    __syncthreads();
    if (cs == 0) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        float sx = 0.f, sy = 0.f;
#pragma unroll
        for (int p = 0; p < CS; ++p) {
          sx += red[(rg * CS + p) * R + q].x;
          sy += red[(rg * CS + p) * R + q].y;
        }
        ax[q] = sx;
        ay[q] = sy;
      }
    }
  }

  if (live && cs == 0) {
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (lane == q && row0 + q < n) out[(size_t)b * n + row0 + q] = make_float2(ax[q], ay[q]);
  }
}

// ---------------------------------------------------------------------------
// The fused update: everything of a Sinkhorn iteration after K1
// ---------------------------------------------------------------------------
//
// Replaces the rest of the body of the while_loop in
// nfdpf_tpu/ops/pallas/sinkhorn_pallas.py::ot_resample_pallas (body_fn and
// cond_fn): from K1's logsumexps it makes the softmins -eps*lse, the
// damped potentials where(run, ., old) halved with the old ones, the
// per-row max |delta| of both (NaN propagated, as torch.amax does), the
// new eps = max(eps*scaling^2, eps_target), the new running flags, the loop
// counter and the done flag !(i + 1 < max_iter - 1 && agg(running)), agg
// all or any over the batch, and the next iteration's K1 input
// fs = [logw + b_x/eps, -log n + a_y/eps] in place.  With `freeze` set it
// returns at once once the flag is set, so a CUDA graph of k iterations
// stops on the loop's own iteration and the state stays what it was.
// The arithmetic is torch's, operation for operation (__fmul_rn,
// __fadd_rn, __fdiv_rn: no contraction into fma), so the potentials and
// the iteration count are the eager loop's bit for bit.
// A block per batch row (threads over its N columns); the batch-wide
// aggregate is taken by the last block to arrive (an atomic counter; the
// AND or OR is order-free, so the bits do not depend on the order).  What
// bounds it: ~9 floats moved per (row, column), O(B·N) bytes; at the
// filter's sizes a launch's latency.

struct LoopState {
  int done, iters, agg;
  unsigned arrived;
};

// max with NaN propagated (torch.amax / torch.maximum)
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

__global__ void __launch_bounds__(1024)
sinkhorn_update_kernel(const float* __restrict__ lse, float* __restrict__ a_y,
                       float* __restrict__ b_x, unsigned char* running, float* eps_run,
                       const float* __restrict__ eps_target, const float* __restrict__ logw,
                       float* __restrict__ fs, LoopState* state, int n, float neg_log_n,
                       float threshold, float scaling_factor, int max_iter, int any,
                       int freeze) {
  __shared__ float red[2][32];
  if (freeze && state->done) return;
  const int row = blockIdx.x, t = threadIdx.x;
  const float e = eps_run[row];
  const bool run = running[row] != 0;
  const float target = eps_target[row];
  const float scaled = __fmul_rn(e, scaling_factor);
  const float new_eps = scaled != scaled ? scaled : target != target ? target
                        : (scaled > target ? scaled : target);
  const float neg_e = -e;
  const size_t base = (size_t)row * n;
  const float* lse_a = lse + 2 * base;   // group 0: the softmin that updates a_y
  const float* lse_b = lse_a + n;        // group 1: b_x
  float* fs_a = fs + 2 * base;
  float* fs_b = fs_a + n;
  float da = 0.f, db = 0.f;
  for (int i = t; i < n; i += blockDim.x) {
    const float a = a_y[base + i], b = b_x[base + i];
    const float at = run ? __fmul_rn(neg_e, lse_a[i]) : a;
    const float bt = run ? __fmul_rn(neg_e, lse_b[i]) : b;
    const float an = __fmul_rn(__fadd_rn(a, at), 0.5f);
    const float bn = __fmul_rn(__fadd_rn(b, bt), 0.5f);
    da = nan_max(da, fabsf(__fsub_rn(an, a)));
    db = nan_max(db, fabsf(__fsub_rn(bn, b)));
    a_y[base + i] = an;
    b_x[base + i] = bn;
    fs_a[i] = __fadd_rn(logw[base + i], __fdiv_rn(bn, new_eps));
    fs_b[i] = __fadd_rn(neg_log_n, __fdiv_rn(an, new_eps));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    da = nan_max(da, __shfl_xor_sync(kFullMask, da, o));
    db = nan_max(db, __shfl_xor_sync(kFullMask, db, o));
  }
  const int warps = blockDim.x / 32;
  if (t % 32 == 0) {
    red[0][t / 32] = da;
    red[1][t / 32] = db;
  }
  __syncthreads();
  if (t != 0) return;
  for (int w = 1; w < warps; ++w) {
    da = nan_max(da, red[0][w]);
    db = nan_max(db, red[1][w]);
  }
  const bool local = da > threshold || db > threshold;
  running[row] = (new_eps < e || local) ? 1 : 0;
  eps_run[row] = new_eps;
  __threadfence();
  if (atomicAdd(&state->arrived, 1u) != gridDim.x - 1) return;
  // the last block to arrive: every row's flag is written
  __threadfence();
  const volatile unsigned char* flags = running;
  bool agg = !any;
  for (int r = 0; r < (int)gridDim.x; ++r) agg = any ? (agg || flags[r]) : (agg && flags[r]);
  const int it = state->iters + 1;
  state->iters = it;
  state->agg = agg ? 1 : 0;
  state->done = (it < max_iter - 1 && agg) ? 0 : 1;
  state->arrived = 0u;
}

// Returns at once: its device time is the floor under any launch.
__global__ void empty_kernel() {}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || sms <= 0)
      sms = 132;
  }
  return sms;
}

// Column splits for M > 128: the fewest of {1, 2, 4} that give the grid two
// blocks per SM, as long as a split tile still fits into the columns.
int pick_split(int b, int n, int m) {
  int cs = 1;
  while (cs < 4) {
    const int block_rows = kLargeR * (kLargeWarps / cs);
    const long blocks = (long)((n + block_rows - 1) / block_rows) * b;
    if (blocks >= 2L * sm_count() || 32 * (2 * cs) * kLargeC > m) break;
    cs *= 2;
  }
  return cs;
}

template <int R, int RG>
dim3 grid_for(int b, int n) {
  return dim3((n + R * RG - 1) / (R * RG), b);
}

template <int G, int CS>
void launch_lse_large(cudaStream_t s, const float* eps, const float2* x, const float2* y,
                      const float* f, float* out, int b, int n, int m) {
  constexpr int R = kLargeR, RG = kLargeWarps / CS;
  lse_kernel<G, R, RG, CS, kLargeC, false>
      <<<grid_for<R, RG>(b, n), 32 * kLargeWarps, 0, s>>>(eps, x, y, f, out, n, m);
}

template <int G>
void launch_lse(cudaStream_t s, const float* eps, const float2* x, const float2* y,
                const float* f, float* out, int b, int n, int m) {
  if (m <= 32 * kSmallC) {
    constexpr int R = kSmallR, RG = kSmallRG;
    lse_kernel<G, R, RG, 1, kSmallC, true>
        <<<grid_for<R, RG>(b, n), 32 * RG, 0, s>>>(eps, x, y, f, out, n, m);
    return;
  }
  switch (pick_split(b, n, m)) {
    case 1: launch_lse_large<G, 1>(s, eps, x, y, f, out, b, n, m); break;
    case 2: launch_lse_large<G, 2>(s, eps, x, y, f, out, b, n, m); break;
    default: launch_lse_large<G, 4>(s, eps, x, y, f, out, b, n, m); break;
  }
}

template <int CS>
void launch_apply_large(cudaStream_t s, const float* eps, const float2* x, const float2* y,
                        const float2* v, const float* r, const float* c, float2* out, int b,
                        int n, int m) {
  constexpr int R = kLargeR, RG = kLargeWarps / CS;
  apply_kernel<R, RG, CS, kLargeC>
      <<<grid_for<R, RG>(b, n), 32 * kLargeWarps, 0, s>>>(eps, x, y, v, r, c, out, n, m);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on the caller's
// stream and returns cudaGetLastError() right after the launch; shapes,
// types, devices and contiguity are checked by the Python wrapper.

extern "C" int nfdpf_sinkhorn_lse(const float* eps, const float* x, const float* y,
                                  const float* f, float* out, int b, int n, int m,
                                  int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* x2 = reinterpret_cast<const float2*>(x);
  const float2* y2 = reinterpret_cast<const float2*>(y);
  if (groups == 1) {
    launch_lse<1>(s, eps, x2, y2, f, out, b, n, m);
  } else if (groups == 2) {
    launch_lse<2>(s, eps, x2, y2, f, out, b, n, m);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nfdpf_transport_apply(const float* eps, const float* x, const float* y,
                                     const float* v, const float* r, const float* c,
                                     float* out, int b, int n, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* x2 = reinterpret_cast<const float2*>(x);
  const float2* y2 = reinterpret_cast<const float2*>(y);
  const float2* v2 = reinterpret_cast<const float2*>(v);
  float2* out2 = reinterpret_cast<float2*>(out);
  if (m <= 32 * kSmallC) {
    constexpr int R = kSmallR, RG = kSmallRG;
    apply_kernel<R, RG, 1, kSmallC>
        <<<grid_for<R, RG>(b, n), 32 * RG, 0, s>>>(eps, x2, y2, v2, r, c, out2, n, m);
  } else {
    switch (pick_split(b, n, m)) {
      case 1: launch_apply_large<1>(s, eps, x2, y2, v2, r, c, out2, b, n, m); break;
      case 2: launch_apply_large<2>(s, eps, x2, y2, v2, r, c, out2, b, n, m); break;
      default: launch_apply_large<4>(s, eps, x2, y2, v2, r, c, out2, b, n, m); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// One Sinkhorn iteration's update after K1 (sinkhorn_update_kernel) on a
// batch of `b` rows of `n` particles; `state` holds the LoopState (4 ints).
extern "C" int nfdpf_sinkhorn_update(const float* lse, float* a_y, float* b_x,
                                     unsigned char* running, float* eps_run,
                                     const float* eps_target, const float* logw, float* fs,
                                     int* state, int b, int n, float neg_log_n, float threshold,
                                     float scaling_factor, int max_iter, int any, int freeze,
                                     void* stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = n >= 1024 ? 1024 : (n + 31) / 32 * 32;
  sinkhorn_update_kernel<<<b, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      lse, a_y, b_x, running, eps_run, eps_target, logw, fs,
      reinterpret_cast<LoopState*>(state), n, neg_log_n, threshold, scaling_factor, max_iter,
      any, freeze);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on `blocks` x `threads`, launched like the two above.
extern "C" int nfdpf_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
