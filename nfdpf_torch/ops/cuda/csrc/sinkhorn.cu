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
// sinkhorn_update_batch_kernel / sinkhorn_update_kernel (below) are the rest
// of one iteration of the loop that drives K1 (ot_resample_pallas's
// while_loop body after the softmin), so that k iterations of (K1, update)
// can be replayed in a CUDA graph.
//
// What bounds them on an H100.  The work is N*M*(7 + 4*G) (lse) or N*M*14
// (apply) fp32 operations and one exponential per group per pair, against
// O((N + M) * d) bytes: the operation bound (67 TFLOP/s) is the larger one,
// and in practice instruction issue and the special-function unit (16 ex2
// a clock per SM) set the pace.  K2 takes a precise expf, which the fp32
// pipe expands around the unit's ex2; K1 works in base 2 (below), so that a
// term is one ex2 and nothing around it.  At the filter's N = 100 a call
// is little more than a launch; what matters there is that the few pairs
// are spread over the whole card and that no thread waits on a chain of
// dependent exponentials.
//
// The design (one decomposition for both kernels):
//   * columns across lanes, rows across warps.  A warp owns R consecutive
//     rows; its 32 lanes stride the columns of a tile staged in shared
//     memory, C columns per lane and tile.  A lane holds R*G (lse) or R
//     (apply) independent partial results, so its exponentials have no
//     dependency between them;
//   * lse in base 2: a lane turns each column's potentials into base 2 as
//     it reads them, f2 = f*log2(e) (once per column, shared by its R
//     rows), and a batch's scale is -log2(e)/(2 eps_b); a pair's value is
//     v = fma(d2, scale2, f2) and its term 2^(v - max), one ex2 with no range
//     reduction, since v - max <= 0.  The output is max*ln(2) + log(sum).
//     The base change adds one rounding (of f2) of the size of the one
//     v = f + nc carried before; the ex2 has expf's 2-ulp bound;
//   * lse, one tile (M <= 128, the filter's case): a two-pass logsumexp in
//     registers.  All values of the tile, their maximum by a lane-local max
//     and a 5-step xor butterfly, then the sum of 2^(v - max) and a second
//     butterfly.  No rescale at all;
//   * lse, many tiles: the tile-wise recurrence of the TPU kernel, kept per
//     lane.  Per tile a lane takes the maximum of its C values, rescales its
//     running sum ONCE (s * 2^(m - new_m)) and adds C independent terms.
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
//   * no fast-math and no __expf (whose error grows with |x|): the Sinkhorn
//     loop's stopping test must fire on the same iteration as the plain
//     version's.  K1's ex2 and K2's precise expf keep 2 ulp, logf is
//     precise.  The cost's 1/eps is a multiplication by a per-batch scale
//     (one IEEE division per thread, none per pair): against a division per
//     pair it gave the same errors and the same stopping iterations and was
//     25-45 % faster at large M (PERF.md has the timing of both).
// Not used, and why: TMA wants 2-D boxes of at least 16 bytes a row and pays
// off for tiles of tens of KB, these are 1-D runs of 1-4 KB; tensor cores
// would take the product T @ v, which has 2 output columns and 4 of the 14
// operations per pair, while the rest is distance arithmetic and one
// exponential per pair that they cannot do.
//
// Registers (ptxas, sm_90a), no spills in any instantiation: lse one tile
// 32-40; lse many tiles 128 (G=2) and 96 (G=1), at 8 rows a warp, 8
// columns a lane and 4 warps a block, the fastest of the tiles timed at
// (8, 10240), (4, 4097) and (4, 5120 x 10240); apply 47-48.  What was tried
// and what it cost is in PERF.md (rows per warp 1-16, columns per lane 2-8,
// warps per block 4-8, the division per pair, the single tile read straight
// from global memory instead of staged).

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#include "launch_note.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
// Tile sizes, settled by timing the alternatives on an H100 (PERF.md).
constexpr int kSmallR = 2;        // M <= 128: rows per warp
constexpr int kSmallRG = 4;       // M <= 128: warps (row groups) per block
constexpr int kSmallC = 4;        // M <= 128: one tile of 32 * 4 columns
constexpr int kLargeR = 4;        // K2, M > 128: rows per warp
constexpr int kLargeC = 8;        // K2, M > 128: columns per lane and tile
constexpr int kLargeWarps = 8;    // K2, M > 128: RG * CS warps per block
constexpr int kLseR = 8;          // K1, M > 128: rows per warp
constexpr int kLseC = 8;          // K1, M > 128: columns per lane and tile
constexpr int kLseWarps = 4;      // K1, M > 128: RG * CS warps per block

constexpr float kLog2e = 1.4426950408889634f;   // log2(e)
constexpr float kLn2 = 0.6931471805599453f;     // ln(2)

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

// ||x_i - y_j||^2
__device__ __forceinline__ float sq_dist(float2 xi, float2 yj) {
  const float dx = xi.x - yj.x;
  const float dy = xi.y - yj.y;
  return fmaf(dx, dx, dy * dy);
}

// 2^t for t <= 0 on the special-function unit: ex2.approx.ftz.f32 is the
// instruction exp2f compiles to (2 ulp), without exp2f's scaling around it
// for results below 2^-126, which are flushed to zero here.  K1 adds 2^t to
// a sum that holds its largest term, 2^0 = 1, so such a term is below the
// sum's ulp and adds nothing either way.
__device__ __forceinline__ float ex2(float t) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(t));
  return e;
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
  const float scale2 = -0.5f * kLog2e / eps[b];   // -log2(e) / (2 eps_b)
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

    // the lane's C columns, their potentials in base 2, shared by its R rows
    float2 yk[C];
    float fk[G][C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = cs * 32 + lane + k * S::kStride;
      yk[k] = ys[buf][j];
#pragma unroll
      for (int g = 0; g < G; ++g) fk[g][k] = fs[buf][g][j] * kLog2e;
    }
    // a row at a time: its values and maxima, then its terms, so that one
    // row's ex2 (special-function unit) overlap the next row's distances
    // (fp32 pipe) in the compiler's schedule
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float val[G][C];
      float top[G];
#pragma unroll
      for (int g = 0; g < G; ++g) top[g] = -INFINITY;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const float d2 = sq_dist(xr[r], yk[k]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          val[g][k] = fmaf(d2, scale2, fk[g][k]);
          top[g] = fmaxf(top[g], val[g][k]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc;
        float new_m;
        if (ONE) {
          new_m = warp_max(top[g]);
          acc = 0.f;
        } else {
          new_m = fmaxf(mx[r][g], top[g]);
          acc = sum[r][g] * ex2(mx[r][g] - guarded(new_m));   // one rescale per tile
        }
        const float ref = guarded(new_m);
#pragma unroll
        for (int k = 0; k < C; ++k) acc += ex2(val[g][k] - ref);
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
          sum[r][g] *= ex2(mx[r][g] - guarded(all));
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
                   * ex2(red_m[((rg * CS + c) * R + r) * G + g] - ref);
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
          out[((size_t)b * G + g) * n + row0 + r] = fmaf(mx[r][g], kLn2, logf(sum[r][g]));
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
// What bounds it: ~9 floats moved per (row, column), O(B·N) bytes; at the
// filter's sizes a launch's latency and the dependent round trips to memory
// inside it.  Two kernels, chosen by the wrapper (sinkhorn_cuda.
// update_plan):
//   * sinkhorn_update_batch_kernel, up to 64 rows of up to 256 columns (the
//     filter's (32, 100) and (10, 100)): one block (up to 16 rows) or one
//     thread-block cluster of up to 8 blocks for the whole batch, a warp a
//     row, its lanes over the columns, CPL columns a lane loaded at once
//     together with the loop state, so that the freeze test, the row's
//     scalars and its columns cost one round trip.  A row's max |delta| is
//     a butterfly of the warp; each block's all or any a __syncthreads_and
//     / __syncthreads_or, and a cluster's taken by its first block from
//     parts the others write into its shared memory (distributed shared
//     memory; a cluster barrier before the writes, so that every block is
//     running, and one after): no atomics, no fences through L2.  The
//     former kernel (a block a row, the last block to arrive walking the B
//     flags one by one, B dependent L2 round trips) took twice as long with
//     every row running; one block took 3.6 us at (32, 100), its one SM
//     bound by the rows' divisions and bytes;
//   * sinkhorn_update_kernel, the rest (large N, many rows): a row's N
//     columns split over `splits` blocks (one block a row up to 256
//     columns, else 256-column pieces, as many as bring the grid to about
//     two blocks per SM), a thread a column per pass.  Each block's max
//     |delta| of both potentials (NaN propagated) joins its row's by
//     atomicMax on the float's bits: |delta| >= 0, so the bits order as the
//     values do, and a NaN (positive after fabsf) is above +inf's bits, so
//     NaN still wins.  The last block of the grid to arrive (an atomic
//     counter) finishes every row at once, a thread a row: it takes the
//     row's maxima (and resets them for the next launch with the same
//     atomicExch), writes the flag and the new eps (every block of the
//     launch has read the old ones by then), and takes the batch's all or
//     any with __syncthreads_and / __syncthreads_or.  `row_max` (2 per
//     row) and `arrived` are back at 0 after every launch that ran, so
//     graph replays and repeated launches start alike.
// Max, AND and OR are order-free: the bits do not depend on the order the
// blocks, warps or lanes run in.

struct LoopState {
  int done, iters, agg;
  unsigned arrived;
};

// max with NaN propagated (torch.amax / torch.maximum)
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// max(eps·scaling, target) with NaN propagated (torch.maximum)
__device__ __forceinline__ float next_eps(float e, float target, float scaling_factor) {
  const float scaled = __fmul_rn(e, scaling_factor);
  return scaled != scaled ? scaled : target != target ? target
                          : (scaled > target ? scaled : target);
}

constexpr int kUpdateThreads = 256;   // most threads of an update block
constexpr int kBatchRows = 16;       // most rows (warps) of a block of the batch update
constexpr int kBatchBlocks = 8;      // most blocks of its cluster (the portable cluster size)

template <int CPL>
__global__ void __launch_bounds__(32 * kBatchRows)
sinkhorn_update_batch_kernel(const float* __restrict__ lse, float* __restrict__ a_y,
                             float* __restrict__ b_x, unsigned char* running, float* eps_run,
                             const float* __restrict__ eps_target,
                             const float* __restrict__ logw, float* __restrict__ fs,
                             LoopState* state, int b, int n, int rows_a_block, float neg_log_n,
                             float threshold, float scaling_factor, int max_iter, int any,
                             int freeze) {
  namespace cg = cooperative_groups;
  __shared__ int parts[kBatchBlocks];   // the first block's: each block's all or any
  // a block writes into the first block's shared memory only once every
  // block of the cluster is known to be running: each arrives here and
  // waits just before that store, so the wait overlaps the row's loads
  const bool clustered = gridDim.x > 1;
  if (clustered) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int lane = threadIdx.x % 32, row = blockIdx.x * rows_a_block + threadIdx.x / 32;
  const bool has_row = row < b;
  const int done = state->done, iters = state->iters;
  float e = 0.f, target = 0.f, va[CPL], vb[CPL], la[CPL], lb[CPL], lw[CPL];
  bool run = false;
  const size_t base = (size_t)row * n;
  const float* lse_a = lse + 2 * base;   // group 0: the softmin that updates a_y
  const float* lse_b = lse_a + n;        // group 1: b_x
  if (has_row) {
    e = eps_run[row];
    run = running[row] != 0;
    target = eps_target[row];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int i = lane + 32 * k;
      if (i < n) {
        va[k] = a_y[base + i];
        vb[k] = b_x[base + i];
        la[k] = lse_a[i];
        lb[k] = lse_b[i];
        lw[k] = logw[base + i];
      }
    }
  }
  if (freeze && done) return;   // the same for every block of the cluster
  int flag_all = 1, flag_any = 0;
  if (has_row) {
    const float new_eps = next_eps(e, target, scaling_factor);
    const float neg_e = -e;
    float* fs_a = fs + 2 * base;
    float* fs_b = fs_a + n;
    float da = 0.f, db = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int i = lane + 32 * k;
      if (i < n) {
        const float at = run ? __fmul_rn(neg_e, la[k]) : va[k];
        const float bt = run ? __fmul_rn(neg_e, lb[k]) : vb[k];
        const float an = __fmul_rn(__fadd_rn(va[k], at), 0.5f);
        const float bn = __fmul_rn(__fadd_rn(vb[k], bt), 0.5f);
        da = nan_max(da, fabsf(__fsub_rn(an, va[k])));
        db = nan_max(db, fabsf(__fsub_rn(bn, vb[k])));
        a_y[base + i] = an;
        b_x[base + i] = bn;
        fs_a[i] = __fadd_rn(lw[k], __fdiv_rn(bn, new_eps));
        fs_b[i] = __fadd_rn(neg_log_n, __fdiv_rn(an, new_eps));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      da = nan_max(da, __shfl_xor_sync(kFullMask, da, o));
      db = nan_max(db, __shfl_xor_sync(kFullMask, db, o));
    }
    const int flag = (new_eps < e || da > threshold || db > threshold) ? 1 : 0;
    if (lane == 0) {
      running[row] = static_cast<unsigned char>(flag);
      eps_run[row] = new_eps;
    }
    flag_all = flag_any = flag;
  }
  int agg = any ? __syncthreads_or(flag_any) : __syncthreads_and(flag_all);
  if (clustered) {
    // each block writes its part into the first block's shared memory and
    // arrives at the cluster barrier; the first block waits there (release
    // / acquire: the parts are visible) and takes the batch's all or any,
    // a thread a block (blockDim >= 32 >= blocks); the others are done
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // every block runs
    if (threadIdx.x == 0) *cluster.map_shared_rank(&parts[blockIdx.x], 0) = agg;
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    if (blockIdx.x != 0) return;
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    const int v = threadIdx.x < gridDim.x ? parts[threadIdx.x] : (any ? 0 : 1);
    agg = any ? __syncthreads_or(v) : __syncthreads_and(v);
  }
  if (threadIdx.x == 0) {
    const int it = iters + 1;
    state->iters = it;
    state->agg = agg ? 1 : 0;
    state->done = (it < max_iter - 1 && agg) ? 0 : 1;
  }
}

__global__ void __launch_bounds__(kUpdateThreads)
sinkhorn_update_kernel(const float* __restrict__ lse, float* __restrict__ a_y,
                       float* __restrict__ b_x, unsigned char* running, float* eps_run,
                       const float* __restrict__ eps_target, const float* __restrict__ logw,
                       float* __restrict__ fs, LoopState* state, unsigned* row_max, int b,
                       int n, int splits, int cols, float neg_log_n, float threshold,
                       float scaling_factor, int max_iter, int any, int freeze) {
  __shared__ float red[2][kUpdateThreads / 32];
  __shared__ bool last;
  const int row = blockIdx.x / splits, t = threadIdx.x;
  const int lo = (blockIdx.x % splits) * cols, hi = min(n, lo + cols);
  // the loop state, the row's scalars and the thread's first column in one
  // round trip, before the freeze test
  const int done = state->done, iters = state->iters;
  const float e = eps_run[row];
  const bool run = running[row] != 0;
  const float target = eps_target[row];
  const size_t base = (size_t)row * n;
  const float* lse_a = lse + 2 * base;   // group 0: the softmin that updates a_y
  const float* lse_b = lse_a + n;        // group 1: b_x
  int i = lo + t;
  float a = 0.f, bv = 0.f, la = 0.f, lb = 0.f, lw = 0.f;
  if (i < hi) {
    a = a_y[base + i];
    bv = b_x[base + i];
    la = lse_a[i];
    lb = lse_b[i];
    lw = logw[base + i];
  }
  if (freeze && done) return;
  const float new_eps = next_eps(e, target, scaling_factor);
  const float neg_e = -e;
  float* fs_a = fs + 2 * base;
  float* fs_b = fs_a + n;
  float da = 0.f, db = 0.f;
  while (i < hi) {
    const float at = run ? __fmul_rn(neg_e, la) : a;
    const float bt = run ? __fmul_rn(neg_e, lb) : bv;
    const float an = __fmul_rn(__fadd_rn(a, at), 0.5f);
    const float bn = __fmul_rn(__fadd_rn(bv, bt), 0.5f);
    da = nan_max(da, fabsf(__fsub_rn(an, a)));
    db = nan_max(db, fabsf(__fsub_rn(bn, bv)));
    a_y[base + i] = an;
    b_x[base + i] = bn;
    fs_a[i] = __fadd_rn(lw, __fdiv_rn(bn, new_eps));
    fs_b[i] = __fadd_rn(neg_log_n, __fdiv_rn(an, new_eps));
    i += blockDim.x;
    if (i < hi) {
      a = a_y[base + i];
      bv = b_x[base + i];
      la = lse_a[i];
      lb = lse_b[i];
      lw = logw[base + i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    da = nan_max(da, __shfl_xor_sync(kFullMask, da, o));
    db = nan_max(db, __shfl_xor_sync(kFullMask, db, o));
  }
  if (t % 32 == 0) {
    red[0][t / 32] = da;
    red[1][t / 32] = db;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < (int)blockDim.x / 32; ++w) {
      da = nan_max(da, red[0][w]);
      db = nan_max(db, red[1][w]);
    }
    atomicMax(row_max + 2 * row, __float_as_uint(da));
    atomicMax(row_max + 2 * row + 1, __float_as_uint(db));
    __threadfence();
    last = atomicAdd(&state->arrived, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every block's maxima are in row_max
  __threadfence();
  int all_run = 1, any_run = 0;
  for (int r = t; r < b; r += blockDim.x) {
    const float er = eps_run[r];
    const float ne = next_eps(er, eps_target[r], scaling_factor);
    const float ma = __uint_as_float(atomicExch(row_max + 2 * r, 0u));
    const float mb = __uint_as_float(atomicExch(row_max + 2 * r + 1, 0u));
    const int flag = (ne < er || ma > threshold || mb > threshold) ? 1 : 0;
    running[r] = static_cast<unsigned char>(flag);
    eps_run[r] = ne;
    all_run &= flag;
    any_run |= flag;
  }
  const bool agg = any ? __syncthreads_or(any_run) != 0 : __syncthreads_and(all_run) != 0;
  if (t == 0) {
    const int it = iters + 1;
    state->iters = it;
    state->agg = agg ? 1 : 0;
    state->done = (it < max_iter - 1 && agg) ? 0 : 1;
    state->arrived = 0u;
  }
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

// Column splits for M > 128 of a kernel with R rows per warp, C columns per
// lane and tile and WARPS warps per block: the fewest of {1, 2, 4} that give
// the grid two blocks per SM, as long as a split tile still fits into the
// columns.
template <int R, int C, int WARPS>
int pick_split(int b, int n, int m) {
  int cs = 1;
  while (cs < 4) {
    const int block_rows = R * (WARPS / cs);
    const long blocks = (long)((n + block_rows - 1) / block_rows) * b;
    if (blocks >= 2L * sm_count() || 32 * (2 * cs) * C > m) break;
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
  constexpr int R = kLseR, RG = kLseWarps / CS;
  lse_kernel<G, R, RG, CS, kLseC, false>
      <<<grid_for<R, RG>(b, n), 32 * kLseWarps, 0, s>>>(eps, x, y, f, out, n, m);
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
  switch (pick_split<kLseR, kLseC, kLseWarps>(b, n, m)) {
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

// The update kernel's last launch (nfdpf_sinkhorn_launch_note reads it).
LaunchNote update_note = {};

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
    switch (pick_split<kLargeR, kLargeC, kLargeWarps>(b, n, m)) {
      case 1: launch_apply_large<1>(s, eps, x2, y2, v2, r, c, out2, b, n, m); break;
      case 2: launch_apply_large<2>(s, eps, x2, y2, v2, r, c, out2, b, n, m); break;
      default: launch_apply_large<4>(s, eps, x2, y2, v2, r, c, out2, b, n, m); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// One Sinkhorn iteration's update after K1 on a batch of `b` rows of `n`
// particles, on the wrapper's plan (update_plan): with `batch`, one block or
// one cluster of `splits` blocks of `cols` rows, `threads` = 32·cols threads
// (a warp a row, sinkhorn_update_batch_kernel); else `splits` blocks a row
// of `threads` threads, `cols` columns each (sinkhorn_update_kernel).
// `state` holds the LoopState (4 ints), `row_max` 2·b zeros.
extern "C" int nfdpf_sinkhorn_update(const float* lse, float* a_y, float* b_x,
                                     unsigned char* running, float* eps_run,
                                     const float* eps_target, const float* logw, float* fs,
                                     int* state, unsigned* row_max, int b, int n, int batch,
                                     int splits, int cols, int threads, float neg_log_n,
                                     float threshold, float scaling_factor, int max_iter, int any,
                                     int freeze, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LoopState* st = reinterpret_cast<LoopState*>(state);
  if (b <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch) {
    // `splits` blocks (one cluster when more than one) of `cols` rows
    const int cpl = (n + 31) / 32, blocks = splits, rows_a_block = cols;
    if (n > 8 * 32 || blocks < 1 || blocks > kBatchBlocks || rows_a_block < 1 ||
        rows_a_block > kBatchRows || threads != 32 * rows_a_block ||
        (long long)blocks * rows_a_block < b) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto kernel = cpl <= 1 ? sinkhorn_update_batch_kernel<1>
                  : cpl <= 2 ? sinkhorn_update_batch_kernel<2>
                  : cpl <= 4 ? sinkhorn_update_batch_kernel<4>
                             : sinkhorn_update_batch_kernel<8>;
    note_launch(update_note, kernel,
                cpl <= 1   ? "sinkhorn_update_batch_kernel<1>"
                : cpl <= 2 ? "sinkhorn_update_batch_kernel<2>"
                : cpl <= 4 ? "sinkhorn_update_batch_kernel<4>"
                           : "sinkhorn_update_batch_kernel<8>",
                blocks, threads, 0);
    if (blocks == 1) {   // one block: no cluster
      kernel<<<1, threads, 0, s>>>(lse, a_y, b_x, running, eps_run, eps_target, logw, fs, st, b,
                                   n, rows_a_block, neg_log_n, threshold, scaling_factor,
                                   max_iter, any, freeze);
      return static_cast<int>(cudaGetLastError());
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, lse, a_y, b_x, running, eps_run,
                                              eps_target, logw, fs, st, b, n, rows_a_block,
                                              neg_log_n, threshold, scaling_factor, max_iter,
                                              any, freeze);
    return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
  }
  if (splits <= 0 || cols <= 0 || threads < 32 || threads % 32 != 0 ||
      threads > kUpdateThreads || (long long)splits * cols < n ||
      (long long)(splits - 1) * cols >= n || (long long)b * splits > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  note_launch(update_note, sinkhorn_update_kernel, "sinkhorn_update_kernel", b * splits, threads,
              0);
  sinkhorn_update_kernel<<<b * splits, threads, 0, s>>>(
      lse, a_y, b_x, running, eps_run, eps_target, logw, fs, st, row_max, b, n, splits, cols,
      neg_log_n, threshold, scaling_factor, max_iter, any, freeze);
  return static_cast<int>(cudaGetLastError());
}

// The update kernel's last launch: read_launch_note's record.
extern "C" int nfdpf_sinkhorn_launch_note(long long* out, char* name, int len) {
  return read_launch_note(update_note, out, name, len);
}

// An empty kernel on `blocks` x `threads`, launched like the two above.
extern "C" int nfdpf_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
