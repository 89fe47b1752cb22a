// Fused RealNVP coupling-chain kernels for NVIDIA Hopper (sm_90a).
//
// A chain is K blocks; each block holds four 3-layer tanh MLPs (t1, s1, t2,
// s2; hidden width H) that act on the two halves of a d = 2 state, with an
// optional C-wide context row concatenated to every MLP's input:
//   forward:  upper' = t1(lower|ctx) + upper * exp(s1(lower|ctx))
//             lower' = t2(upper'|ctx) + lower * exp(s2(upper'|ctx))
//             log_det += s1 + s2
//   inverse:  the blocks in reverse order, each undone.
// Packed parameters: w[K][4][3][max_in][H], b[K][4][3][H], max_in =
// max(1 + C, H); layer 0 reads rows 0..C, layers 1-2 rows 0..H-1, and the
// output layer uses column 0 only.
//
// chain_fwd_kernel  replaces nfdpf_tpu/ops/pallas/coupling_pallas.py::_chain_kernel
//   y, log_det for every row in one pass.
// chain_bwd_kernel  replaces nfdpf_tpu/ops/pallas/coupling_pallas.py::_chain_bwd_kernel
//   recomputes the forward from x, then walks the blocks backwards: g_x,
//   g_ctx (optional) per row, and the weight/bias gradients as one partial
//   per thread block, summed by the caller.
//
// What bounds them on an H100: a row moves 20 + 4C bytes (forward) against
// about K * 4 * 2H(1 + C + H + 1) fp32 operations (the C term only once per
// distinct context row: these kernels redo it for every row), so at H = 8 the
// operation bound (67 TFLOP/s) is the larger one, and at the filter's sizes
// (3,200 rows) both bounds are far below a launch's latency: the time is one
// thread's serial walk through 4K dependent MLPs (times against bounds in
// PERF.md).  The design keeps everything but inputs and outputs on chip:
//   * one thread per row over the flattened (B*N) rows, the ragged last
//     tile masked; lower, upper, log_det and the H-wide activations stay in
//     registers;
//   * the chain's parameters are staged in (dynamic) shared memory once per
//     block; every lane reads the same weight at the same time (a broadcast,
//     no bank conflicts);
//   * ctx is read through its own batch/row strides, so a context that is
//     one row per batch broadcast over the particles is never materialised;
//   * backward: a block is ONE warp that loops over row tiles; each weight
//     gradient entry is a warp-shuffle sum added by lane 0 into a
//     shared-memory accumulator, written out once per block at the end.  No
//     float atomics: the same launch gives the same bits.
// Precise tanhf/expf (no fast-math).

#include <cuda_runtime.h>
#include <math.h>

#ifndef NFDPF_HIDDEN
#define NFDPF_HIDDEN 8
#endif

namespace {

constexpr int kHidden = NFDPF_HIDDEN;   // the conditioners' hidden width H
constexpr int kFwdThreads = 64;   // rows per forward block
constexpr int kWarp = 32;         // rows per backward tile; a backward block is one warp
constexpr int kMaxBlocks = 8;     // chain blocks whose inputs the backward keeps per row
constexpr size_t kStaticSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;   // most dynamic shared memory a block can opt in to

// One conditioner MLP on (half | ctx) with the packed parameters of one net:
// w[3][max_in][H], b[3][H].  Keeps both tanh activations for the backward.
template <int H>
__device__ __forceinline__ float mlp_fwd(const float* __restrict__ w,
                                         const float* __restrict__ b, int max_in,
                                         float half, const float* __restrict__ ctx, int C,
                                         float (&h1)[H], float (&h2)[H]) {
  float a[H];
#pragma unroll
  for (int j = 0; j < H; ++j) a[j] = fmaf(half, w[j], b[j]);
  for (int c = 0; c < C; ++c) {
    const float cv = __ldg(ctx + c);
    const float* wr = w + (1 + c) * H;
#pragma unroll
    for (int j = 0; j < H; ++j) a[j] = fmaf(cv, wr[j], a[j]);
  }
#pragma unroll
  for (int j = 0; j < H; ++j) h1[j] = tanhf(a[j]);

  const float* w1 = w + max_in * H;
#pragma unroll
  for (int j = 0; j < H; ++j) a[j] = b[H + j];
#pragma unroll
  for (int i = 0; i < H; ++i) {
#pragma unroll
    for (int j = 0; j < H; ++j) a[j] = fmaf(h1[i], w1[i * H + j], a[j]);
  }
#pragma unroll
  for (int j = 0; j < H; ++j) h2[j] = tanhf(a[j]);

  const float* w2 = w + 2 * max_in * H;
  float out = b[2 * H];
#pragma unroll
  for (int i = 0; i < H; ++i) out = fmaf(h2[i], w2[i * H], out);
  return out;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;   // the full sum in lane 0
}

// Backward of one MLP.  Adds the warp's weight/bias gradient sums into the
// net's shared-memory accumulators gw[3][max_in][H], gb[3][H] (lane 0 only),
// this row's context gradient into gctx (when not null), and returns the
// gradient with respect to `half`.  Every lane of the warp must call it.
template <int H>
__device__ __forceinline__ float mlp_bwd(const float* __restrict__ w, int max_in, float half,
                                         const float* __restrict__ ctx, int C,
                                         const float (&h1)[H], const float (&h2)[H],
                                         float g_out, float* gw, float* gb,
                                         float* __restrict__ gctx, bool lead) {
  const float* w1 = w + max_in * H;
  const float* w2 = w + 2 * max_in * H;
  float* gw1 = gw + max_in * H;
  float* gw2 = gw + 2 * max_in * H;
  float g2[H], g1[H];

  // layer 3: out = sum_i h2[i] * w2[i][0] + b[2][0]
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float v = warp_sum(h2[i] * g_out);
    if (lead) gw2[i * H] += v;
    g2[i] = g_out * w2[i * H] * (1.f - h2[i] * h2[i]);
  }
  {
    const float v = warp_sum(g_out);
    if (lead) gb[2 * H] += v;
  }
  // layer 2
#pragma unroll
  for (int i = 0; i < H; ++i) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float v = warp_sum(h1[i] * g2[j]);
      if (lead) gw1[i * H + j] += v;
    }
  }
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float v = warp_sum(g2[j]);
    if (lead) gb[H + j] += v;
  }
#pragma unroll
  for (int i = 0; i < H; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < H; ++j) acc = fmaf(g2[j], w1[i * H + j], acc);
    g1[i] = acc * (1.f - h1[i] * h1[i]);
  }
  // layer 1: input row 0 is `half`, rows 1..C the context
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float vw = warp_sum(half * g1[j]);
    const float vb = warp_sum(g1[j]);
    if (lead) {
      gw[j] += vw;
      gb[j] += vb;
    }
  }
  for (int c = 0; c < C; ++c) {
    const float cv = __ldg(ctx + c);
    const float* wr = w + (1 + c) * H;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float v = warp_sum(cv * g1[j]);
      if (lead) gw[(1 + c) * H + j] += v;
      acc = fmaf(g1[j], wr[j], acc);
    }
    if (gctx != nullptr) gctx[c] += acc;
  }
  float g_half = 0.f;
#pragma unroll
  for (int j = 0; j < H; ++j) g_half = fmaf(g1[j], w[j], g_half);
  return g_half;
}

// Stage the packed parameters in shared memory: sw[nw] then sb[nb].
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) dst[t] = src[t];
}

template <int H, bool INV>
__global__ void __launch_bounds__(kFwdThreads)
chain_fwd_kernel(const float2* __restrict__ x, const float* __restrict__ ctx,
                 long long ctx_sb, long long ctx_sn, const float* __restrict__ w,
                 const float* __restrict__ bias, float2* __restrict__ y,
                 float* __restrict__ ld_out, int rows, int n, int K, int C, int max_in) {
  extern __shared__ float smem[];
  const int net_w = 3 * max_in * H, net_b = 3 * H;
  const int nw = K * 4 * net_w, nb = K * 4 * net_b;
  float* sw = smem;
  float* sb = smem + nw;
  stage(sw, w, nw);
  stage(sb, bias, nb);
  __syncthreads();

  const int row = blockIdx.x * kFwdThreads + threadIdx.x;
  if (row >= rows) return;   // past the only barrier
  const float* crow =
      C ? ctx + (long long)(row / n) * ctx_sb + (long long)(row % n) * ctx_sn : nullptr;
  const float2 v = x[row];
  float lo = v.x, up = v.y, ld = 0.f;
  float h1[H], h2[H];

  for (int s = 0; s < K; ++s) {
    const int k = INV ? K - 1 - s : s;
    const float* wk = sw + k * 4 * net_w;
    const float* bk = sb + k * 4 * net_b;
    if (!INV) {
      const float t1 = mlp_fwd<H>(wk, bk, max_in, lo, crow, C, h1, h2);
      const float s1 = mlp_fwd<H>(wk + net_w, bk + net_b, max_in, lo, crow, C, h1, h2);
      up = t1 + up * expf(s1);
      const float t2 = mlp_fwd<H>(wk + 2 * net_w, bk + 2 * net_b, max_in, up, crow, C, h1, h2);
      const float s2 = mlp_fwd<H>(wk + 3 * net_w, bk + 3 * net_b, max_in, up, crow, C, h1, h2);
      lo = t2 + lo * expf(s2);
      ld = ld + s1 + s2;
    } else {
      const float t2 = mlp_fwd<H>(wk + 2 * net_w, bk + 2 * net_b, max_in, up, crow, C, h1, h2);
      const float s2 = mlp_fwd<H>(wk + 3 * net_w, bk + 3 * net_b, max_in, up, crow, C, h1, h2);
      lo = (lo - t2) * expf(-s2);
      const float t1 = mlp_fwd<H>(wk, bk, max_in, lo, crow, C, h1, h2);
      const float s1 = mlp_fwd<H>(wk + net_w, bk + net_b, max_in, lo, crow, C, h1, h2);
      up = (up - t1) * expf(-s1);
      ld = ld - s1 - s2;
    }
  }
  y[row] = make_float2(lo, up);
  ld_out[row] = ld;
}

template <int H, bool INV>
__global__ void __launch_bounds__(kWarp)
chain_bwd_kernel(const float2* __restrict__ x, const float* __restrict__ ctx,
                 long long ctx_sb, long long ctx_sn, const float* __restrict__ w,
                 const float* __restrict__ bias, const float2* __restrict__ gy,
                 const float* __restrict__ gld, float2* __restrict__ gx,
                 float* __restrict__ gctx, float* __restrict__ gw_part,
                 float* __restrict__ gb_part, int rows, int n, int K, int C, int max_in) {
  extern __shared__ float smem[];
  const int net_w = 3 * max_in * H, net_b = 3 * H;
  const int nw = K * 4 * net_w, nb = K * 4 * net_b;
  float* sw = smem;
  float* sb = sw + nw;
  float* aw = sb + nb;   // weight-gradient accumulator, laid out like sw
  float* ab = aw + nw;   // bias-gradient accumulator, laid out like sb
  stage(sw, w, nw);
  stage(sb, bias, nb);
  for (int t = threadIdx.x; t < nw + nb; t += kWarp) aw[t] = 0.f;
  __syncthreads();

  const bool lead = threadIdx.x == 0;
  const int tiles = (rows + kWarp - 1) / kWarp;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row = tile * kWarp + threadIdx.x;
    const bool valid = row < rows;
    // a lane past the end walks the last row with zero incoming gradients:
    // it takes part in every shuffle and adds exact zeros
    const int r = valid ? row : rows - 1;
    const float* crow =
        C ? ctx + (long long)(r / n) * ctx_sb + (long long)(r % n) * ctx_sn : nullptr;
    float* grow = (gctx != nullptr && valid) ? gctx + (size_t)row * C : nullptr;
    const float2 xv = x[r];
    float lo = xv.x, up = xv.y;
    const float2 gv = valid ? gy[row] : make_float2(0.f, 0.f);
    const float g_ld = valid ? gld[row] : 0.f;

    float t1h1[H], t1h2[H], s1h1[H], s1h2[H], t2h1[H], t2h2[H], s2h1[H], s2h2[H];
    float st_lo[kMaxBlocks], st_up[kMaxBlocks];

    // forward sweep, keeping each block's input
    for (int s = 0; s < K; ++s) {
      const int k = INV ? K - 1 - s : s;
      const float* wk = sw + k * 4 * net_w;
      const float* bk = sb + k * 4 * net_b;
      st_lo[s] = lo;
      st_up[s] = up;
      if (!INV) {
        const float t1 = mlp_fwd<H>(wk, bk, max_in, lo, crow, C, t1h1, t1h2);
        const float s1 = mlp_fwd<H>(wk + net_w, bk + net_b, max_in, lo, crow, C, s1h1, s1h2);
        up = t1 + up * expf(s1);
        const float t2 =
            mlp_fwd<H>(wk + 2 * net_w, bk + 2 * net_b, max_in, up, crow, C, t2h1, t2h2);
        const float s2 =
            mlp_fwd<H>(wk + 3 * net_w, bk + 3 * net_b, max_in, up, crow, C, s2h1, s2h2);
        lo = t2 + lo * expf(s2);
      } else {
        const float t2 =
            mlp_fwd<H>(wk + 2 * net_w, bk + 2 * net_b, max_in, up, crow, C, t2h1, t2h2);
        const float s2 =
            mlp_fwd<H>(wk + 3 * net_w, bk + 3 * net_b, max_in, up, crow, C, s2h1, s2h2);
        lo = (lo - t2) * expf(-s2);
        const float t1 = mlp_fwd<H>(wk, bk, max_in, lo, crow, C, t1h1, t1h2);
        const float s1 = mlp_fwd<H>(wk + net_w, bk + net_b, max_in, lo, crow, C, s1h1, s1h2);
        up = (up - t1) * expf(-s1);
      }
    }

    // reverse sweep: recompute each block from its input, then its gradients
    float g_lo = gv.x, g_up = gv.y;
    for (int s = K - 1; s >= 0; --s) {
      const int k = INV ? K - 1 - s : s;
      const float* wk = sw + k * 4 * net_w;
      const float* bk = sb + k * 4 * net_b;
      float* awk = aw + k * 4 * net_w;
      float* abk = ab + k * 4 * net_b;
      const float lo_in = st_lo[s], up_in = st_up[s];
      if (!INV) {
        const float t1 = mlp_fwd<H>(wk, bk, max_in, lo_in, crow, C, t1h1, t1h2);
        const float s1 = mlp_fwd<H>(wk + net_w, bk + net_b, max_in, lo_in, crow, C, s1h1, s1h2);
        const float e1 = expf(s1);
        const float up_mid = t1 + up_in * e1;
        mlp_fwd<H>(wk + 2 * net_w, bk + 2 * net_b, max_in, up_mid, crow, C, t2h1, t2h2);
        const float s2 =
            mlp_fwd<H>(wk + 3 * net_w, bk + 3 * net_b, max_in, up_mid, crow, C, s2h1, s2h2);
        const float e2 = expf(s2);
        // lower_out = t2 + lo_in * exp(s2); log_det += s1 + s2
        const float g_t2 = g_lo;
        const float g_s2 = g_lo * lo_in * e2 + g_ld;
        const float g_lo_in = g_lo * e2;
        const float g_b =
            mlp_bwd<H>(wk + 2 * net_w, max_in, up_mid, crow, C, t2h1, t2h2, g_t2,
                       awk + 2 * net_w, abk + 2 * net_b, grow, lead) +
            mlp_bwd<H>(wk + 3 * net_w, max_in, up_mid, crow, C, s2h1, s2h2, g_s2,
                       awk + 3 * net_w, abk + 3 * net_b, grow, lead);
        const float g_up_mid = g_up + g_b;
        // up_mid = t1 + up_in * exp(s1)
        const float g_t1 = g_up_mid;
        const float g_s1 = g_up_mid * up_in * e1 + g_ld;
        const float g_a =
            mlp_bwd<H>(wk, max_in, lo_in, crow, C, t1h1, t1h2, g_t1, awk, abk, grow, lead) +
            mlp_bwd<H>(wk + net_w, max_in, lo_in, crow, C, s1h1, s1h2, g_s1, awk + net_w,
                       abk + net_b, grow, lead);
        g_lo = g_lo_in + g_a;
        g_up = g_up_mid * e1;
      } else {
        const float t2 =
            mlp_fwd<H>(wk + 2 * net_w, bk + 2 * net_b, max_in, up_in, crow, C, t2h1, t2h2);
        const float s2 =
            mlp_fwd<H>(wk + 3 * net_w, bk + 3 * net_b, max_in, up_in, crow, C, s2h1, s2h2);
        const float e2 = expf(-s2);
        const float lo_out = (lo_in - t2) * e2;
        const float t1 = mlp_fwd<H>(wk, bk, max_in, lo_out, crow, C, t1h1, t1h2);
        const float s1 =
            mlp_fwd<H>(wk + net_w, bk + net_b, max_in, lo_out, crow, C, s1h1, s1h2);
        const float e1 = expf(-s1);
        const float up_out = (up_in - t1) * e1;
        // up_out = (up_in - t1) * exp(-s1); log_det -= s1 + s2
        const float g_t1 = -g_up * e1;
        const float g_s1 = -g_up * up_out - g_ld;
        const float g_up_in = g_up * e1;
        const float g_a =
            mlp_bwd<H>(wk, max_in, lo_out, crow, C, t1h1, t1h2, g_t1, awk, abk, grow, lead) +
            mlp_bwd<H>(wk + net_w, max_in, lo_out, crow, C, s1h1, s1h2, g_s1, awk + net_w,
                       abk + net_b, grow, lead);
        const float g_lo_out = g_lo + g_a;
        // lo_out = (lo_in - t2) * exp(-s2)
        const float g_t2 = -g_lo_out * e2;
        const float g_s2 = -g_lo_out * lo_out - g_ld;
        const float g_b =
            mlp_bwd<H>(wk + 2 * net_w, max_in, up_in, crow, C, t2h1, t2h2, g_t2,
                       awk + 2 * net_w, abk + 2 * net_b, grow, lead) +
            mlp_bwd<H>(wk + 3 * net_w, max_in, up_in, crow, C, s2h1, s2h2, g_s2,
                       awk + 3 * net_w, abk + 3 * net_b, grow, lead);
        g_up = g_up_in + g_b;
        g_lo = g_lo_out * e2;
      }
    }
    if (valid) gx[row] = make_float2(g_lo, g_up);
  }

  __syncwarp();
  float* gw_out = gw_part + (size_t)blockIdx.x * nw;
  float* gb_out = gb_part + (size_t)blockIdx.x * nb;
  for (int t = threadIdx.x; t < nw; t += kWarp) gw_out[t] = aw[t];
  for (int t = threadIdx.x; t < nb; t += kWarp) gb_out[t] = ab[t];
}

// Opt in to more than 48 KB of dynamic shared memory where the chain needs it.
template <typename Kernel>
int reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > kStaticSmem) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
  }
  return 0;
}

size_t param_floats(int n_blocks, int max_in) {
  return (size_t)n_blocks * 12 * ((size_t)max_in * kHidden + kHidden);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on the caller's
// stream and returns a cudaError_t: that of the shared-memory opt-in, else
// cudaGetLastError() right after the launch.  Shapes, types, devices,
// alignment and contiguity are checked by the Python wrapper.  The hidden
// width is fixed when the file is compiled (-DNFDPF_HIDDEN=H; the loader
// builds one library per width at first use), so the H-wide activations are
// register arrays with every loop over them unrolled.

extern "C" int nfdpf_coupling_chain_fwd(const float* x, const float* ctx, long long ctx_sb,
                                        long long ctx_sn, const float* w, const float* b,
                                        float* y, float* ld, int rows, int n, int n_blocks,
                                        int ctx_dim, int max_in, int hidden, int inverse,
                                        void* stream) {
  if (rows <= 0 || n <= 0 || n_blocks <= 0 || hidden != kHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = param_floats(n_blocks, max_in) * sizeof(float);
  auto kernel = inverse ? chain_fwd_kernel<kHidden, true> : chain_fwd_kernel<kHidden, false>;
  const int rc = reserve_smem(kernel, smem);
  if (rc != 0) return rc;
  const int grid = (rows + kFwdThreads - 1) / kFwdThreads;
  kernel<<<grid, kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(x), ctx, ctx_sb, ctx_sn, w, b,
      reinterpret_cast<float2*>(y), ld, rows, n, n_blocks, ctx_dim, max_in);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nfdpf_coupling_chain_bwd(const float* x, const float* ctx, long long ctx_sb,
                                        long long ctx_sn, const float* w, const float* b,
                                        const float* gy, const float* gld, float* gx,
                                        float* gctx, float* gw_part, float* gb_part, int rows,
                                        int n, int n_blocks, int ctx_dim, int max_in,
                                        int hidden, int inverse, int grid, void* stream) {
  if (rows <= 0 || n <= 0 || n_blocks <= 0 || n_blocks > kMaxBlocks || grid <= 0 ||
      hidden != kHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * param_floats(n_blocks, max_in) * sizeof(float);
  auto kernel = inverse ? chain_bwd_kernel<kHidden, true> : chain_bwd_kernel<kHidden, false>;
  const int rc = reserve_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<grid, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(x), ctx, ctx_sb, ctx_sn, w, b,
      reinterpret_cast<const float2*>(gy), gld, reinterpret_cast<float2*>(gx), gctx, gw_part,
      gb_part, rows, n, n_blocks, ctx_dim, max_in);
  return static_cast<int>(cudaGetLastError());
}
