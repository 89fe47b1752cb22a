// Streaming-Sinkhorn kernels for NVIDIA Hopper (sm_90a).
//
// Both kernels work on a cost that is never stored:
//   C_ij = 0.5 * ||x_i - y_j||^2 / eps_b,   x, y in R^2,
// recomputed from the coordinates wherever a tile of it is needed, so device
// memory traffic is O((N + M) * d) per call instead of O(N * M).
//
// lse_kernel<G>  replaces nfdpf_tpu/ops/pallas/sinkhorn_pallas.py::_lse_kernel
//   out[b,g,i] = logsumexp_j( f[b,g,j] - 0.5*||x_i - y_j||^2 / eps_b )
//   for G potential vectors that share one distance computation.
// apply_kernel   replaces nfdpf_tpu/ops/pallas/sinkhorn_pallas.py::_apply_kernel
//   out[b,i,:] = sum_j exp( r_i + c_j - 0.5*||x_i - y_j||^2 / eps_b ) * v[b,j,:]
//   (T @ v with T implicit; its VJP is the same kernel with rows and columns
//   swapped, launched from the torch.autograd.Function in sinkhorn_cuda.py).
//
// What bounds them on an H100: the work is N*M*(7 + 4*G) (lse) or N*M*14
// (apply) fp32 operations, one expf per group per pair, against
// O((N + M) * d) bytes, so the operation bound (67 TFLOP/s) is the larger
// one; at the resampler's sizes it is far from reached.  At N = 100 a call
// is launch latency plus one block per batch row walking 100 columns; at
// N ~ 4k there are only ~4 warps per SM, and each thread's serial running
// max/sum (a division and an expf per column) leaves the SMs latency-bound
// (times against bounds in PERF.md).  The design keeps everything but the
// inputs and outputs on chip:
//   * one thread block per (row tile of kRows rows, batch), one thread per row;
//     the running max/sum (lse) or the 2-wide accumulator (apply) stays in
//     registers for the whole column sweep;
//   * column tiles of y and f (G rows) or of y, v and c are staged in shared
//     memory by the whole block, then every thread sweeps the tile;
//   * coordinates are read as float2; the ragged last row/column tile is
//     masked (no padding, no -1e30 sentinels);
//   * G is a template parameter so both potentials of a Sinkhorn iteration
//     share one distance computation, as in the TPU kernel.
// Precise expf/logf and IEEE division (no fast-math) keep the results within
// 1e-5 (lse) and 1e-4 relative (apply) of the plain PyTorch versions.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;   // rows per block (one thread each)
constexpr int kCols = 128;   // columns per shared-memory tile (== kRows: each
                             // thread stages one column)

template <int G>
__global__ void __launch_bounds__(kRows)
lse_kernel(const float* __restrict__ eps, const float2* __restrict__ x,
           const float2* __restrict__ y, const float* __restrict__ f,
           float* __restrict__ out, int n, int m) {
  __shared__ float2 ys[kCols];
  __shared__ float fs[G][kCols];

  const int b = blockIdx.y;
  const int i = blockIdx.x * kRows + threadIdx.x;
  const float e = eps[b];
  const float2 xi = i < n ? x[(size_t)b * n + i] : make_float2(0.f, 0.f);
  const float2* yb = y + (size_t)b * m;
  const float* fb = f + (size_t)b * G * m;

  float mx[G], s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mx[g] = -INFINITY;
    s[g] = 0.f;
  }

  for (int j0 = 0; j0 < m; j0 += kCols) {
    const int cols = min(kCols, m - j0);
    __syncthreads();  // every thread is done with the previous tile
    if (threadIdx.x < cols) {
      ys[threadIdx.x] = yb[j0 + threadIdx.x];
#pragma unroll
      for (int g = 0; g < G; ++g) fs[g][threadIdx.x] = fb[(size_t)g * m + j0 + threadIdx.x];
    }
    __syncthreads();
    for (int j = 0; j < cols; ++j) {
      const float dx = xi.x - ys[j].x;
      const float dy = xi.y - ys[j].y;
      const float neg_cost = -0.5f * (dx * dx + dy * dy) / e;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float v = fs[g][j] + neg_cost;
        if (v > mx[g]) {
          s[g] = s[g] * expf(mx[g] - v) + 1.f;
          mx[g] = v;
        } else {
          s[g] += expf(v - mx[g]);
        }
      }
    }
  }
  if (i < n) {
#pragma unroll
    for (int g = 0; g < G; ++g) out[((size_t)b * G + g) * n + i] = mx[g] + logf(s[g]);
  }
}

__global__ void __launch_bounds__(kRows)
apply_kernel(const float* __restrict__ eps, const float2* __restrict__ x,
             const float2* __restrict__ y, const float2* __restrict__ v,
             const float* __restrict__ r, const float* __restrict__ c,
             float2* __restrict__ out, int n, int m) {
  __shared__ float2 ys[kCols];
  __shared__ float2 vs[kCols];
  __shared__ float cs[kCols];

  const int b = blockIdx.y;
  const int i = blockIdx.x * kRows + threadIdx.x;
  const float e = eps[b];
  const float2 xi = i < n ? x[(size_t)b * n + i] : make_float2(0.f, 0.f);
  const float ri = i < n ? r[(size_t)b * n + i] : 0.f;
  const size_t col0 = (size_t)b * m;

  float ax = 0.f, ay = 0.f;
  for (int j0 = 0; j0 < m; j0 += kCols) {
    const int cols = min(kCols, m - j0);
    __syncthreads();
    if (threadIdx.x < cols) {
      ys[threadIdx.x] = y[col0 + j0 + threadIdx.x];
      vs[threadIdx.x] = v[col0 + j0 + threadIdx.x];
      cs[threadIdx.x] = c[col0 + j0 + threadIdx.x];
    }
    __syncthreads();
    for (int j = 0; j < cols; ++j) {
      const float dx = xi.x - ys[j].x;
      const float dy = xi.y - ys[j].y;
      const float t = expf(ri + cs[j] - 0.5f * (dx * dx + dy * dy) / e);
      ax += t * vs[j].x;
      ay += t * vs[j].y;
    }
  }
  if (i < n) out[(size_t)b * n + i] = make_float2(ax, ay);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on the caller's
// stream and returns cudaGetLastError() right after the launch; shapes,
// types, devices and contiguity are checked by the Python wrapper.

extern "C" int nfdpf_sinkhorn_lse(const float* eps, const float* x, const float* y,
                                  const float* f, float* out, int b, int n, int m,
                                  int groups, void* stream) {
  const dim3 grid((n + kRows - 1) / kRows, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* x2 = reinterpret_cast<const float2*>(x);
  const float2* y2 = reinterpret_cast<const float2*>(y);
  if (groups == 1) {
    lse_kernel<1><<<grid, kRows, 0, s>>>(eps, x2, y2, f, out, n, m);
  } else if (groups == 2) {
    lse_kernel<2><<<grid, kRows, 0, s>>>(eps, x2, y2, f, out, n, m);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nfdpf_transport_apply(const float* eps, const float* x, const float* y,
                                     const float* v, const float* r, const float* c,
                                     float* out, int b, int n, int m, void* stream) {
  const dim3 grid((n + kRows - 1) / kRows, b);
  apply_kernel<<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      eps, reinterpret_cast<const float2*>(x), reinterpret_cast<const float2*>(y),
      reinterpret_cast<const float2*>(v), r, c, reinterpret_cast<float2*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}
