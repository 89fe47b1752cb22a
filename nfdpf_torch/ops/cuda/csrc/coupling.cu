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
//   runs the chain forward from x, then walks the blocks backwards: g_x per
//   row, the weight/bias gradients as one partial per thread block, summed by
//   the caller, and (with a context) every row's layer-0 pre-activation
//   gradients g1 for the context kernels.
// Layer 0's context share P = b + ctx . w[1..C] depends only on a row's
// context row, so it is a kernel of its own (chain_ctx_share_kernel, below),
// computed once per distinct context row (a batch element's row when the
// context is broadcast over the particles, particle stride 0, as the filter
// passes it; else a row each); K4 and K5 read P as layer 0's bias through
// the row -> context-row map, and the context's gradients come from K5's g1
// in two more kernels (chain_ctx_weight_grad_kernel, chain_ctx_input_grad_
// kernel).  So K4's and K5's shared memory holds a chain without context,
// whatever the context's width (the proposal flow's is 196 wide under the
// CGLOW measurement, whose parameters and gradient accumulators alone would
// take 304 KB at K = 2, H = 8).
//
// What bounds them on an H100: a row moves 20 bytes (forward) against
// about K * 4 * 2H(1 + H + 1) fp32 operations, so at H = 8 the operation
// bound (67 TFLOP/s) is the larger one, and at the filter's sizes (3,200
// rows) both bounds are far below a launch's latency: the time is latency,
// of staging the parameters and of 4K dependent MLPs per row (times against
// bounds in PERF.md).  Both keep everything but inputs and outputs on chip:
// the chain's parameters staged in (dynamic) shared memory once per block
// with cp.async, all copies of a thread in flight at once.
//
// The forward's design:
//   * A row takes 2U lanes of a warp (U = 4 at H = 8): U lanes per net of a
//     coupling half, H/U hidden units each, so the t and s nets run side by
//     side.  A layer's inputs come from the row's lanes by shuffles, every
//     lane of a net sums the output in the same order, and one shuffle
//     swaps the two nets' outputs: every lane holds the row's state, and
//     one lane writes it.  One thread walking a row through 4K MLPs (~3,800
//     instructions at K = 2) left one or two warps on 50 SMs, each bound by
//     its own instruction stream and latency.
//   * 32 rows (256 threads) a block, settled with U by a sweep at the
//     filter's shapes.
//   * Only what the rows read is staged (FwdLayout: no zero rows of the
//     packing), and the block's rows of P, one run of it.
//   * Layers 1 and 2 sum in the backward's order: a row's outputs do not
//     depend on U or on the block shape, and the same launch gives the same
//     bits.
//
// The backward adds what the forward does not have: every weight and bias
// gradient is a sum over all rows, K * 4 * (H*H + 4H + 1 + C*H) of them, and
// it must not depend on the order blocks run in.  Its design:
//   * A block of 1-8 warps loops over tiles of one row per thread; the
//     wrapper aims at 128 rows (four warps) per block and at most one block
//     per SM, and the entry point takes fewer warps where shared memory would
//     not hold them.  A lone warp per SM left every phase latency-bound.
//   * The forward sweep keeps each row's block inputs, net outputs and tanh
//     activations in a field-major tile in shared memory; the reverse sweep
//     reads them (no recompute) and adds the pre-activation gradients g1, g2.
//     The two nets of a coupling half are computed before either stores, so
//     their instructions interleave.
//   * The weight and bias gradients are the tile's sums of outer products
//     (as the Pallas kernel's x_in.T @ g): sixteen lanes take one net, each
//     lane sums its rows in registers, a 4-step butterfly adds the lanes, and
//     one lane adds the result into the block's accumulators in shared
//     memory, written out once as the block's partial.  Fixed orders and no
//     float atomics: the same launch gives the same bits.
//   * Layer 0's bias and context share come from P in global memory (read
//     once per row and MLP); K5 stages the parameters of a chain without
//     context (rows of H) and writes each row's g1, from which the context
//     kernels make the context's gradients.
//   * Parameters are staged with cp.async, all copies of a thread in flight
//     at once.
//   * No tensor cores: each product is 8 x (rows) x 8 per net and tile, and
//     TF32 would break the 1e-4 tolerance of the gradients.
//   * Hidden widths: the library is built for one H (-DNFDPF_HIDDEN), H <= 8
//     or H = 16; the wrapper runs a chain 9-15 wide at 16, zero-padded (a
//     padded unit's activation is tanh(0) = 0 and its outgoing weights are
//     0, so every sum gains exact zeros).  At 16 the backward's transpose-
//     reduce runs in three passes (reduce_tile_wide) and a block takes fewer
//     warps where its tile does not fit; H <= 8 keeps reduce_tile's one pass.
// ptxas (CUDA 12.8, H = 8): about 150 registers a thread, no spills, no
// stack (PERF.md has the counts, and those at H = 16).
// Precise tanhf/expf (no fast-math).
//
// The chains that pair does not take (hidden above 16, more than 8 blocks,
// or a factor tile past a block's shared memory: 4 or more blocks at 9-16)
// run on a second pair, chain_fwd_wide_kernel and chain_bwd_wide_kernel
// (their design above them), built once with -DNFDPF_HIDDEN=0: that
// library takes H and K at run time, in the wide pair and in the context
// kernels alike, and holds no K4/K5 of the narrow pair.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <cstdint>

#include "launch_note.cuh"

#ifndef NFDPF_HIDDEN
#define NFDPF_HIDDEN 8
#endif

namespace {

// the conditioners' hidden width H; 0 in the wide library, whose kernels
// take it at run time
constexpr int kHidden = NFDPF_HIDDEN;
// lanes per net of a forward row (H / kFwdLanes hidden units each) and rows
// per forward block, settled by a sweep at the filter's shapes (PERF.md)
constexpr int kFwdLanes = kHidden % 4 == 0 ? 4 : kHidden % 2 == 0 ? 2 : 1;
constexpr int kFwdRows = 32;
constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;      // a backward block: 1-8 warps, one row per thread
constexpr int kMaxBlocks = 8;     // most chain blocks the backward takes
constexpr size_t kStaticSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;   // most dynamic shared memory a block can opt in to

// ---- K5: the backward kernel ------------------------------------------------

// Asynchronous copies from device to shared memory (cp.async): every thread
// keeps all of its copies in flight at once.
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage `count` floats (16-byte copies where both sides allow them).
__device__ __forceinline__ void stage_async(float* dst, const float* __restrict__ src,
                                            int count) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    done = count / 4 * 4;
    for (int i = 4 * threadIdx.x; i < done; i += 4 * blockDim.x) copy_async16(dst + i, src + i);
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x) copy_async4(dst + i, src + i);
}

// H consecutive floats of a staged parameter row, with 16-byte loads when H
// is a multiple of 4 (every row of the packed parameters then starts on 16
// bytes).
template <int H>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float (&v)[H]) {
  if constexpr (H % 4 == 0) {
#pragma unroll
    for (int j = 0; j < H; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + j);
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < H; ++j) v[j] = src[j];
  }
}

// The factor tile is field-major: field f of tile row r at f * stride + r
// (stride = rows + 4, a multiple of 4), so a row's own accesses are
// consecutive across the warp, and the context-weight entries read four rows
// of a field in one 16-byte load.  Per coupling block the fields are its
// input upper half, the inputs of nets 0-1 and 2-3, and per net its output
// (overwritten by the output's gradient in the reverse sweep), h1, h2 and the
// pre-activation gradients g1 (layer 0) and g2 (layer 1), H each.
template <int H>
struct Fields {
  static constexpr int kBlock = 7 + 16 * H;
  __host__ __device__ static constexpr int count(int n_blocks) { return n_blocks * kBlock; }
  __host__ __device__ static constexpr int upper(int k) { return k * kBlock; }
  __host__ __device__ static constexpr int half(int k, int net) { return upper(k) + 1 + net / 2; }
  __host__ __device__ static constexpr int out(int k, int net) {
    return upper(k) + 3 + net * (1 + 4 * H);
  }
  __host__ __device__ static constexpr int h1(int k, int net) { return out(k, net) + 1; }
  __host__ __device__ static constexpr int h2(int k, int net) { return h1(k, net) + H; }
  __host__ __device__ static constexpr int g1(int k, int net) { return h1(k, net) + 2 * H; }
  __host__ __device__ static constexpr int g2(int k, int net) { return h1(k, net) + 3 * H; }
};

// The two nets of a coupling half in the backward kernel's forward sweep
// (nets 0-1 or 2-3 of a block, both on `half`; w, b and p point at the
// first): layer 0 takes its bias and context share from p (computed once per
// distinct context row).  Both nets are computed before any activation is
// stored, so their instructions interleave; their h1 and h2 then go to this
// row's fields at f0 and f1 (h1 at f[0], h2 at f[H * fs]).  Returns both
// outputs.
template <int H>
__device__ __forceinline__ float2 half_fwd(const float* __restrict__ w,
                                           const float* __restrict__ b, int net_w, int net_b,
                                           int max_in, float half, const float* __restrict__ p,
                                           float* f0, float* f1, int fs) {
  float h1[2][H], h2[2][H], out[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const float* wx = w + x * net_w;
    const float* bx = b + x * net_b;
    float wr[H], a[H];
    load_row<H>(wx, wr);
#pragma unroll
    for (int j = 0; j < H; ++j) h1[x][j] = tanhf(fmaf(half, wr[j], p[x * H + j]));
    load_row<H>(bx + H, a);
#pragma unroll
    for (int i = 0; i < H; ++i) {
      load_row<H>(wx + (max_in + i) * H, wr);
#pragma unroll
      for (int j = 0; j < H; ++j) a[j] = fmaf(h1[x][i], wr[j], a[j]);
    }
    const float* w2 = wx + 2 * max_in * H;
    out[x] = bx[2 * H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      h2[x][i] = tanhf(a[i]);
      out[x] = fmaf(h2[x][i], w2[i * H], out[x]);
    }
  }
#pragma unroll
  for (int j = 0; j < H; ++j) {
    f0[j * fs] = h1[0][j];
    f0[(H + j) * fs] = h2[0][j];
    f1[j * fs] = h1[1][j];
    f1[(H + j) * fs] = h2[1][j];
  }
  return make_float2(out[0], out[1]);
}

// Backward of the two nets of a coupling half for this thread's row, from
// their h1, h2 (fields at f0 and f1) and output gradients ga, gb: every load
// before any store, so the two nets interleave; writes g1 and g2 back next
// to h1, h2 and returns the gradient with respect to `half`.
template <int H>
__device__ __forceinline__ float half_bwd(const float* __restrict__ w, int net_w, int max_in,
                                          float* f0, float* f1, int fs, float ga, float gb) {
  float* const f[2] = {f0, f1};
  const float g_out[2] = {ga, gb};
  float h1[2][H], h2[2][H], g1[2][H], g2[2][H], wr[H];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
#pragma unroll
    for (int i = 0; i < H; ++i) {
      h1[x][i] = f[x][i * fs];
      h2[x][i] = f[x][(H + i) * fs];
    }
  }
  float g_half = 0.f;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const float* wx = w + x * net_w;
    const float* w2 = wx + 2 * max_in * H;
#pragma unroll
    for (int i = 0; i < H; ++i) g2[x][i] = g_out[x] * w2[i * H] * (1.f - h2[x][i] * h2[x][i]);
#pragma unroll
    for (int i = 0; i < H; ++i) {
      load_row<H>(wx + (max_in + i) * H, wr);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < H; ++j) acc = fmaf(g2[x][j], wr[j], acc);
      g1[x][i] = acc * (1.f - h1[x][i] * h1[x][i]);
    }
    load_row<H>(wx, wr);
    float gh = 0.f;
#pragma unroll
    for (int j = 0; j < H; ++j) gh = fmaf(g1[x][j], wr[j], gh);
    g_half += gh;
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      f[x][(2 * H + j) * fs] = g1[x][j];
      f[x][(3 * H + j) * fs] = g2[x][j];
    }
  }
  return g_half;
}

// One net's share of reduce_tile_wide's transpose-reduce, for the lanes of a
// 16-lane group: rows [I0, I0 + NI) of layer 1's weight gradient (h1 ⊗ g2)
// and, with VEC, the vector entries (layer 1's bias, layer 0's half row and
// bias, layer 2's column and bias).  Each lane sums the rows r = sub mod 16,
// 16 apart, in row order, every entry in registers from one load of each
// field it needs; then a 4-step butterfly adds the 16 lanes' sums in a fixed
// order, and the group's first lane adds them into the net's accumulators.
// Every entry is summed in reduce_tile's order.  The rows past the end
// carry zero gradients and add exact zeros.
template <int H, int I0, int NI, bool VEC>
__device__ __forceinline__ void reduce_net(const float* fac, int fs, int rows, int k, int net,
                                           bool active, int sub, float* awm, float* abm,
                                           int max_in) {
  using F = Fields<H>;
  constexpr int W = NI * H;                 // the layer-1 entries of this pass
  constexpr int E = W + (VEC ? 4 * H + 1 : 0);
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  if (active) {
    const float* f_half = fac + F::half(k, net) * fs;
    const float* f_out = fac + F::out(k, net) * fs;
    const float* f_h1 = fac + F::h1(k, net) * fs;
    for (int r = sub; r < rows; r += 16) {
      float g2[H];
#pragma unroll
      for (int j = 0; j < H; ++j) g2[j] = f_h1[(3 * H + j) * fs + r];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float h1 = f_h1[(I0 + i) * fs + r];
#pragma unroll
        for (int j = 0; j < H; ++j) acc[i * H + j] = fmaf(h1, g2[j], acc[i * H + j]);
      }
      if constexpr (VEC) {
        const float half = f_half[r], g_out = f_out[r];
#pragma unroll
        for (int j = 0; j < H; ++j) {
          const float h2 = f_h1[(H + j) * fs + r], g1 = f_h1[(2 * H + j) * fs + r];
          acc[W + j] += g2[j];
          acc[W + H + j] = fmaf(half, g1, acc[W + H + j]);
          acc[W + 2 * H + j] += g1;
          acc[W + 3 * H + j] = fmaf(h2, g_out, acc[W + 3 * H + j]);
        }
        acc[W + 4 * H] += g_out;
      }
    }
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (active && sub == 0) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
#pragma unroll
      for (int j = 0; j < H; ++j) awm[(max_in + I0 + i) * H + j] += acc[i * H + j];
    }
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        abm[H + j] += acc[W + j];
        awm[j] += acc[W + H + j];
        abm[j] += acc[W + 2 * H + j];
        awm[(2 * max_in + j) * H] += acc[W + 3 * H + j];
      }
      abm[2 * H] += acc[W + 4 * H];
    }
  }
}

// The transpose-reduce of a tile: every weight and bias gradient of every
// net summed over the tile's rows.  Sixteen lanes take one net (a warp two):
// each lane sums the rows r = lane mod 16, 16 apart, in row order, all H·H +
// 4H + 1 entries in registers from one load of each of the row's fields;
// then a 4-step butterfly adds the 16 lanes' sums in a fixed order, and the
// group's first lane adds them into the net's accumulators.  The rows past
// the end carry zero gradients and add exact zeros.
template <int H>
__device__ __forceinline__ void reduce_tile(const float* fac, int fs, int rows, int nets,
                                            float* aw, float* ab, int net_w, int net_b,
                                            int max_in) {
  using F = Fields<H>;
  constexpr int E = H * H + 4 * H + 1;
  const int lane = threadIdx.x % kWarp, sub = lane % 16;
  const int warps = blockDim.x / kWarp;
  for (int m0 = 2 * (threadIdx.x / kWarp); m0 < nets; m0 += 2 * warps) {   // warp-uniform
    const int m = m0 + lane / 16, k = m / 4, net = m % 4;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    if (m < nets) {
      const float* f_half = fac + F::half(k, net) * fs;
      const float* f_out = fac + F::out(k, net) * fs;
      const float* f_h1 = fac + F::h1(k, net) * fs;
      for (int r = sub; r < rows; r += 16) {
        const float half = f_half[r], g_out = f_out[r];
        float h1[H], h2[H], g1[H], g2[H];
#pragma unroll
        for (int i = 0; i < H; ++i) {
          h1[i] = f_h1[i * fs + r];
          h2[i] = f_h1[(H + i) * fs + r];
          g1[i] = f_h1[(2 * H + i) * fs + r];
          g2[i] = f_h1[(3 * H + i) * fs + r];
        }
#pragma unroll
        for (int i = 0; i < H; ++i) {
#pragma unroll
          for (int j = 0; j < H; ++j) acc[i * H + j] = fmaf(h1[i], g2[j], acc[i * H + j]);
        }
#pragma unroll
        for (int j = 0; j < H; ++j) {
          acc[H * H + j] += g2[j];
          acc[H * H + H + j] = fmaf(half, g1[j], acc[H * H + H + j]);
          acc[H * H + 2 * H + j] += g1[j];
          acc[H * H + 3 * H + j] = fmaf(h2[j], g_out, acc[H * H + 3 * H + j]);
        }
        acc[H * H + 4 * H] += g_out;
      }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    }
    if (m < nets && sub == 0) {
      float* awm = aw + m * net_w;
      float* abm = ab + m * net_b;
#pragma unroll
      for (int i = 0; i < H; ++i) {
#pragma unroll
        for (int j = 0; j < H; ++j) awm[(max_in + i) * H + j] += acc[i * H + j];
      }
#pragma unroll
      for (int j = 0; j < H; ++j) {
        abm[H + j] += acc[H * H + j];
        awm[j] += acc[H * H + H + j];
        abm[j] += acc[H * H + 2 * H + j];
        awm[(2 * max_in + j) * H] += acc[H * H + 3 * H + j];
      }
      abm[2 * H] += acc[H * H + 4 * H];
    }
  }
}

// The transpose-reduce of a tile at H = 16, where reduce_tile's one pass
// would hold H·H + 4H + 1 = 321 sums a lane: three passes of reduce_net take
// layer 1's rows 0-7, rows 8-15 and the vectors (128, 128 and 65 sums),
// reading the tile again each time.  Sixteen lanes take one net, as there.
template <int H>
__device__ __forceinline__ void reduce_tile_wide(const float* fac, int fs, int rows, int nets,
                                                 float* aw, float* ab, int net_w, int net_b,
                                                 int max_in) {
  static_assert(H == 16, "the wide reduce runs at H = 16");
  const int lane = threadIdx.x % kWarp, sub = lane % 16;
  const int warps = blockDim.x / kWarp;
  for (int m0 = 2 * (threadIdx.x / kWarp); m0 < nets; m0 += 2 * warps) {   // warp-uniform
    const int m = m0 + lane / 16, k = m / 4, net = m % 4;
    const bool active = m < nets;
    float* awm = aw + m * net_w;
    float* abm = ab + m * net_b;
    reduce_net<H, 0, H / 2, false>(fac, fs, rows, k, net, active, sub, awm, abm, max_in);
    reduce_net<H, H / 2, H / 2, false>(fac, fs, rows, k, net, active, sub, awm, abm, max_in);
    reduce_net<H, 0, 0, true>(fac, fs, rows, k, net, active, sub, awm, abm, max_in);
  }
}

// The context-row index of row r of the chain's B·N rows, by the context's
// layout (PMode): one row for all (no context), one per batch element (a
// context broadcast over the particles, particle stride 0), one per row.
enum PMode { kOneRow = 0, kPerBatch = 1, kPerRow = 2 };
__host__ __device__ __forceinline__ int ctx_row_of(int r, int n, int p_mode) {
  return p_mode == kPerRow ? r : p_mode == kPerBatch ? r / n : 0;
}

// Stage a packed chain's parameters as a chain without context: per net its
// three layers' rows 0..H-1 (H x H each; layer 0's row 0 is the half's
// weights, its other rows are not read), from the packing's rows of max_in.
template <int H>
__device__ __forceinline__ void stage_compact(float* sw, const float* __restrict__ w, int nets,
                                              int max_in) {
  const bool v4 = H % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int step = v4 ? 4 : 1, per = 3 * H * H / step;
  for (int i = threadIdx.x; i < nets * per; i += blockDim.x) {
    const int m = i / per, q = i % per * step, l = q / (H * H), o = q % (H * H);
    const float* src = w + (size_t)m * 3 * max_in * H + (size_t)l * max_in * H + o;
    if (v4) {
      copy_async16(sw + m * 3 * H * H + q, src);
    } else {
      copy_async4(sw + m * 3 * H * H + q, src);
    }
  }
}

template <int H, bool INV>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
chain_bwd_kernel(const float2* __restrict__ x, const float* __restrict__ p, int p_mode,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 const float2* __restrict__ gy, const float* __restrict__ gld,
                 float2* __restrict__ gx, float* __restrict__ g1_out,
                 float* __restrict__ gw_part, float* __restrict__ gb_part, int rows, int n,
                 int K, int max_in) {
  using F = Fields<H>;
  extern __shared__ float smem[];
  const int T = blockDim.x, t = threadIdx.x, fs = T + 4;
  // the staged parameters are a chain without context: rows of H
  const int net_w = 3 * H * H, net_b = 3 * H, nets = 4 * K, ps = nets * H;
  const int nw = nets * net_w, nb = nets * net_b;
  // shared memory, in floats: parameters (nw + nb), their gradient
  // accumulators (nw + nb), the factor tile (Fields::count(K) fields of fs)
  float* sw = smem;
  float* sb = sw + nw;
  float* aw = sb + nb;
  float* ab = aw + nw;
  float* fac = ab + nb;
  stage_compact<H>(sw, w, nets, max_in);
  stage_async(sb, bias, nb);
  for (int i = 4 * t; i < nw + nb; i += 4 * T) {   // nw and nb are multiples of 4
    *reinterpret_cast<float4*>(aw + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int tiles = (rows + T - 1) / T;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * T, row = r0 + t;
    const bool valid = row < rows;
    // a thread past the end walks the last row with zero incoming gradients
    const int r = valid ? row : rows - 1;
    copy_async_wait();   // on the first tile, the parameters
    __syncthreads();     // and the previous tile's readers are done
    // layer 0's bias and context share of this row's context row (P, from
    // the context-share kernel), read from global memory
    const float* prow = p + (size_t)ctx_row_of(r, n, p_mode) * ps;
    float* ft = fac + t;   // this row's fields, fs apart
    const float2 xv = x[r];
    float lo = xv.x, up = xv.y;

    // forward sweep: each block's inputs, outputs and activations into the tile
    for (int st = 0; st < K; ++st) {
      const int k = INV ? K - 1 - st : st;
      const float* wk = sw + k * 4 * net_w;
      const float* bk = sb + k * 4 * net_b;
      const float* pk = prow + k * 4 * H;
      float2 o1, o2;   // (t1, s1), (t2, s2)
      if (!INV) {
        ft[F::upper(k) * fs] = up;
        ft[F::half(k, 0) * fs] = lo;
        o1 = half_fwd<H>(wk, bk, net_w, net_b, H, lo, pk, ft + F::h1(k, 0) * fs,
                         ft + F::h1(k, 1) * fs, fs);
        up = o1.x + up * expf(o1.y);
        ft[F::half(k, 2) * fs] = up;
        o2 = half_fwd<H>(wk + 2 * net_w, bk + 2 * net_b, net_w, net_b, H, up, pk + 2 * H,
                         ft + F::h1(k, 2) * fs, ft + F::h1(k, 3) * fs, fs);
        lo = o2.x + lo * expf(o2.y);
      } else {
        ft[F::half(k, 2) * fs] = up;
        o2 = half_fwd<H>(wk + 2 * net_w, bk + 2 * net_b, net_w, net_b, H, up, pk + 2 * H,
                         ft + F::h1(k, 2) * fs, ft + F::h1(k, 3) * fs, fs);
        lo = (lo - o2.x) * expf(-o2.y);
        ft[F::half(k, 0) * fs] = lo;
        o1 = half_fwd<H>(wk, bk, net_w, net_b, H, lo, pk, ft + F::h1(k, 0) * fs,
                         ft + F::h1(k, 1) * fs, fs);
        up = (up - o1.x) * expf(-o1.y);
      }
      ft[F::out(k, 0) * fs] = o1.x;
      ft[F::out(k, 1) * fs] = o1.y;
      ft[F::out(k, 2) * fs] = o2.x;
      ft[F::out(k, 3) * fs] = o2.y;
    }

    // reverse sweep: each block's gradients from its fields, into its fields
    const float2 gv = valid ? gy[row] : make_float2(0.f, 0.f);
    const float g_ld = valid ? gld[row] : 0.f;
    float g_lo = gv.x, g_up = gv.y;
    for (int st = K - 1; st >= 0; --st) {
      const int k = INV ? K - 1 - st : st;
      const float* wk = sw + k * 4 * net_w;
      // d/d half of nets `net0` and net0 + 1 for the output gradients ga, gb
      auto nets_bwd = [&](int net0, float ga, float gb) {
        ft[F::out(k, net0) * fs] = ga;
        ft[F::out(k, net0 + 1) * fs] = gb;
        return half_bwd<H>(wk + net0 * net_w, net_w, H, ft + F::h1(k, net0) * fs,
                           ft + F::h1(k, net0 + 1) * fs, fs, ga, gb);
      };
      if (!INV) {
        const float lo_in = ft[F::half(k, 0) * fs], up_in = ft[F::upper(k) * fs];
        const float e1 = expf(ft[F::out(k, 1) * fs]), e2 = expf(ft[F::out(k, 3) * fs]);
        // lower_out = t2 + lo_in * exp(s2); log_det += s1 + s2
        const float g_lo_in = g_lo * e2;
        const float g_b = nets_bwd(2, g_lo, g_lo * lo_in * e2 + g_ld);
        // up_mid = t1 + up_in * exp(s1)
        const float g_up_mid = g_up + g_b;
        const float g_a = nets_bwd(0, g_up_mid, g_up_mid * up_in * e1 + g_ld);
        g_lo = g_lo_in + g_a;
        g_up = g_up_mid * e1;
      } else {
        const float lo_out = ft[F::half(k, 0) * fs], up_in = ft[F::half(k, 2) * fs];
        const float e2 = expf(-ft[F::out(k, 3) * fs]), e1 = expf(-ft[F::out(k, 1) * fs]);
        const float up_out = (up_in - ft[F::out(k, 0) * fs]) * e1;
        // up_out = (up_in - t1) * exp(-s1); log_det -= s1 + s2
        const float g_up_in = g_up * e1;
        const float g_a = nets_bwd(0, -g_up * e1, -g_up * up_out - g_ld);
        // lo_out = (lo_in - t2) * exp(-s2)
        const float g_lo_out = g_lo + g_a;
        const float g_b = nets_bwd(2, -g_lo_out * e2, -g_lo_out * lo_out - g_ld);
        g_up = g_up_in + g_b;
        g_lo = g_lo_out * e2;
      }
    }
    if (valid) gx[row] = make_float2(g_lo, g_up);
    __syncthreads();

    if constexpr (H <= 8) {
      reduce_tile<H>(fac, fs, T, nets, aw, ab, net_w, net_b, H);
    } else {
      reduce_tile_wide<H>(fac, fs, T, nets, aw, ab, net_w, net_b, H);
    }
    if (g1_out != nullptr) {
      // every valid row's layer-0 pre-activation gradients g1 (4K x H), for
      // the context kernels: global writes consecutive across the block
      const int count = min(T, rows - r0) * ps;
      for (int i = t; i < count; i += T) {
        const int rl = i / ps, e = i % ps, m = e / H;
        g1_out[(size_t)r0 * ps + i] = fac[(F::g1(m / 4, m % 4) + e % H) * fs + rl];
      }
    }
  }

  copy_async_wait();   // a block without a tile still staged its parameters
  __syncthreads();
  float* gw_out = gw_part + (size_t)blockIdx.x * nw;
  float* gb_out = gb_part + (size_t)blockIdx.x * nb;
  // the wrapper allocates the partials: 16-byte aligned, rows of nw and nb floats
  for (int i = 4 * t; i < nw; i += 4 * T) {
    *reinterpret_cast<float4*>(gw_out + i) = *reinterpret_cast<const float4*>(aw + i);
  }
  for (int i = 4 * t; i < nb; i += 4 * T) {
    *reinterpret_cast<float4*>(gb_out + i) = *reinterpret_cast<const float4*>(ab + i);
  }
}

// ---- K4: the forward kernel ------------------------------------------------

// The forward kernel's parameters in shared memory, in floats: the biases as
// packed (nets x 3H), then per net layer 0's rows 0..C ((1 + C) x H), per net
// layer 1 (H x H) and per net layer 2's column 0 (H): what the chain reads,
// none of the packing's zero rows.
template <int H>
struct FwdLayout {
  int nets, C;
  __host__ __device__ int l0() const { return (1 + C) * H; }
  __host__ __device__ int w0() const { return nets * 3 * H; }
  __host__ __device__ int w1() const { return w0() + nets * l0(); }
  __host__ __device__ int w2() const { return w1() + nets * H * H; }
  __host__ __device__ int floats() const { return w2() + nets * H; }
};

// Stage the parameters of FwdLayout from the packing with cp.async, every
// copy of a thread in flight at once (16-byte copies where H allows them).
template <int H>
__device__ __forceinline__ void stage_fwd(float* s, const float* __restrict__ w,
                                          const float* __restrict__ b, int nets, int C,
                                          int max_in) {
  const FwdLayout<H> L{nets, C};
  const int T = blockDim.x, t = threadIdx.x, net_w = 3 * max_in * H, l0 = L.l0();
  stage_async(s, b, nets * 3 * H);
  // layer 0's rows 0..C and layer 1 of each net are runs of the packing
  const bool v4 = H % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int step = v4 ? 4 : 1, per = (l0 + H * H) / step;
  for (int i = t; i < nets * per; i += T) {
    const int m = i / per, q = i % per * step;
    const bool first = q < l0;
    const float* src = w + (size_t)m * net_w + (first ? q : max_in * H + q - l0);
    float* dst = s + (first ? L.w0() + m * l0 + q : L.w1() + m * H * H + q - l0);
    if (v4) {
      copy_async16(dst, src);
    } else {
      copy_async4(dst, src);
    }
  }
  for (int i = t; i < nets * H; i += T) {   // layer 2's column 0
    copy_async4(s + L.w2() + i, w + (size_t)(i / H) * net_w + (2 * max_in + i % H) * H);
  }
}

// The two nets of a coupling half (nets m and m + 1, both on `half`) for a
// row that 2U lanes share: lane u of net xn (0 or 1) takes hidden units
// [u*J, u*J + J), J = H / U, of net m + xn; each layer's inputs come from the
// lanes that hold them by shuffles within the row's 2U lanes, and every lane
// of a net sums its output in the same order, so all of them hold it.  From
// the staged parameters s (FwdLayout) and p, layer 0's bias and context
// share of the row's context row.  Returns both outputs on every lane.
template <int H, int U>
__device__ __forceinline__ float2 half_lanes(const float* __restrict__ s, const FwdLayout<H>& L,
                                             int m, float half, const float* __restrict__ p,
                                             int xn, int u) {
  constexpr int G = 2 * U, J = H / U;
  const int mx = m + xn, j0 = u * J;
  const float* b = s + mx * 3 * H;
  const float* w0 = s + L.w0() + mx * L.l0() + j0;
  const float* w1 = s + L.w1() + mx * H * H + j0;
  const float* w2 = s + L.w2() + mx * H;
  float h1[J], a[J];
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    h1[jj] = tanhf(fmaf(half, w0[jj], p[mx * H + j0 + jj]));
    a[jj] = b[H + j0 + jj];
  }
#pragma unroll
  for (int i = 0; i < H; ++i) {
    float hi;
    if constexpr (U == 1) {
      hi = h1[i];
    } else {
      hi = __shfl_sync(0xffffffffu, h1[i % J], xn * U + i / J, G);
    }
#pragma unroll
    for (int jj = 0; jj < J; ++jj) a[jj] = fmaf(hi, w1[i * H + jj], a[jj]);
  }
#pragma unroll
  for (int jj = 0; jj < J; ++jj) a[jj] = tanhf(a[jj]);   // h2
  float out = b[2 * H];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    float hi;
    if constexpr (U == 1) {
      hi = a[i];
    } else {
      hi = __shfl_sync(0xffffffffu, a[i % J], xn * U + i / J, G);
    }
    out = fmaf(hi, w2[i], out);
  }
  const float other = __shfl_xor_sync(0xffffffffu, out, U, G);   // the other net's
  return xn == 0 ? make_float2(out, other) : make_float2(other, out);
}

// The distinct context rows a block of `rows_per_block` rows can read (each
// a row of P): one without a context, one per batch element touched when the
// context is broadcast over the particles, else one per row.
__host__ __device__ inline int max_ctx_rows(int rows_per_block, int n, int p_mode) {
  if (p_mode == kOneRow) return 1;
  const int runs = (rows_per_block - 1) / n + 2;
  return p_mode == kPerBatch && runs < rows_per_block ? runs : rows_per_block;
}

template <int H, int U, bool INV>
__global__ void __launch_bounds__(kFwdRows * 2 * U)
chain_fwd_kernel(const float2* __restrict__ x, const float* __restrict__ pg, int p_mode,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float2* __restrict__ y, float* __restrict__ ld_out, int rows, int n, int K,
                 int max_in) {
  extern __shared__ float smem[];
  constexpr int G = 2 * U;   // lanes per row
  const int T = blockDim.x, t = threadIdx.x, RB = T / G, nets = 4 * K, ps = nets * H;
  // the staged parameters are those of a chain without context (layer 0's
  // row 0): the context's share arrives in P
  const FwdLayout<H> L{nets, 0};
  float* p = smem + L.floats();
  stage_fwd<H>(smem, w, bias, nets, 0, max_in);

  // the block's distinct context rows: a run of rows of one batch element
  // when the context is broadcast over the particles, else every row; their
  // rows of P (layer 0's bias and context share) are one run of P
  const int r0 = blockIdx.x * RB, row = r0 + t / G, last = min(rows, r0 + RB) - 1;
  const int r = min(row, last);
  const int d0 = ctx_row_of(r0, n, p_mode);
  const int seg = ctx_row_of(r, n, p_mode) - d0;
  stage_async(p, pg + (size_t)d0 * ps, (ctx_row_of(last, n, p_mode) - d0 + 1) * ps);
  copy_async_wait();
  __syncthreads();

  // lanes past the last row walk it too (the shuffles need whole warps)
  const int xn = t % G / U, u = t % U;
  const float* prow = p + seg * ps;
  const float2 v = x[r];
  float lo = v.x, up = v.y, ld = 0.f;
  for (int st = 0; st < K; ++st) {
    const int m = 4 * (INV ? K - 1 - st : st);
    if (!INV) {
      const float2 o1 = half_lanes<H, U>(smem, L, m, lo, prow, xn, u);   // (t1, s1)
      up = o1.x + up * expf(o1.y);
      const float2 o2 = half_lanes<H, U>(smem, L, m + 2, up, prow, xn, u);   // (t2, s2)
      lo = o2.x + lo * expf(o2.y);
      ld = ld + o1.y + o2.y;
    } else {
      const float2 o2 = half_lanes<H, U>(smem, L, m + 2, up, prow, xn, u);
      lo = (lo - o2.x) * expf(-o2.y);
      const float2 o1 = half_lanes<H, U>(smem, L, m, lo, prow, xn, u);
      up = (up - o1.x) * expf(-o1.y);
      ld = ld - o1.y - o2.y;
    }
  }
  if (row < rows && t % G == 0) {
    y[row] = make_float2(lo, up);
    ld_out[row] = ld;
  }
}

// ---- the context kernels ----------------------------------------------------
//
// Layer 0 of every conditioner MLP reads [half | ctx]: its context share
// ctx . w[1..C] does not depend on the row's state, only on its context
// row.  These kernels take it out of K4/K5, so that the shared memory of
// those no longer grows with the context's width C (the proposal flow's
// context is 196 wide under the CGLOW measurement):
//   chain_ctx_share_kernel       P[d] = b0 + ctx[d] . w0[1..C], per distinct context row d;
//   chain_ctx_grad_rows_kernel   then chain_ctx_weight_grad_kernel: gw0[1 + c][e] =
//                                sum_d ctx[d][c] * G[d][e], G[d] the sum of K5's g1 over
//                                the rows of context row d;
//   chain_ctx_input_grad_kernel  gctx[r] = g1[r] . w0[1..C]^T, per row.
// They replace the context's share of layer 0 inside
// nfdpf_tpu/ops/pallas/coupling_pallas.py::_chain_kernel and ::_chain_bwd_kernel.
//
// What bounds them on an H100: each is a small product (R x C x 4K·H
// multiply-adds, R the distinct context rows: 32 for the filter's (32, 100)
// with the context broadcast over the particles, 16,388 for a dense (4,
// 4,097)), and the weight gradient first reads all of g1 (rows x 4K·H); the
// bytes and operations bound them at 2e-3 ms or less, so at the filter's
// sizes the time is latency: of the loads, of a dependent chain of C fmaf,
// of filling the card, and of any step that waits for all blocks.  The
// first designs gave the share a thread an entry (R = 32: 8 blocks, each
// thread C dependent fmaf fed from global memory) and the weight gradient
// a block per column of g1 (64 blocks, each reading all of g1 with lanes 64
// floats apart, a warp walking every context row for each entry): both lost
// to one torch.addmm / torch.mm, the weight gradient 41x with a dense
// context.  A one-launch weight gradient whose last block to arrive adds
// the blocks' partials lost as well: timed phase by phase, that serial sum
// (and the reads of g1 that every tile of c repeated) took most of its
// time.  Now:
//   * the share: a block per (tile of context rows, net) (a dense context:
//     per tile of 16 rows a thread x every net, so the weights are staged
//     once for many rows).  It stages the tile's context rows and its nets'
//     C x H context rows of w0 in shared memory with cp.async, C in chunks
//     that fit (a context at most 8 wide is read from global memory), and a
//     thread walks its entries' chains from shared memory, four entries of
//     a row a load.  Each entry keeps K4's former order (fmaf over c
//     ascending, then the bias added), so P, and the chain's outputs, keep
//     their bits.
//   * the weight gradient, two launches that wait for nothing but each
//     other: the first folds the rows of g1 into parts (a context broadcast
//     over the particles: each context row's sum, a block per (context row
//     or piece of one, 64 columns), 16-byte loads, row lanes added in
//     order; a dense one: ctx^T · g1 over chunks of rows staged with
//     cp.async, a thread 4 entries x 4 columns); the second weighs the
//     parts with the context and adds them, a block per context entry,
//     each output's sum split over lanes that are then added in order.
//     Fixed orders and no atomics: a second launch gives the same bits.
//   * the input gradient: a tiled GEMM, g1 and W0's context rows staged
//     with cp.async in double-buffered chunks of k, a thread 4 rows x 4
//     entries (its design above the kernel).  A thread per output, walking
//     its row of g1 with lanes H floats apart in the weights and nothing
//     staged, lost 6.7x to torch.mm at (32, 100, C = 196).
// Tensor cores would not help: the products are at most ~0.8 MFLOP at the
// filter's sizes, and TF32 breaks the gradients' 1e-4 tolerance.

// Offset of context row d in a context read through its batch and particle strides.
__device__ __forceinline__ long long ctx_offset(int d, int n, int p_mode, long long sb,
                                                long long sn) {
  return p_mode == kPerBatch ? (long long)d * sb
                             : (long long)(d / n) * sb + (long long)(d % n) * sn;
}

// Stage entries c0 .. c0 + count - 1 of `rows` context rows into dst rows
// `ld` floats apart.  Row r is batch element first + r (`by_batch`: a
// context broadcast over the particles, offset (first + r)·sb) or row
// first + r of the (batch, particle) rows (offset b·sb + i·sn).  16-byte
// copies where the pointer, strides, c0, count and ld allow them.  Rows of
// more than 32 entries: a warp a row, its lanes the entries, the (batch,
// particle) pair carried from row to row so that no lane divides; shorter
// rows (or a block that is not whole warps): a thread a row.
__device__ __forceinline__ void stage_ctx_rows(float* dst, int ld, const float* __restrict__ ctx,
                                               long long sb, long long sn, int n, bool by_batch,
                                               int first, int rows, int c0, int count) {
  const bool vec = ((reinterpret_cast<uintptr_t>(ctx) & 15) | (sb & 3) | (sn & 3) | (c0 & 3) |
                    (count & 3) | (ld & 3)) == 0;
  if (count <= kWarp || blockDim.x % kWarp != 0) {
    // a thread a row: short rows (a warp's lanes would mostly idle)
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int d = first + r;
      const float* src = ctx + c0 + (by_batch ? (long long)d * sb
                                              : (long long)(d / n) * sb + (long long)(d % n) * sn);
      float* row = dst + (size_t)r * ld;
      if (vec) {
        for (int u = 0; u < count; u += 4) copy_async16(row + u, src + u);
      } else {
        for (int u = 0; u < count; ++u) copy_async4(row + u, src + u);
      }
    }
    return;
  }
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp, warps = blockDim.x / kWarp;
  int bi = (first + warp) / n, pi = (first + warp) % n;
  for (int r = warp; r < rows; r += warps) {
    const float* src = ctx + c0 + (by_batch ? (long long)(first + r) * sb
                                            : (long long)bi * sb + (long long)pi * sn);
    float* row = dst + (size_t)r * ld;
    if (vec) {
      for (int u = 4 * lane; u < count; u += 4 * kWarp) copy_async16(row + u, src + u);
    } else {
      for (int u = lane; u < count; u += kWarp) copy_async4(row + u, src + u);
    }
    pi += warps;
    while (pi >= n) {
      pi -= n;
      ++bi;
    }
  }
}

// A block per (tile of `rows_a_block` context rows, `nets_a_block` nets); a
// thread per (row lane l, entry u of the block's nets_a_block x H entries)
// takes RPT rows of the tile, l·RPT .. l·RPT + RPT - 1.  Shared memory, in
// floats: the tile's context entries (rows_a_block rows of c_chunk rounded
// up to 4), then the block's nets' context rows of w0 (c_chunk x
// nets_a_block·H), C taken c_chunk entries at a time; a thread reads four
// entries of a row at once.  With c_chunk 0 a thread reads its operands
// from global memory (a context a few entries wide).
template <int RPT>
__global__ void chain_ctx_share_kernel(const float* __restrict__ ctx, long long sb, long long sn,
                                       int n, int C, int p_mode, const float* __restrict__ w,
                                       const float* __restrict__ bias, int max_in, int nets,
                                       int hidden, int R, int rows_a_block, int nets_a_block,
                                       int c_chunk, float* __restrict__ p) {
  extern __shared__ __align__(16) float smem[];
  const int hid = kHidden > 0 ? kHidden : hidden;
  const int et = nets_a_block * hid, t = threadIdx.x;
  const int u = t % et, first = (t / et) * RPT;
  const int m0 = blockIdx.y * nets_a_block, m = m0 + u / hid, j = u % hid;
  const int d0 = blockIdx.x * rows_a_block, dn = min(rows_a_block, R - d0);
  // layer 0's rows 1..C of net m, H floats each, column j
  const float* wm = w + (size_t)m * 3 * max_in * hid + hid + j;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  if (c_chunk == 0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (first + i >= dn) break;
      const float* cd = ctx + ctx_offset(d0 + first + i, n, p_mode, sb, sn);
      for (int c = 0; c < C; ++c) acc[i] = fmaf(__ldg(cd + c), __ldg(wm + c * hid), acc[i]);
    }
  } else {
    const int ldc = (c_chunk + 3) / 4 * 4;
    float* cs = smem;
    float* ws = smem + (size_t)rows_a_block * ldc;
    // each net's cn x H context rows are one run in the packing; 16-byte
    // copies where H is a multiple of 4 and the packing starts on 16 bytes
    const int unit = (hid % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) ? 4 : 1;
    for (int cb = 0; cb < C; cb += c_chunk) {
      const int cn = min(c_chunk, C - cb);
      stage_ctx_rows(cs, ldc, ctx, sb, sn, n, p_mode == kPerBatch, d0, dn, cb, cn);
      for (int i = t * unit; i < nets_a_block * cn * hid; i += blockDim.x * unit) {
        const int mm = i / (cn * hid), rest = i % (cn * hid);
        const int c = rest / hid, jj = rest % hid;
        float* dst = ws + c * et + mm * hid + jj;
        const float* src = w + (size_t)(m0 + mm) * 3 * max_in * hid + hid +
                           (size_t)(cb + c) * hid + jj;
        if (unit == 4) {
          copy_async16(dst, src);
        } else {
          copy_async4(dst, src);
        }
      }
      copy_async_wait();
      __syncthreads();
      const float* a = cs + (size_t)first * ldc;
      int c = 0;
      for (; c + 4 <= cn; c += 4) {
        const float w0 = ws[c * et + u], w1 = ws[(c + 1) * et + u];
        const float w2 = ws[(c + 2) * et + u], w3 = ws[(c + 3) * et + u];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(a + (size_t)i * ldc + c);
          acc[i] = fmaf(v.x, w0, acc[i]);
          acc[i] = fmaf(v.y, w1, acc[i]);
          acc[i] = fmaf(v.z, w2, acc[i]);
          acc[i] = fmaf(v.w, w3, acc[i]);
        }
      }
      for (; c < cn; ++c) {
        const float wv = ws[c * et + u];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i] = fmaf(a[(size_t)i * ldc + c], wv, acc[i]);
      }
      __syncthreads();   // before the next chunk is staged over this one
    }
  }
  const float b0 = bias[m * 3 * hid + j];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (first + i < dn) p[(size_t)(d0 + first + i) * nets * hid + m * hid + j] = b0 + acc[i];
  }
}

constexpr int kCtxThreads = 256;    // threads of a context-weight-gradient block
constexpr int kCtxColumnLanes = 16; // float4 columns a segment-sum block takes (64 floats)

// A row of staged context entries: c_tile rounded up to 4 floats.
__host__ __device__ __forceinline__ int ctx_ldc(int c_tile) { return (c_tile + 3) / 4 * 4; }

// The first kernel's shared memory in floats (the layouts above it).
__host__ __device__ __forceinline__ size_t ctx_grad_rows_smem_floats(int rows_per_block, int ps,
                                                                   int c_tile, int segments) {
  const int ps4 = ps / 4;
  if (segments) return (size_t)4 * kCtxThreads;   // a float4 a thread
  const int ldc = ctx_ldc(c_tile);
  const size_t stage = (size_t)rows_per_block * (ps + ldc);
  const size_t red = (size_t)(kCtxThreads / (ldc / 4 * ps4)) * ldc * ps;
  return stage > red ? stage : red;
}

__device__ __forceinline__ void add4(float4& s, const float4 v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// The context-weight gradient's first kernel: the rows of g1 folded into J
// rows of `parts` that the second kernel weighs with the context.
//   segments (a context broadcast over n >= the plan's minimum particles):
//     part j = d·pieces + k is the sum of g1 over rows k·rows_per_block ..
//     of context row d's n rows; a block per (part, slice of at most 64
//     columns).  Row lane l (L = 256 / column lanes, 4 columns a lane) sums
//     rows l, l + L, ... straight from global memory; the lanes are then
//     added in order.  Shared memory: a float4 sum a thread.
//   rows (a dense context, or few particles): part p (C x ps) is
//     ctx[rows of chunk p]^T · g1[chunk p], chunks of rows_per_block rows; a
//     block per (chunk, tile of c_tile entries).  The chunk's rows of g1 and
//     their context entries are staged with cp.async (rows_per_block x ps,
//     then rows_per_block x ldc); a lane takes 4 entries x 4 columns (16
//     accumulators), ldc/4 x ps/4 lanes make a group, and group g takes rows
//     g, g + groups, ...; the groups are then added in order (red, groups x
//     ldc x ps, over the staged rows).
__global__ void __launch_bounds__(kCtxThreads)
chain_ctx_grad_rows_kernel(const float* __restrict__ g1, int rows, int n,
                           const float* __restrict__ ctx, long long sb, long long sn, int C,
                           int ps, int rows_per_block, int c_tile, int segments,
                           float* __restrict__ parts) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, ps4 = ps / 4, e4 = t % ps4;
  const float4* g1v = reinterpret_cast<const float4*>(g1);
  if (segments) {
    // block (j, y): part j, columns 4·(y·cw) .. of 4·cw; cw column lanes x
    // L row lanes
    const int pieces = (n + rows_per_block - 1) / rows_per_block;
    const int d = blockIdx.x / pieces, k = blockIdx.x % pieces;
    const int a = d * n + k * rows_per_block, z = min(min(rows, (d + 1) * n), a + rows_per_block);
    const int cw = min(kCtxColumnLanes, ps4), L = kCtxThreads / cw;
    const int l = t / cw, col = blockIdx.y * cw + t % cw;
    float4* lane_sums = reinterpret_cast<float4*>(smem);
    if (l < L && col < ps4) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int r = a + l; r < z; r += L) add4(sum, __ldg(g1v + (size_t)r * ps4 + col));
      lane_sums[t] = sum;
    }
    __syncthreads();
    if (t < cw && col < ps4) {
      float4 sum = lane_sums[t];
      for (int i = 1; i < L; ++i) add4(sum, lane_sums[i * cw + t]);
      reinterpret_cast<float4*>(parts)[(size_t)blockIdx.x * ps4 + col] = sum;
    }
    return;
  }
  const int p = blockIdx.x, ldc = ctx_ldc(c_tile);
  const int c0 = blockIdx.y * c_tile, ct = min(c_tile, C - c0);
  const int r0 = p * rows_per_block, nr = min(rows - r0, rows_per_block);
  float* gr = smem;
  float* cs = gr + (size_t)rows_per_block * ps;
  stage_async(gr, g1 + (size_t)r0 * ps, nr * ps);
  stage_ctx_rows(cs, ldc, ctx, sb, sn, n, false, r0, nr, c0, ct);
  copy_async_wait();
  __syncthreads();
  const float4* gs = reinterpret_cast<const float4*>(gr);
  const int lanes = ldc / 4 * ps4, groups = kCtxThreads / lanes;
  const int g = t / lanes, cq = (t % lanes) / ps4;
  float4 acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g < groups) {
    for (int s = g; s < nr; s += groups) {
      const float4 v = gs[(size_t)s * ps4 + e4];
      const float4 av = *reinterpret_cast<const float4*>(cs + (size_t)s * ldc + 4 * cq);
      const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i].x = fmaf(a4[i], v.x, acc[i].x);
        acc[i].y = fmaf(a4[i], v.y, acc[i].y);
        acc[i].z = fmaf(a4[i], v.z, acc[i].z);
        acc[i].w = fmaf(a4[i], v.w, acc[i].w);
      }
    }
  }
  __syncthreads();   // every reader of the staged rows is done: red goes over them
  float4* red = reinterpret_cast<float4*>(smem);
  if (g < groups) {
#pragma unroll
    for (int i = 0; i < 4; ++i) red[((size_t)g * ldc + 4 * cq + i) * ps4 + e4] = acc[i];
  }
  __syncthreads();
  float4* mine = reinterpret_cast<float4*>(parts) + ((size_t)p * C + c0) * ps4;
  for (int i = t; i < ct * ps4; i += kCtxThreads) {
    const int c = i / ps4, e = i % ps4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < groups; ++k) add4(sum, red[((size_t)k * ldc + c) * ps4 + e]);
    mine[(size_t)c * ps4 + e] = sum;
  }
}

// The context-weight gradient's second kernel: gw0[1 + c][e] = sum over the
// J parts in order, weighted by the context (segments: part j of context
// row j / pieces times ctx[j / pieces][c]; rows: part j's own entry c).  A
// block per entry c; thread t takes 4 columns (lane t % (ps/4)) and the
// parts j = k, k + ways, ... (k = t / (ps/4), ways = min(J, 256 / (ps/4)));
// the ways are then added in order (shared memory: a float4 a thread).
__global__ void __launch_bounds__(kCtxThreads)
chain_ctx_weight_grad_kernel(const float* __restrict__ parts, int J, int pieces,
                             const float* __restrict__ ctx, long long sb, int C, int ps,
                             int max_in, int hidden, int segments, float* __restrict__ gw) {
  extern __shared__ __align__(16) float smem[];
  const int hid = kHidden > 0 ? kHidden : hidden;
  const int t = threadIdx.x, ps4 = ps / 4, c = blockIdx.x;
  const int ways = min(J, kCtxThreads / ps4), k = t / ps4, e4 = t % ps4;
  const float4* pv = reinterpret_cast<const float4*>(parts);
  float4* sums = reinterpret_cast<float4*>(smem);
  if (k < ways) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (segments) {
#pragma unroll 8
      for (int j = k; j < J; j += ways) {
        const float a = __ldg(ctx + (long long)(j / pieces) * sb + c);
        const float4 v = __ldg(pv + (size_t)j * ps4 + e4);
        sum.x = fmaf(a, v.x, sum.x);
        sum.y = fmaf(a, v.y, sum.y);
        sum.z = fmaf(a, v.z, sum.z);
        sum.w = fmaf(a, v.w, sum.w);
      }
    } else {
#pragma unroll 8
      for (int j = k; j < J; j += ways) add4(sum, __ldg(pv + ((size_t)j * C + c) * ps4 + e4));
    }
    sums[t] = sum;
  }
  __syncthreads();
  if (k == 0) {
    float4 sum = sums[e4];
    for (int i = 1; i < ways; ++i) add4(sum, sums[i * ps4 + e4]);
    const float out[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 4 * e4 + i, m = col / hid, j = col % hid;
      gw[(size_t)m * 3 * max_in * hid + (size_t)(1 + c) * hid + j] = out[i];
    }
  }
}

// The context-input gradient, gctx (rows x C) = g1 (rows x 4K·H) · W0c, with
// W0c[m·H + j][c] = w[m][layer 0][1 + c][j]: a small fp32 GEMM (at the
// filter's (32, 100) and C = 196, 3,200 x 64 x 196).  What bounds it on an
// H100: 2·rows·C·4K·H operations against (rows·4K·H + 4K·H·C + rows·C)
// floats, so the operation bound is the larger one at C = 196 and the bytes'
// at C <= ~16; at the filter's sizes both lie near a microsecond and the time
// is the latency of staging the operands.  The design:
//   * a block per tile of TM·TY rows x kInLanes·NJ context entries, TY x
//     kInLanes threads; a thread holds TM rows x NJ entries in registers,
//     rows ty + TY·i and entries tx + kInLanes·jj (strided, so that the
//     staged rows a warp reads fall in distinct banks and its stores of one
//     (i, jj) are kInLanes consecutive floats of a row);
//   * k = m·H + j in chunks of kInChunk, staged in a ring of 2 to 4 buffers
//     in shared memory by cp.async: the block's rows of g1 (16-byte copies),
//     and W0c's entries as they lie in the packing, a run of H floats for
//     each (entry, net) (16-byte copies where H is a multiple of 4, 4-byte
//     otherwise), both k-contiguous rows padded to kInLd floats; the next
//     stages' copies are in flight while a chunk is summed, and a whole
//     chunk's steps are unrolled so that a step's shared loads overlap the
//     previous step's fmaf;
//   * a thread reads 4 consecutive k of a staged row at once (float4) and
//     each output's sum is one fmaf chain in ascending k, from 0: the bits
//     of one thread per output walking the row, whatever the tile;
//   * the tile is the wrapper's choice (coupling_cuda.ctx_input_grad_plan,
//     from a sweep of shapes on the card): one of NFDPF_IN_TILES.  The
//     lanes, the ring's budget and whether the chunks are summed at all are
//     fixed when the library is built (NFDPF_IN_LANES, NFDPF_IN_RING,
//     NFDPF_IN_SUMS: the sweep's variant builds, tools/ctx_plan_sweep.py).
// No tensor cores: TF32 would round g1 and the weights (the gradients are
// held to 1e-4 of their scale against float32 products).
#ifndef NFDPF_IN_LANES
#define NFDPF_IN_LANES 8        // threads across a tile's entries
#endif
#ifndef NFDPF_IN_RING
#define NFDPF_IN_RING 36864     // bytes of shared memory a tile's ring may take
#endif
#ifndef NFDPF_IN_SUMS
#define NFDPF_IN_SUMS 1         // 0: stage every chunk and sum none (a timing variant)
#endif
constexpr int kInLanes = NFDPF_IN_LANES;
constexpr int kInChunk = 32;                // k entries a stage holds
constexpr int kInLd = kInChunk + 4;         // floats a staged row takes (16-byte rows)

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void copy_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Stages of a tile's ring: as many as NFDPF_IN_RING bytes hold, 2 to 4.
__host__ __device__ constexpr int in_grad_stages(int tile_rows, int tile_cols) {
  const int fit = NFDPF_IN_RING / (4 * (tile_rows + tile_cols) * kInLd);
  return fit < 2 ? 2 : fit > 4 ? 4 : fit;
}

// Shared memory of a block in floats: the ring's stages of its rows and entries.
__host__ __device__ constexpr int in_grad_smem_floats(int tile_rows, int tile_cols) {
  return in_grad_stages(tile_rows, tile_cols) * (tile_rows + tile_cols) * kInLd;
}

// The shapes the wrapper may choose, as X(TY, TM, NJ): TM·TY rows x
// kInLanes·NJ entries, TY x kInLanes threads, a thread TM rows x NJ entries
// (coupling_cuda.CTX_IN_TILES, in this order).
#define NFDPF_IN_TILES(X) X(16, 4, 4) X(16, 4, 1) X(16, 8, 2) X(16, 1, 1)

template <int TY, int TM, int NJ>
__device__ __forceinline__ void in_grad_step(const float* as, const float* bs, int ty, int tx,
                                             int k, float (&acc)[TM][NJ]) {
  float4 a[TM], b[NJ];
#pragma unroll
  for (int i = 0; i < TM; ++i)
    a[i] = *reinterpret_cast<const float4*>(as + (ty + TY * i) * kInLd + k);
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
    b[jj] = *reinterpret_cast<const float4*>(bs + (tx + kInLanes * jj) * kInLd + k);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(a[i].x, b[jj].x, acc[i][jj]);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(a[i].y, b[jj].y, acc[i][jj]);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(a[i].z, b[jj].z, acc[i][jj]);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(a[i].w, b[jj].w, acc[i][jj]);
}

template <int TY, int TM, int NJ>
__global__ void __launch_bounds__(TY * kInLanes)
chain_ctx_input_grad_kernel(const float* __restrict__ g1, int rows, int C, int ps, int max_in,
                            int hidden, const float* __restrict__ w, float* __restrict__ gctx) {
  constexpr int BM = TM * TY, BN = kInLanes * NJ, threads = TY * kInLanes;
  constexpr int kq_full = kInChunk / 4, S = in_grad_stages(BM, BN);
  __shared__ __align__(16) float smem[in_grad_smem_floats(BM, BN)];
  const int t = threadIdx.x, tx = t % kInLanes, ty = t / kInLanes;
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int nr = min(BM, rows - r0), nc = min(BN, C - c0);
  const int hid = kHidden > 0 ? kHidden : hidden;
  const bool vec_w = hid % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const size_t net_w = (size_t)3 * max_in * hid;
  const int chunks = (ps + kInChunk - 1) / kInChunk;
  // stage chunk q into buffer q % S; past the last chunk an empty group, so
  // that group q is always the (q + 1)-th committed
  auto stage = [&](int q) {
    float* as = smem + (q % S) * (BM + BN) * kInLd;
    float* bs = as + BM * kInLd;
    const int k0 = q * kInChunk, kq = q < chunks ? min(kInChunk, ps - k0) / 4 : 0;
    if (kq == kq_full) {   // a whole chunk: no division by a runtime count
      for (int i = t; i < nr * kq_full; i += threads) {
        const int r = i / kq_full, k = 4 * (i % kq_full);
        copy_async16(as + r * kInLd + k, g1 + (size_t)(r0 + r) * ps + k0 + k);
      }
    } else {
      for (int i = t; i < nr * kq; i += threads) {
        const int r = i / kq, k = 4 * (i % kq);
        copy_async16(as + r * kInLd + k, g1 + (size_t)(r0 + r) * ps + k0 + k);
      }
    }
    if (vec_w) {
      for (int i = t; i < nc * kq; i += threads) {
        const int c = i / kq, k = 4 * (i % kq), m = (k0 + k) / hid, j = (k0 + k) % hid;
        copy_async16(bs + c * kInLd + k, w + m * net_w + (size_t)(1 + c0 + c) * hid + j);
      }
    } else {
      for (int i = t; i < nc * 4 * kq; i += threads) {
        const int c = i / (4 * kq), k = i % (4 * kq), m = (k0 + k) / hid,
                  j = (k0 + k) % hid;
        copy_async4(bs + c * kInLd + k, w + m * net_w + (size_t)(1 + c0 + c) * hid + j);
      }
    }
    copy_async_commit();
  };
  float acc[TM][NJ];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
#pragma unroll
  for (int q = 0; q < S - 1; ++q) stage(q);
  for (int q = 0; q < chunks; ++q) {
    stage(q + S - 1);
    copy_async_wait_group<S - 1>();   // chunk q has landed
    __syncthreads();
    const float* as = smem + (q % S) * (BM + BN) * kInLd;
    const float* bs = as + BM * kInLd;
    const int kn = NFDPF_IN_SUMS ? min(kInChunk, ps - q * kInChunk) : 0;
    if (kn == kInChunk) {
      // a whole chunk, unrolled: the next step's shared loads are issued
      // while this step's fmaf run
#pragma unroll
      for (int k = 0; k < kInChunk; k += 4) {
        in_grad_step<TY, TM, NJ>(as, bs, ty, tx, k, acc);
      }
    } else {
      for (int k = 0; k < kn; k += 4) in_grad_step<TY, TM, NJ>(as, bs, ty, tx, k, acc);
    }
    __syncthreads();   // every reader of this stage is done before it is staged over
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + TY * i;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + kInLanes * jj;
      if (r < nr && c < nc) gctx[(size_t)(r0 + r) * C + c0 + c] = acc[i][jj];
    }
  }
}

// ---- the wide pair: K4 and K5 at any width the filter builds --------------
//
// chain_fwd_wide_kernel  replaces nfdpf_tpu/ops/pallas/coupling_pallas.py::_chain_kernel
// chain_bwd_wide_kernel  replaces nfdpf_tpu/ops/pallas/coupling_pallas.py::_chain_bwd_kernel
// for the chains the narrow pair above does not take: hidden 17-1,024,
// more than 8 blocks, or 4 or more blocks at 9-16 (the narrow backward's
// factor tile then passes a block's shared memory).  H and K are run-time
// arguments (the library built with NFDPF_HIDDEN = 0).
//
// What bounds them: per row and net 2H(H + 3) operations against 20 bytes
// of a row's input and output (the backward about four times the
// operations, and 4K·H floats of g1 written with a context), so the
// operations bound is the larger one from H of a few units on.  Nearly all
// of it is layer 1, an R x H x H product per net and tile of R rows; at the
// filter's 3,200 rows and H of a few tens the time is the dependent walk of
// 4K nets, each a few block-wide steps (times against bounds in PERF.md).
// The design, row-tiled products in plain fp32 FMA:
//   * A block of kWideThreads threads owns a tile of R rows for the whole
//     walk of the chain's 4K nets.  Its threads form a TR x TC grid over a
//     layer's R x H outputs: thread (tr, tc) holds rows tr·TM .. tr·TM +
//     TM - 1 and units tc + TC·u (u < TN) in registers (TM, TN template
//     arguments; TC, R and the chunk rows kc at run time, the wrapper's
//     plan; TC a multiple of 32, so a warp's lanes share their rows).
//   * A net: layer 0's activations h1 (R x H) are built in shared memory
//     from each row's half, layer 0's row 0 and the row's P (the context
//     share's output, unchanged: ONE_ROW / PER_BATCH / PER_ROW); layer 1 is
//     a register-tiled product: per k step a thread reads TM values of h1
//     (float4 along k, a broadcast within the warp) and TN of W1 (lanes on
//     neighbouring units) and does TM·TN FMAs, each accumulator one fmaf
//     chain in ascending k from its bias, as the narrow pair sums.
//   * W1 streams through a ring of kWideStages chunks of kc rows in shared
//     memory by cp.async.  The chunks of a walk form one stream, so the
//     next net's first chunks load during the current net's last chunks
//     and its epilogue; a net's first chunk brings its small vectors too
//     (layer 0's row 0, the biases, layer 2's column) and, where they fit,
//     the tile's rows of P, into a ring of their own, so that no step of a
//     net waits on global memory.  Each net's weights are read once per
//     tile of R rows, not once per row.
//   * The epilogue: tanh, layer 2's products summed over a thread's units,
//     a butterfly over the warp, the warps of a row group through shared
//     memory in a fixed order; thread r of the block owns row r's state,
//     updates it and publishes the next net's half.
//   * The backward keeps no factor tile of the whole chain: as
//     _chain_bwd_kernel (coupling_pallas.py:278-300) it runs the walk
//     forward keeping each row's state after every half step (2K + 1
//     (lower, upper) pairs a row, in a scratch buffer in global memory),
//     then walks the nets backwards on the same tile.  Per net: h1 and the
//     layer-1 product again, g2 = gout·w2·(1 - h2²) into shared memory; g1 =
//     (g2 · W1ᵀ) ⊙ (1 - h1²), a second product whose ring holds W1's columns
//     as rows (a transposed stage), out to global memory in K5's layout
//     (the context kernels' input) and summed against the half's weights
//     for d/d half; the weight gradient h1ᵀ · g2, a third product that
//     contracts over the tile's rows, R rows of W1 at a time; the biases'
//     and the halves' columns' gradients from per-thread sums over its rows
//     added across the row groups in order.  All of it goes into the
//     block's own partial in global memory (written on its first tile,
//     added to on the next), which the caller sums.  No atomics: a launch
//     gives the same bits every time.
//   * Tiles (the wrapper's WIDE_FWD_TILES / WIDE_BWD_TILES): 16 rows at H
//     <= 32 in the forward (two blocks an SM), else 32 up to H = 512, and
//     16 (forward) or 8 (backward) beyond, where a tile's h1, g2 and ring
//     fill a block's shared memory.  Where 3,200 rows make too few tiles for
//     132 SMs the plan takes a smaller R rather than splitting a net's
//     units over a cluster: at small H a net's time is its block-wide steps'
//     instructions and waits, not its products, and a cluster would add a
//     distributed exchange to every one of them.
// No tensor cores: 3xTF32 would triple the products' instructions for the
// tolerance, and plain TF32 would break the gradients' 1e-4.
constexpr int kWideThreads = 256;   // a wide block: 8 warps
constexpr int kWideStages = 3;      // chunks of layer 1 in the ring, nets in the vector ring
constexpr int kWideMaxHidden = 1024;
constexpr int kWidePStage = 2048;   // most floats of a net's rows of P the vector ring stages

// Floats a ring chunk's row takes (hp = TC·TN units; hp + 4 keeps a
// transposed stage's writes on distinct banks) and a row of the tile's
// activations (as far as a product reads: hp units, or the weight
// gradient's R rows of W1 at a time).
__host__ __device__ __forceinline__ int wide_ldb(int hp) { return hp + 4; }
__host__ __device__ __forceinline__ int wide_ldt(int H, int R, int hp) {
  const int reach = (H + R - 1) / R * R;
  return ((reach > hp ? reach : hp) + 3) / 4 * 4 + 4;
}
// Whether the vector ring stages the tile's rows of P (R x H rounded to 4).
__host__ __device__ __forceinline__ bool wide_p_staged(int H, int R) {
  return R * ((H + 3) / 4 * 4) <= kWidePStage;
}
// A slot of the vector ring: layer 0's row 0, layer 1's bias, layer 2's
// column (hp each), layer 2's bias (4), then the tile's rows of P where
// staged.
__host__ __device__ __forceinline__ int wide_vec_floats(int H, int R, int hp) {
  return 3 * hp + 4 + (wide_p_staged(H, R) ? R * ((H + 3) / 4 * 4) : 0);
}
// A net's entries in the backward's partials: layer 1 (H x H), layer 0's
// row 0, layer 2's column 0, layer 0's and layer 1's biases (H each) and
// layer 2's (1).
__host__ __device__ __forceinline__ int wide_part_floats(int H) { return H * H + 4 * H + 1; }

// Shared memory of a wide block in floats: the ring (kWideStages chunks of
// kc rows) and the vector ring (kWideStages slots), the tile's h1 (R
// rows), with the backward its g2 (R rows) and four per-row-group sums a
// unit; the warps' row sums, each row's half and row of P, and (backward)
// its output gradient.
__host__ __device__ __forceinline__ size_t wide_smem_floats(int H, int R, int TC, int TN, int kc,
                                                           bool backward) {
  const int hp = TC * TN, ldt = wide_ldt(H, R, hp);
  size_t f = (size_t)kWideStages * (kc * wide_ldb(hp) + wide_vec_floats(H, R, hp)) +
             (size_t)R * ldt + (size_t)R * (TC / kWarp) + 2 * R;
  if (backward) f += (size_t)R * ldt + 4 * (size_t)(kWideThreads / TC) * hp + R;
  return f;
}

// A wide block's inputs, geometry and the places of its shared memory.
struct Wide {
  const float* p;   // P, each row's layer-0 bias and context share
  const float* w;   // the packed chain
  const float* bias;
  int p_mode, n, K, max_in;
  int H, h4, R, TC, TR, hp, kc, nck, ldb, ldt, wpr, vf;
  bool pst;         // the vector ring stages P
  int tc, tr;       // this thread's unit lane and row group
  float *ring, *vring, *h1, *g2, *scr, *red, *st_half, *st_gout;
  int* st_prow;     // each row's row of P (ctx_row_of)
};

// The next chunk a walk's stream fetches: the walk's idx-th net, its q-th
// chunk (per a net: nck, or 2·nck on the backward's way back, the columns
// after the rows), into ring slot `slot`.
struct WideStream {
  int idx, q, per, slot;
  bool reverse;
};

__device__ __forceinline__ Wide wide_geom(const float* p, int p_mode, int n, const float* w,
                                          const float* bias, int K, int max_in, int H, int R,
                                          int TC, int TN, int kc, float* s, bool backward) {
  Wide g;
  g.p = p;
  g.w = w;
  g.bias = bias;
  g.p_mode = p_mode;
  g.n = n;
  g.K = K;
  g.max_in = max_in;
  g.H = H;
  g.h4 = (H + 3) / 4 * 4;
  g.R = R;
  g.TC = TC;
  g.TR = kWideThreads / TC;
  g.hp = TC * TN;
  g.kc = kc;
  g.nck = (g.h4 + kc - 1) / kc;
  g.ldb = wide_ldb(g.hp);
  g.ldt = wide_ldt(H, R, g.hp);
  g.wpr = TC / kWarp;
  g.vf = wide_vec_floats(H, R, g.hp);
  g.pst = wide_p_staged(H, R);
  g.tc = threadIdx.x % TC;
  g.tr = threadIdx.x / TC;
  g.ring = s;
  s += (size_t)kWideStages * kc * g.ldb;
  g.vring = s;
  s += (size_t)kWideStages * g.vf;
  g.h1 = s;
  s += (size_t)R * g.ldt;
  g.g2 = s;
  if (backward) s += (size_t)R * g.ldt;
  g.scr = s;
  if (backward) s += 4 * (size_t)g.TR * g.hp;
  g.red = s;
  s += (size_t)R * g.wpr;
  g.st_prow = reinterpret_cast<int*>(s);
  s += R;
  g.st_half = s;
  g.st_gout = s + R;
  return g;
}

// Net m of the walk's position pos: forward t1 s1 t2 s2 a block, inverse
// the blocks backwards, t2 s2 t1 s1 each.
template <bool INV>
__device__ __forceinline__ int wide_net_at(int pos, int K) {
  const int k = INV ? K - 1 - pos / 4 : pos / 4;
  return 4 * k + (INV ? (pos + 2) % 4 : pos % 4);
}

// Layers 0-2 of net m in the packing (w[K][4][3][max_in][H]).
__device__ __forceinline__ const float* wide_layer(const Wide& g, int m, int layer) {
  return g.w + ((size_t)m * 3 + layer) * g.max_in * g.H;
}

// The vector ring's slot of the walk's idx-th net.
__device__ __forceinline__ const float* wide_vecs(const Wide& g, int idx) {
  return g.vring + (size_t)(idx % kWideStages) * g.vf;
}

// cp.async copies that write zeros where `valid` is false (no read then).
__device__ __forceinline__ void copy_async16_zfill(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void copy_async4_zfill(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

// Stage chunk kb of a layer 1 (w1: H x H, rows of H) into `slot`: its rows
// k0 .. k0 + kc - 1 (rows from H on zero), or with `trans` its columns j0 ..
// j0 + kc - 1 as rows (slot[jj][i] = W1[i][j0 + jj]; columns from H on
// zero).  Every thread of the block; the caller commits.
__device__ __forceinline__ void wide_stage_chunk(const Wide& g, const float* __restrict__ w1,
                                                 int kb, bool trans, float* slot) {
  const int k0 = kb * g.kc, H = g.H;
  if (trans) {
    // kc is a power of two: a thread a (column, row) pair, neighbouring
    // threads on neighbouring columns of one row of W1
    const int lkc = __ffs(g.kc) - 1;
    for (int e = threadIdx.x; e < g.kc * H; e += kWideThreads) {
      const int jj = e & (g.kc - 1), i = e >> lkc, j = k0 + jj;
      copy_async4_zfill(slot + jj * g.ldb + i, w1 + (size_t)i * H + (j < H ? j : 0), j < H);
    }
    return;
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const bool by16 = H % 4 == 0 && (reinterpret_cast<uintptr_t>(w1) & 15) == 0;
  for (int kk = warp; kk < g.kc; kk += kWideThreads / kWarp) {
    const int k = k0 + kk;
    const float* src = w1 + (size_t)(k < H ? k : 0) * H;
    float* dst = slot + kk * g.ldb;
    if (by16) {
      for (int q = 4 * lane; q < H; q += 4 * kWarp) copy_async16_zfill(dst + q, src + q, k < H);
    } else {
      for (int j = lane; j < H; j += kWarp) copy_async4_zfill(dst + j, src + j, k < H);
    }
  }
}

// Stage net m's vectors (and, where staged, the tile's rows of P) into
// the vector ring's slot `vs`.  Every thread of the block; the caller
// commits.
__device__ __forceinline__ void wide_stage_vecs(const Wide& g, int m, int r0, int nr, float* vs) {
  const int H = g.H;
  const float* w0 = wide_layer(g, m, 0);
  const float* w2 = wide_layer(g, m, 2);
  const float* b1 = g.bias + ((size_t)m * 3 + 1) * H;
  // 16-byte copies where H is a multiple of 4 (every row then starts on 16
  // bytes, as the slot's parts do); layer 2's column is strided
  const bool by16 = H % 4 == 0 && ((reinterpret_cast<uintptr_t>(g.w) |
                                    reinterpret_cast<uintptr_t>(g.bias) |
                                    reinterpret_cast<uintptr_t>(g.p)) & 15) == 0;
  if (by16) {
    for (int j = 4 * threadIdx.x; j < H; j += 4 * kWideThreads) {
      copy_async16(vs + j, w0 + j);
      copy_async16(vs + g.hp + j, b1 + j);
    }
  } else {
    for (int j = threadIdx.x; j < H; j += kWideThreads) {
      copy_async4(vs + j, w0 + j);
      copy_async4(vs + g.hp + j, b1 + j);
    }
  }
  for (int j = threadIdx.x; j < H; j += kWideThreads) {
    copy_async4(vs + 2 * g.hp + j, w2 + (size_t)j * H);
  }
  if (threadIdx.x == 0) copy_async4(vs + 3 * g.hp, b1 + H);   // layer 2's bias
  if (!g.pst) return;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp, ps = 4 * g.K * H;
  for (int r = warp; r < nr; r += kWideThreads / kWarp) {
    const float* prow = g.p + (size_t)g.st_prow[r] * ps + (size_t)m * H;
    float* dst = vs + 3 * g.hp + 4 + r * g.h4;
    if (by16) {
      for (int i = 4 * lane; i < H; i += 4 * kWarp) copy_async16(dst + i, prow + i);
    } else {
      for (int i = lane; i < H; i += kWarp) copy_async4(dst + i, prow + i);
    }
  }
}

// Start the copies of the stream's next chunk into its ring slot (a net's
// vectors with its first chunk), commit (a group also past the stream's
// end, so that every step waits alike) and advance: the forward walk's
// chunks of each net's layer 1, or (`reverse`) the backward's, the nets in
// reverse order, each its layer 1's rows, then its columns.
template <bool INV>
__device__ __forceinline__ void wide_fetch(const Wide& g, WideStream& st, int r0, int nr) {
  const int nets = 4 * g.K;
  if (st.idx < nets) {
    const int m = wide_net_at<INV>(st.reverse ? nets - 1 - st.idx : st.idx, g.K);
    const bool trans = st.q >= g.nck;
    wide_stage_chunk(g, wide_layer(g, m, 1), trans ? st.q - g.nck : st.q, trans,
                     g.ring + (size_t)st.slot * g.kc * g.ldb);
    if (st.q == 0) {
      wide_stage_vecs(g, m, r0, nr, g.vring + (size_t)(st.idx % kWideStages) * g.vf);
    }
  }
  copy_async_commit();
  if (++st.q == st.per) {
    st.q = 0;
    ++st.idx;
  }
  st.slot = st.slot == kWideStages - 1 ? 0 : st.slot + 1;
}

// A walk's stream with the copies of its first kWideStages - 1 chunks
// started, after the block's synchronisation (which also publishes the
// rows of P the caller noted).
template <bool INV>
__device__ __forceinline__ WideStream wide_stream_start(const Wide& g, bool reverse, int r0,
                                                        int nr) {
  __syncthreads();   // every reader of the rings and of the tile before is done
  WideStream st{0, 0, reverse ? 2 * g.nck : g.nck, 0, reverse};
  for (int c = 0; c < kWideStages - 1; ++c) wide_fetch<INV>(g, st, r0, nr);
  return st;
}

// The start of the walk's idx-th net: its vectors (copied with its first
// chunk, at most one later group in flight) have landed; every thread
// synchronises.
__device__ __forceinline__ void wide_net_start() {
  copy_async_wait_group<kWideStages - 2>();
  __syncthreads();
}

// Layer 0's activations of the tile's rows for net m into g.h1 (row r:
// tanh(half_r · w0 + P's row of r), zero past H and on rows past nr).
__device__ __forceinline__ void wide_build_h1(const Wide& g, const float* vs, int m, int r0,
                                              int nr) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp, ps = 4 * g.K * g.H;
  for (int r = warp; r < g.R; r += kWideThreads / kWarp) {
    float* row = g.h1 + (size_t)r * g.ldt;
    if (r < nr) {
      const float half = g.st_half[r];
      const float* prow = g.pst ? vs + 3 * g.hp + 4 + r * g.h4
                                : g.p + (size_t)g.st_prow[r] * ps + (size_t)m * g.H;
      for (int i = lane; i < g.h4; i += kWarp) {
        row[i] = i < g.H ? tanhf(fmaf(half, vs[i], prow[i])) : 0.f;
      }
    } else {
      for (int i = lane; i < g.h4; i += kWarp) row[i] = 0.f;
    }
  }
}

// acc[m][u] += sum over k < klen of a[m][k] · b[k][u]: a is the thread's
// first row of the A operand at the chunk's first k (rows lda apart, float4
// along k), b the chunk at the thread's first unit (rows ldb apart, units
// TC apart).  Ascending k: each accumulator one fmaf chain.
template <int TM, int TN>
__device__ __forceinline__ void wide_mma(float (&acc)[TM][TN], const float* a, int lda,
                                         const float* b, int ldb, int klen, int TC) {
#pragma unroll 2
  for (int kk = 0; kk < klen; kk += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = *reinterpret_cast<const float4*>(a + (size_t)i * lda + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float bv[TN];
#pragma unroll
      for (int u = 0; u < TN; ++u) bv[u] = b[(kk + q) * ldb + TC * u];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float x = q == 0 ? av[i].x : q == 1 ? av[i].y : q == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int u = 0; u < TN; ++u) acc[i][u] = fmaf(x, bv[u], acc[i][u]);
      }
    }
  }
}

// acc = the bias of the thread's units (in shared memory; none: 0).
template <int TM, int TN>
__device__ __forceinline__ void wide_init_acc(float (&acc)[TM][TN], const Wide& g,
                                              const float* bias) {
#pragma unroll
  for (int u = 0; u < TN; ++u) {
    const int j = g.tc + g.TC * u;
    const float b = bias != nullptr && j < g.H ? bias[j] : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][u] = b;
  }
}

// A chunk step of a product, chunk c of the stream: wait for it (and the
// vectors that came with it), make it visible, and start the copy of the
// chunk kWideStages - 1 on into the slot the block has left.  Returns
// chunk c's slot.  A product of a net takes the stream's next nck chunks,
// acc += A · B over each (wide_mma).
template <bool INV>
__device__ __forceinline__ const float* wide_chunk_step(const Wide& g, int c, WideStream& st,
                                                        int r0, int nr) {
  copy_async_wait_group<kWideStages - 2>();
  __syncthreads();
  wide_fetch<INV>(g, st, r0, nr);
  return g.ring + (size_t)(c % kWideStages) * g.kc * g.ldb;
}

// The row sums of v[i][u] · vec[unit] over the thread's units (ascending
// u; vec in shared memory), then over the warp (a butterfly), into
// g.red[row][warp of the row group]; the caller synchronises and adds the
// row group's warps.
template <int TM, int TN>
__device__ __forceinline__ void wide_row_sums(const Wide& g, const float (&v)[TM][TN],
                                              const float* vec) {
  float part[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) part[i] = 0.f;
#pragma unroll
  for (int u = 0; u < TN; ++u) {
    const int j = g.tc + g.TC * u;
    if (j < g.H) {
      const float x = vec[j];
#pragma unroll
      for (int i = 0; i < TM; ++i) part[i] = fmaf(v[i][u], x, part[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float s = part[i];
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (threadIdx.x % kWarp == 0) g.red[(g.tr * TM + i) * g.wpr + g.tc / kWarp] = s;
  }
}

// Row r's sum of its warps' parts (in warp order).
__device__ __forceinline__ float wide_row_total(const Wide& g, int r) {
  float s = g.red[r * g.wpr];
  for (int q = 1; q < g.wpr; ++q) s += g.red[r * g.wpr + q];
  return s;
}

// Add v into the block's partial (its first tile writes, without reading).
__device__ __forceinline__ void wide_part_add(float* dst, float v, bool first) {
  if (first) {
    *dst = v;
  } else {
    *dst += v;
  }
}

// A row's state after the walk's pos-th net (net `net`) gave `out`: a t
// net's output is kept (tv) until its s net applies the pair, in the plain
// chain's order (upper, then lower; log_det + s1 + s2, inverse - s1 - s2).
template <bool INV>
__device__ __forceinline__ void wide_apply(int pos, int net, float out, float& lo, float& up,
                                           float& ld, float& tv, float& sv) {
  if (pos % 2 == 0) {
    tv = out;
  } else if (!INV) {
    if (net == 1) {
      up = tv + up * expf(out);
      sv = out;
    } else {
      lo = tv + lo * expf(out);
      ld = ld + sv + out;
    }
  } else if (net == 3) {
    lo = (lo - tv) * expf(-out);
    sv = out;
  } else {
    up = (up - tv) * expf(-out);
    ld = ld - out - sv;
  }
}

// The walk of the tile's rows (r0 .. r0 + nr - 1, inputs x) through the
// chain's 4K nets in the order they apply, to y and ld_out, or with
// `states` (sw pairs a row) each row's state before the walk and after
// every half step (the backward's forward sweep).  Thread r < nr keeps row
// r's state; the rows' sums and halves pass through shared memory.
template <int TM, int TN, bool INV>
__device__ __forceinline__ void wide_walk(const Wide& g, const float2* __restrict__ x, int r0,
                                          int nr, float2* y, float* ld_out, float2* states,
                                          int sw) {
  const int t = threadIdx.x, nets = 4 * g.K, rw = g.tr * TM;
  const bool own = t < nr;
  float lo = 0.f, up = 0.f, ld = 0.f, tv = 0.f, sv = 0.f;
  float2* my_states = own && states != nullptr ? states + (size_t)(r0 + t) * sw : nullptr;
  if (own) {
    const float2 v = x[r0 + t];
    lo = v.x;
    up = v.y;
    if (my_states != nullptr) my_states[0] = v;
  }
  if (t < g.R) g.st_prow[t] = t < nr ? ctx_row_of(r0 + t, g.n, g.p_mode) : 0;
  WideStream st = wide_stream_start<INV>(g, false, r0, nr);
  if (t < g.R) g.st_half[t] = INV ? up : lo;   // t1 reads lower, inverse t2 upper
  int c = 0;
  for (int pos = 0; pos < nets; ++pos) {
    const int m = wide_net_at<INV>(pos, g.K), net = m % 4;
    const float* vs = wide_vecs(g, pos);
    wide_net_start();   // the net's vectors; each row's half; the tile's h1 free
    wide_build_h1(g, vs, m, r0, nr);
    float acc[TM][TN];
    wide_init_acc<TM, TN>(acc, g, vs + g.hp);
    for (int kb = 0; kb < g.nck; ++kb, ++c) {
      const float* slot = wide_chunk_step<INV>(g, c, st, r0, nr);
      const int k0 = kb * g.kc;
      wide_mma<TM, TN>(acc, g.h1 + (size_t)rw * g.ldt + k0, g.ldt, slot + g.tc, g.ldb,
                       min(g.kc, g.h4 - k0), g.TC);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int u = 0; u < TN; ++u) acc[i][u] = tanhf(acc[i][u]);
    }
    wide_row_sums<TM, TN>(g, acc, vs + 2 * g.hp);
    __syncthreads();   // the row sums
    if (own) {
      wide_apply<INV>(pos, net, wide_row_total(g, t) + vs[3 * g.hp], lo, up, ld, tv, sv);
      if (my_states != nullptr && pos % 2 == 1) my_states[pos / 2 + 1] = make_float2(lo, up);
      if (pos + 1 < nets) g.st_half[t] = wide_net_at<INV>(pos + 1, g.K) % 4 < 2 ? lo : up;
    }
  }
  if (own && y != nullptr) {
    y[r0 + t] = make_float2(lo, up);
    ld_out[r0 + t] = ld;
  }
}

template <int TM, int TN, bool INV>
__global__ void __launch_bounds__(kWideThreads, 1)
chain_fwd_wide_kernel(const float2* __restrict__ x, const float* __restrict__ p, int p_mode,
                      const float* __restrict__ w, const float* __restrict__ bias,
                      float2* __restrict__ y, float* __restrict__ ld_out, int rows, int n, int K,
                      int max_in, int H, int tile_rows, int tc, int kc) {
  extern __shared__ __align__(16) float smem[];
  const Wide g = wide_geom(p, p_mode, n, w, bias, K, max_in, H, tile_rows, tc, TN, kc, smem,
                           false);
  const int tiles = (rows + tile_rows - 1) / tile_rows;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * tile_rows;
    wide_walk<TM, TN, INV>(g, x, r0, min(tile_rows, rows - r0), y, ld_out, nullptr, 0);
  }
}

// The sums over the row groups (in order) of a unit's two per-row-group
// sums in `scr` (as the backward's epilogues leave them) into the partial
// at a and b (H entries each).
__device__ __forceinline__ void wide_unit_sums(const Wide& g, const float* scr, float* a,
                                               float* b, bool first) {
  for (int j = threadIdx.x; j < g.H; j += kWideThreads) {
    float sa = 0.f, sb = 0.f;
    for (int q = 0; q < g.TR; ++q) {
      sa += scr[q * g.hp + j];
      sb += scr[(g.TR + q) * g.hp + j];
    }
    wide_part_add(a + j, sa, first);
    wide_part_add(b + j, sb, first);
  }
}

template <int TM, int TN, bool INV>
__global__ void __launch_bounds__(kWideThreads, 1)
chain_bwd_wide_kernel(const float2* __restrict__ x, const float* __restrict__ p, int p_mode,
                      const float* __restrict__ w, const float* __restrict__ bias,
                      const float2* __restrict__ gy, const float* __restrict__ gld,
                      float2* __restrict__ gx, float* __restrict__ g1_out,
                      float* __restrict__ gpart, float2* __restrict__ states, int rows, int n,
                      int K, int max_in, int H, int tile_rows, int tc, int kc) {
  extern __shared__ __align__(16) float smem[];
  const Wide g = wide_geom(p, p_mode, n, w, bias, K, max_in, H, tile_rows, tc, TN, kc, smem,
                           true);
  const int t = threadIdx.x, ps = 4 * K * H, nets = 4 * K, sw = 2 * K + 1;
  const int pf = wide_part_floats(H), hh = H * H, R = tile_rows, rw = g.tr * TM;
  const int tiles = (rows + R - 1) / R;
  float* part = gpart + (size_t)blockIdx.x * nets * pf;
  float* scr_a = g.scr;                            // layer 2's column, layer 1's bias
  float* scr_b = g.scr + 2 * (size_t)g.TR * g.hp;  // layer 0's row 0 and bias
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == blockIdx.x;
    const int r0 = tile * R, nr = min(R, rows - r0);
    const bool own = t < nr;
    float2* my_states = states + (size_t)(own ? r0 + t : 0) * sw;

    // the forward sweep, keeping each row's state after every half step
    wide_walk<TM, TN, INV>(g, x, r0, nr, nullptr, nullptr, states, sw);

    // the nets backwards: a net's chunks of W1 for its layer-1 product, then
    // its columns for g1's.  A net's sums over the row groups go into the
    // partial after the next barrier that follows them: layer 2's column
    // and layer 1's bias at the g1 product's first chunk, layer 0's row and
    // bias at the next net's first (or after the walk)
    WideStream st = wide_stream_start<INV>(g, true, r0, nr);
    // thread r < nr: its row's gradients of lower and upper, of log_det,
    // the exp of the pair's s net, the pair's d/d half so far, the states
    // around the coupling block (s0 before it, s1 after its first half, s2
    // after it), and the net's output gradient and exp
    float gl = 0.f, gu = 0.f, g_ld = 0.f, e = 0.f, gh = 0.f, gout = 0.f, e_new = 0.f;
    float2 s0 = make_float2(0.f, 0.f), s1 = s0, s2 = s0;
    if (own) {
      const float2 v = gy[r0 + t];
      gl = v.x;
      gu = v.y;
      g_ld = gld[r0 + t];
    }
    if (t < R) {
      g.st_half[t] = 0.f;
      g.st_gout[t] = 0.f;
    }
    float* pm_last = nullptr;   // the net whose layer-0 sums wait
    int c = 0;
    for (int pos = nets - 1; pos >= 0; --pos) {
      const int m = wide_net_at<INV>(pos, K), net = m % 4;
      const float* vs = wide_vecs(g, nets - 1 - pos);
      float* pm = part + (size_t)m * pf;
      if (own) {
        if (pos % 4 == 3) {
          s0 = my_states[pos / 2 - 1];
          s1 = my_states[pos / 2];
          s2 = my_states[pos / 2 + 1];
        }
        // the net's input half: forward, lower before the block (nets 0-1)
        // or upper after its first half (2-3); inverse, upper before the
        // block (2-3) or lower after its first half (0-1)
        g.st_half[t] = INV ? (net < 2 ? s1.x : s0.y) : (net < 2 ? s0.x : s1.y);
      }
      wide_net_start();   // the net's vectors; each row's half; the tile's h1 free
      wide_build_h1(g, vs, m, r0, nr);
      if (pm_last != nullptr) wide_unit_sums(g, scr_b, pm_last + hh, pm_last + hh + 2 * H, first);
      float acc[TM][TN];
      wide_init_acc<TM, TN>(acc, g, vs + g.hp);
      for (int kb = 0; kb < g.nck; ++kb, ++c) {
        const float* slot = wide_chunk_step<INV>(g, c, st, r0, nr);
        const int k0 = kb * g.kc;
        wide_mma<TM, TN>(acc, g.h1 + (size_t)rw * g.ldt + k0, g.ldt, slot + g.tc, g.ldb,
                         min(g.kc, g.h4 - k0), g.TC);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int u = 0; u < TN; ++u) acc[i][u] = tanhf(acc[i][u]);   // h2
      }
      wide_row_sums<TM, TN>(g, acc, vs + 2 * g.hp);
      __syncthreads();   // the row sums
      if (own) {
        // the output's gradient (the narrow backward's expressions)
        const float out = wide_row_total(g, t) + vs[3 * g.hp];
        e_new = e;
        if (!INV) {
          if (net == 3) {          // lower_out = t2 + lower_in * exp(s2); log_det += s2
            e_new = expf(out);
            gout = gl * s0.x * e_new + g_ld;
          } else if (net == 2) {
            gout = gl;
          } else if (net == 1) {   // up_mid = t1 + up_in * exp(s1); log_det += s1
            e_new = expf(out);
            gout = gu * s0.y * e_new + g_ld;
          } else {
            gout = gu;
          }
        } else {
          if (net == 1) {          // up_out = (up_in - t1) * exp(-s1); log_det -= s1
            e_new = expf(-out);
            gout = -gu * s2.y - g_ld;
          } else if (net == 0) {
            gout = -gu * e;
          } else if (net == 3) {   // lo_mid = (lo_in - t2) * exp(-s2); log_det -= s2
            e_new = expf(-out);
            gout = -gl * s1.x - g_ld;
          } else {
            gout = -gl * e;
          }
        }
        g.st_gout[t] = gout;
      }
      __syncthreads();   // each row's output gradient
      // g2 into the tile, and the thread's sums over its rows of h2 · gout
      // (layer 2's column) and of g2 (layer 1's bias) per unit
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        const int j = g.tc + g.TC * u;
        if (j < H) {
          const float w2j = vs[2 * g.hp + j];
          float sw2 = 0.f, sb1 = 0.f;
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float h = acc[i][u], go = g.st_gout[rw + i], gj = go * w2j * (1.f - h * h);
            g.g2[(size_t)(rw + i) * g.ldt + j] = gj;
            sw2 = fmaf(h, go, sw2);
            sb1 += gj;
          }
          scr_a[g.tr * g.hp + j] = sw2;
          scr_a[(g.TR + g.tr) * g.hp + j] = sb1;
        } else if (j < g.h4) {
#pragma unroll
          for (int i = 0; i < TM; ++i) g.g2[(size_t)(rw + i) * g.ldt + j] = 0.f;
        }
      }
      // g1 = (g2 · W1ᵀ) ⊙ (1 - h1²): the product on W1's columns
      wide_init_acc<TM, TN>(acc, g, nullptr);
      for (int kb = 0; kb < g.nck; ++kb, ++c) {
        const float* slot = wide_chunk_step<INV>(g, c, st, r0, nr);
        if (kb == 0) {
          wide_unit_sums(g, scr_a, pm + hh + H, pm + hh + 3 * H, first);
          if (t < kWarp) {   // layer 2's bias: the first warp's butterfly over the rows
            float sg = 0.f;
            for (int r = t; r < nr; r += kWarp) sg += g.st_gout[r];
#pragma unroll
            for (int o = kWarp / 2; o > 0; o >>= 1) sg += __shfl_xor_sync(0xffffffffu, sg, o);
            if (t == 0) wide_part_add(pm + hh + 4 * H, sg, first);
          }
        }
        const int k0 = kb * g.kc;
        wide_mma<TM, TN>(acc, g.g2 + (size_t)rw * g.ldt + k0, g.ldt, slot + g.tc, g.ldb,
                         min(g.kc, g.h4 - k0), g.TC);
      }
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        const int j = g.tc + g.TC * u;
        if (j < H) {
          float sg0 = 0.f, sb0 = 0.f;
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int r = rw + i;
            const float h = g.h1[(size_t)r * g.ldt + j];
            acc[i][u] *= 1.f - h * h;
            if (g1_out != nullptr && r < nr) {
              g1_out[(size_t)(r0 + r) * ps + (size_t)m * H + j] = acc[i][u];
            }
            sg0 = fmaf(g.st_half[r], acc[i][u], sg0);
            sb0 += acc[i][u];
          }
          scr_b[g.tr * g.hp + j] = sg0;
          scr_b[(g.TR + g.tr) * g.hp + j] = sb0;
        }
      }
      // d out / d half = g1 · layer 0's row 0
      wide_row_sums<TM, TN>(g, acc, vs);
      __syncthreads();   // the row sums
      if (own) {
        const float g_half = wide_row_total(g, t);
        if (pos % 2 == 1) {      // an s net: its pair's t net comes next
          e = e_new;
          gh = g_half;
        } else {
          gh += g_half;
          // the pair done: the gradients of both halves before it (t1/s1
          // read lower and scale upper, t2/s2 the other way round, in
          // either direction)
          if (net == 0) {
            gl = gl + gh;
            gu = gu * e;
          } else {
            gl = gl * e;
            gu = gu + gh;
          }
        }
      }
      pm_last = pm;
      // layer 1's weight gradient h1ᵀ · g2 over the tile's rows, R rows of
      // W1 at a time, each entry summed in row order
      for (int ib = 0; ib < H; ib += R) {
        float wg[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int u = 0; u < TN; ++u) wg[i][u] = 0.f;
        }
        const float* a = g.h1 + ib + rw;
        const float* b = g.g2 + g.tc;
        for (int r = 0; r < nr; ++r) {
          float av[TM], bv[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = a[(size_t)r * g.ldt + i];
#pragma unroll
          for (int u = 0; u < TN; ++u) bv[u] = b[(size_t)r * g.ldt + g.TC * u];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int u = 0; u < TN; ++u) wg[i][u] = fmaf(av[i], bv[u], wg[i][u]);
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int wi = ib + rw + i;
#pragma unroll
          for (int u = 0; u < TN; ++u) {
            const int j = g.tc + g.TC * u;
            if (wi < H && j < H) wide_part_add(pm + (size_t)wi * H + j, wg[i][u], first);
          }
        }
      }
    }
    __syncthreads();   // the last net's layer-0 sums
    wide_unit_sums(g, scr_b, pm_last + hh, pm_last + hh + 2 * H, first);
    if (own) gx[r0 + t] = make_float2(gl, gu);
  }
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

// The backward's shared memory in floats for a block of `threads` rows (the
// layout at the top of chain_bwd_kernel): the parameters of a chain without
// context and their gradient accumulators, and the factor tile.
size_t bwd_smem_floats(int n_blocks, int threads) {
  return 2 * (size_t)n_blocks * 12 * ((size_t)kHidden * kHidden + kHidden) +
         (size_t)Fields<kHidden>::count(n_blocks) * (threads + 4);
}

// Whether the hidden width `hidden` is this library's: its own in a library
// built for one width, any up to kWideMaxHidden in the wide library.
bool hidden_ok(int hidden) {
  return kHidden > 0 ? hidden == kHidden : hidden > 0 && hidden <= kWideMaxHidden;
}

// The last launch of each kernel (nfdpf_coupling_launch_note reads them).
enum NoteSlot { kNoteFwd, kNoteBwd, kNoteShare, kNoteGradRows, kNoteWeightGrad, kNoteInputGrad,
                kNoteFwdWide, kNoteBwdWide, kNoteSlots };
LaunchNote notes[kNoteSlots] = {};

// The wide pair's tile shapes, as X(TM, TN): a thread TM rows x TN units
// (coupling_cuda.WIDE_FWD_TILES, WIDE_BWD_TILES).
#define NFDPF_WIDE_FWD_TILES(X) X(2, 1) X(4, 2) X(4, 4) X(4, 8) X(8, 8)
#define NFDPF_WIDE_BWD_TILES(X) X(4, 1) X(4, 2) X(4, 4) X(8, 4) X(4, 8) X(8, 8)

// A plan the wide pair takes: TC a multiple of 32 that divides the block,
// R = (threads / TC)·TM rows, TC·TN >= H units, chunks of a power of two
// 4-64 rows.
bool wide_plan_ok(int hidden, int tile_rows, int tc, int tm, int tn, int kc) {
  return hidden_ok(hidden) && tc >= kWarp && tc % kWarp == 0 && kWideThreads % tc == 0 &&
         tile_rows == kWideThreads / tc * tm && tc * tn >= hidden && kc >= 4 && kc <= 64 &&
         (kc & (kc - 1)) == 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on the caller's
// stream and returns a cudaError_t: that of the shared-memory opt-in, else
// cudaGetLastError() right after the launch.  Shapes, types, devices,
// alignment and contiguity are checked by the Python wrapper.  The hidden
// width is fixed when the file is compiled (-DNFDPF_HIDDEN=H; the loader
// builds one library per width at first use), so the narrow pair's H-wide
// activations are register arrays with every loop over them unrolled; the
// library built with -DNFDPF_HIDDEN=0 takes it at run time, in the wide
// pair and the context kernels, and refuses the narrow pair.

extern "C" int nfdpf_coupling_chain_fwd(const float* x, const float* p, int p_mode,
                                        const float* w, const float* b, float* y, float* ld,
                                        int rows, int n, int n_blocks, int max_in, int hidden,
                                        int inverse, void* stream) {
  if (rows <= 0 || n <= 0 || n_blocks <= 0 || hidden != kHidden || p_mode < kOneRow ||
      p_mode > kPerRow) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#if NFDPF_HIDDEN > 0
  const int nets = 4 * n_blocks;
  const size_t smem = (FwdLayout<kHidden>{nets, 0}.floats() +
                       (size_t)max_ctx_rows(kFwdRows, n, p_mode) * nets * kHidden) *
                      sizeof(float);
  auto kernel = inverse ? chain_fwd_kernel<kHidden, kFwdLanes, true>
                        : chain_fwd_kernel<kHidden, kFwdLanes, false>;
  const int rc = reserve_smem(kernel, smem);
  if (rc != 0) return rc;
  const int grid = (rows + kFwdRows - 1) / kFwdRows;
  note_launch(notes[kNoteFwd], kernel, "chain_fwd_kernel", grid, kFwdRows * 2 * kFwdLanes, smem);
  kernel<<<grid, kFwdRows * 2 * kFwdLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(x), p, p_mode, w, b, reinterpret_cast<float2*>(y), ld,
      rows, n, n_blocks, max_in);
  return static_cast<int>(cudaGetLastError());
#else
  return static_cast<int>(cudaErrorInvalidValue);
#endif
}

extern "C" int nfdpf_coupling_chain_bwd(const float* x, const float* p, int p_mode,
                                        const float* w, const float* b, const float* gy,
                                        const float* gld, float* gx, float* g1, float* gw_part,
                                        float* gb_part, int rows, int n, int n_blocks,
                                        int max_in, int hidden, int inverse, int grid,
                                        void* stream) {
  if (rows <= 0 || n <= 0 || n_blocks <= 0 || n_blocks > kMaxBlocks || grid <= 0 ||
      hidden != kHidden || p_mode < kOneRow || p_mode > kPerRow) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#if NFDPF_HIDDEN > 0
  // warps per block: enough for `grid` blocks to cover the rows in one tile
  // each, as far as shared memory allows; the blocks loop over the tiles
  int warps = std::min<long long>(kMaxWarps, (rows + (long long)kWarp * grid - 1) /
                                                 ((long long)kWarp * grid));
  auto smem_of = [&](int warps_per_block) {
    return bwd_smem_floats(n_blocks, warps_per_block * kWarp) * sizeof(float);
  };
  while (warps > 1 && smem_of(warps) > kMaxSmem) --warps;
  const size_t smem = smem_of(warps);
  auto kernel = inverse ? chain_bwd_kernel<kHidden, true> : chain_bwd_kernel<kHidden, false>;
  const int rc = reserve_smem(kernel, smem);
  if (rc != 0) return rc;
  note_launch(notes[kNoteBwd], kernel, "chain_bwd_kernel", grid, warps * kWarp, smem);
  kernel<<<grid, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(x), p, p_mode, w, b,
      reinterpret_cast<const float2*>(gy), gld, reinterpret_cast<float2*>(gx), g1, gw_part,
      gb_part, rows, n, n_blocks, max_in);
  return static_cast<int>(cudaGetLastError());
#else
  return static_cast<int>(cudaErrorInvalidValue);
#endif
}

// The wide forward, on the wrapper's plan (wide_fwd_plan): `grid` blocks of
// kWideThreads threads looping over tiles of `tile_rows` rows, `tc` threads
// across a layer's units, a thread tm rows x tn units, layer 1 staged in
// chunks of `kc` rows.
extern "C" int nfdpf_coupling_chain_fwd_wide(const float* x, const float* p, int p_mode,
                                             const float* w, const float* b, float* y, float* ld,
                                             int rows, int n, int n_blocks, int max_in,
                                             int hidden, int inverse, int tile_rows, int tc,
                                             int tm, int tn, int kc, int grid, void* stream) {
  if (rows <= 0 || n <= 0 || n_blocks <= 0 || p_mode < kOneRow || p_mode > kPerRow ||
      grid <= 0 || !wide_plan_ok(hidden, tile_rows, tc, tm, tn, kc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#if NFDPF_HIDDEN == 0
  const size_t smem = wide_smem_floats(hidden, tile_rows, tc, tn, kc, false) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NFDPF_FWD_WIDE(TM, TN)                                                               \
  if (tm == (TM) && tn == (TN)) {                                                            \
    auto kernel = inverse ? chain_fwd_wide_kernel<TM, TN, true>                              \
                          : chain_fwd_wide_kernel<TM, TN, false>;                            \
    const int rc = reserve_smem(kernel, smem);                                               \
    if (rc != 0) return rc;                                                                  \
    note_launch(notes[kNoteFwdWide], kernel,                                                 \
                inverse ? "chain_fwd_wide_kernel<" #TM ", " #TN ", inverse>"                 \
                        : "chain_fwd_wide_kernel<" #TM ", " #TN ", forward>",                \
                grid, kWideThreads, smem);                                                   \
    kernel<<<grid, kWideThreads, smem, s>>>(reinterpret_cast<const float2*>(x), p, p_mode, w, \
                                            b, reinterpret_cast<float2*>(y), ld, rows, n,    \
                                            n_blocks, max_in, hidden, tile_rows, tc, kc);    \
    return static_cast<int>(cudaGetLastError());                                             \
  }
  NFDPF_WIDE_FWD_TILES(NFDPF_FWD_WIDE)
#undef NFDPF_FWD_WIDE
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wide backward, on the wrapper's plan (wide_bwd_plan): as the wide
// forward, `grid` blocks (at most one a tile), each writing its partial of
// the weight and bias gradients (4K x wide_part_floats(H) floats) to
// `gpart`; `states` holds 2K + 1 float2 a row; g1 may be null (no context).
extern "C" int nfdpf_coupling_chain_bwd_wide(const float* x, const float* p, int p_mode,
                                             const float* w, const float* b, const float* gy,
                                             const float* gld, float* gx, float* g1,
                                             float* gpart, float* states, int rows, int n,
                                             int n_blocks, int max_in, int hidden, int inverse,
                                             int tile_rows, int tc, int tm, int tn, int kc,
                                             int grid, void* stream) {
  if (rows <= 0 || n <= 0 || n_blocks <= 0 || p_mode < kOneRow || p_mode > kPerRow ||
      grid <= 0 || !wide_plan_ok(hidden, tile_rows, tc, tm, tn, kc) ||
      grid > (rows + tile_rows - 1) / tile_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#if NFDPF_HIDDEN == 0
  const size_t smem = wide_smem_floats(hidden, tile_rows, tc, tn, kc, true) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NFDPF_BWD_WIDE(TM, TN)                                                               \
  if (tm == (TM) && tn == (TN)) {                                                            \
    auto kernel = inverse ? chain_bwd_wide_kernel<TM, TN, true>                              \
                          : chain_bwd_wide_kernel<TM, TN, false>;                            \
    const int rc = reserve_smem(kernel, smem);                                               \
    if (rc != 0) return rc;                                                                  \
    note_launch(notes[kNoteBwdWide], kernel,                                                 \
                inverse ? "chain_bwd_wide_kernel<" #TM ", " #TN ", inverse>"                 \
                        : "chain_bwd_wide_kernel<" #TM ", " #TN ", forward>",                \
                grid, kWideThreads, smem);                                                   \
    kernel<<<grid, kWideThreads, smem, s>>>(                                                 \
        reinterpret_cast<const float2*>(x), p, p_mode, w, b,                                 \
        reinterpret_cast<const float2*>(gy), gld, reinterpret_cast<float2*>(gx), g1, gpart,  \
        reinterpret_cast<float2*>(states), rows, n, n_blocks, max_in, hidden, tile_rows, tc, \
        kc);                                                                                 \
    return static_cast<int>(cudaGetLastError());                                             \
  }
  NFDPF_WIDE_BWD_TILES(NFDPF_BWD_WIDE)
#undef NFDPF_BWD_WIDE
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

// P (R x 4K·H) from a context of `ctx_dim` entries read through its batch and
// particle strides (none when ctx_dim is 0: P is then layer 0's bias, R = 1),
// on the wrapper's plan (ctx_share_plan): blocks of `rows_a_block` context
// rows x `nets_a_block` nets, `rows_a_thread` (1 or 16) rows a thread, C
// staged `c_chunk` entries at a time (0: read from global memory).
extern "C" int nfdpf_coupling_ctx_share(const float* ctx, long long sb, long long sn, int n,
                                        int ctx_dim, int p_mode, const float* w, const float* b,
                                        int max_in, int n_blocks, int hidden, int R,
                                        int rows_a_block, int nets_a_block, int rows_a_thread,
                                        int c_chunk, float* p, void* stream) {
  const int nets = 4 * n_blocks;
  if (R <= 0 || n <= 0 || n_blocks <= 0 || !hidden_ok(hidden) || ctx_dim < 0 || c_chunk < 0 ||
      rows_a_block <= 0 || nets_a_block <= 0 || nets % nets_a_block != 0 ||
      (rows_a_thread != 1 && rows_a_thread != 16) ||
      rows_a_block % rows_a_thread != 0 ||
      (long long)rows_a_block / rows_a_thread * nets_a_block * hidden > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunk = ctx_dim > 0 ? c_chunk : 0;
  const size_t smem = ((size_t)rows_a_block * ((chunk + 3) / 4 * 4) +
                       (size_t)chunk * nets_a_block * hidden) * sizeof(float);
  auto kernel = rows_a_thread == 16 ? chain_ctx_share_kernel<16> : chain_ctx_share_kernel<1>;
  const int rc = reserve_smem(kernel, smem);
  if (rc != 0) return rc;
  const dim3 grid((R + rows_a_block - 1) / rows_a_block, nets / nets_a_block);
  const int threads = rows_a_block / rows_a_thread * nets_a_block * hidden;
  note_launch(notes[kNoteShare], kernel,
              rows_a_thread == 16 ? "chain_ctx_share_kernel<16>" : "chain_ctx_share_kernel<1>",
              grid, threads, smem);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      ctx, sb, sn, n, ctx_dim, p_mode, w, b, max_in, nets, hidden, R, rows_a_block, nets_a_block,
      chunk, p);
  return static_cast<int>(cudaGetLastError());
}

// The context-weight gradient's first kernel, on the wrapper's plan
// (ctx_weight_grad_plan): the rows of g1 folded into J parts, `parts` (J x
// ps floats with `segments`: sums over pieces of rows_per_block rows of
// each context row; else J x C x ps: ctx^T · g1 over chunks of
// rows_per_block rows, in tiles of c_tile entries).
extern "C" int nfdpf_coupling_ctx_grad_rows(const float* g1, int rows, int n, int p_mode,
                                            const float* ctx, long long sb, long long sn,
                                            int ctx_dim, int n_blocks, int hidden,
                                            int rows_per_block, int c_tile, int segments,
                                            float* parts, void* stream) {
  if (rows <= 0 || n <= 0 || ctx_dim <= 0 || n_blocks <= 0 || !hidden_ok(hidden) ||
      (p_mode != kPerBatch && p_mode != kPerRow) || rows_per_block <= 0 || c_tile <= 0 ||
      4 * n_blocks * hidden / 4 > kCtxThreads ||
      (!segments && ctx_ldc(c_tile) / 4 * (n_blocks * hidden) > kCtxThreads) ||
      (segments && (p_mode != kPerBatch || rows % n != 0)) ||
      ((reinterpret_cast<uintptr_t>(g1) | reinterpret_cast<uintptr_t>(parts)) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ps = 4 * n_blocks * hidden;
  const size_t smem = ctx_grad_rows_smem_floats(rows_per_block, ps, c_tile, segments) * sizeof(float);
  const int rc = reserve_smem(chain_ctx_grad_rows_kernel, smem);
  if (rc != 0) return rc;
  const int J = segments ? rows / n * ((n + rows_per_block - 1) / rows_per_block)
                         : (rows + rows_per_block - 1) / rows_per_block;
  const dim3 grid(J, segments ? (ps / 4 + kCtxColumnLanes - 1) / kCtxColumnLanes
                              : (ctx_dim + c_tile - 1) / c_tile);
  note_launch(notes[kNoteGradRows], chain_ctx_grad_rows_kernel, "chain_ctx_grad_rows_kernel",
              grid, kCtxThreads, smem);
  chain_ctx_grad_rows_kernel<<<grid, kCtxThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      g1, rows, n, ctx, sb, sn, ctx_dim, ps, rows_per_block, c_tile, segments, parts);
  return static_cast<int>(cudaGetLastError());
}

// The context rows of layer 0's weight gradient, written into the packed
// gradient `gw` (K x 4 x 3 x max_in x H) from the first kernel's J parts
// (`pieces` a context row with `segments`), a block per context entry.
extern "C" int nfdpf_coupling_ctx_weight_grad(const float* parts, int J, int pieces,
                                              const float* ctx, long long sb, int ctx_dim,
                                              int n_blocks, int max_in, int hidden, int segments,
                                              float* gw, void* stream) {
  if (J <= 0 || pieces <= 0 || ctx_dim <= 0 || n_blocks <= 0 || !hidden_ok(hidden) ||
      n_blocks * hidden > kCtxThreads || (reinterpret_cast<uintptr_t>(parts) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ps = 4 * n_blocks * hidden;
  note_launch(notes[kNoteWeightGrad], chain_ctx_weight_grad_kernel,
              "chain_ctx_weight_grad_kernel", ctx_dim, kCtxThreads, kCtxThreads * sizeof(float4));
  chain_ctx_weight_grad_kernel<<<ctx_dim, kCtxThreads, kCtxThreads * sizeof(float4),
                                 static_cast<cudaStream_t>(stream)>>>(
      parts, J, pieces, ctx, sb, ctx_dim, ps, max_in, hidden, segments, gw);
  return static_cast<int>(cudaGetLastError());
}

// gctx (rows x C), a row per row of the chain, on the wrapper's plan
// (ctx_input_grad_plan): tiles of `tile_rows` rows x `tile_cols` context
// entries, `rows_a_thread` rows a thread (one of NFDPF_IN_TILES).  g1 must
// be 16-byte aligned.
extern "C" int nfdpf_coupling_ctx_input_grad(const float* g1, int rows, int ctx_dim, int n_blocks,
                                             int max_in, int hidden, const float* w,
                                             int tile_rows, int tile_cols, int rows_a_thread,
                                             float* gctx, void* stream) {
  if (rows <= 0 || ctx_dim <= 0 || n_blocks <= 0 || !hidden_ok(hidden) ||
      (reinterpret_cast<uintptr_t>(g1) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((rows + tile_rows - 1) / tile_rows, (ctx_dim + tile_cols - 1) / tile_cols);
  const int ps = 4 * n_blocks * hidden;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NFDPF_IN_LAUNCH(TY, TM, NJ)                                                          \
  if (tile_rows == (TM) * (TY) && tile_cols == kInLanes * (NJ) && rows_a_thread == (TM)) {    \
    note_launch(notes[kNoteInputGrad], chain_ctx_input_grad_kernel<TY, TM, NJ>,              \
                "chain_ctx_input_grad_kernel<" #TY ", " #TM ", " #NJ ">", grid,               \
                (TY) * kInLanes, 0);                                                         \
    chain_ctx_input_grad_kernel<TY, TM, NJ>                                                  \
        <<<grid, (TY) * kInLanes, 0, s>>>(g1, rows, ctx_dim, ps, max_in, hidden, w, gctx);   \
    return static_cast<int>(cudaGetLastError());                                             \
  }
  NFDPF_IN_TILES(NFDPF_IN_LAUNCH)
#undef NFDPF_IN_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The last launch noted in `slot` (fwd, bwd, share, the weight gradient's
// first and second kernel, input gradient, the wide fwd and bwd):
// read_launch_note's record.
extern "C" int nfdpf_coupling_launch_note(int slot, long long* out, char* name, int len) {
  if (slot < 0 || slot >= kNoteSlots) return static_cast<int>(cudaErrorInvalidValue);
  return read_launch_note(notes[slot], out, name, len);
}
