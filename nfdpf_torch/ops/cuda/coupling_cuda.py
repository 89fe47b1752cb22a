"""A whole RealNVP coupling chain in one hand-written CUDA kernel, with a
fused backward.

Counterpart of ``nfdpf_tpu/ops/pallas/coupling_pallas.py``.  Two kernels
(``csrc/coupling.cu``) apply K coupling blocks × 4 conditioner MLPs to every
(B, N, 2) particle row with the chain's parameters resident in shared
memory:

* ``chain_fwd_kernel`` (K4, replaces ``_chain_kernel``,
  ``coupling_pallas.py:100``): outputs and the summed log-det, forward or
  inverse.  A row takes eight lanes at hidden width 8, four per net of a
  coupling half, 32 rows a block;
* ``chain_bwd_kernel`` (K5, replaces ``_chain_bwd_kernel``, ``:262``):
  recomputes the forward from the inputs and emits the gradients of x, one
  weight/bias partial per thread block, summed here, and with a context each
  row's layer-0 pre-activation gradients g1.  A block of 1-8 warps (one row
  per thread) loops over tiles of rows; the forward sweep keeps each row's
  activations in shared memory, the reverse sweep adds the gradients there,
  and each weight and bias gradient is then a sum over the tile's rows.

Layer 0's context share is taken out of both: more kernels compute it
once per distinct context row (R rows: B when the context is broadcast over
the particles with particle stride 0, as the filter passes it; B·N when it is
dense) and the context's gradients from K5's g1:

* ``chain_ctx_share_kernel``: P (R, 4K·H) = layer 0's bias + ctx · w0[1..C],
  which K4 and K5 read as a per-row bias (``ctx_share_plan`` lays out its
  blocks);
* ``chain_ctx_grad_rows_kernel`` then ``chain_ctx_weight_grad_kernel``:
  layer 0's context rows of the weight gradient, Σ_d ctx[d] ⊗ G[d] with G[d]
  the sum of g1 over context row d; the first folds the rows of g1 into
  parts (G's rows, or ctxᵀ · g1 over chunks of rows of a dense context), the
  second weighs and adds them (``ctx_weight_grad_plan``);
* ``chain_ctx_input_grad_kernel``: the context's gradient g1 · w0[1..C]ᵀ
  per row, a tiled GEMM (``ctx_input_grad_plan``), only when the context
  asks for one (the filter detaches its contexts).

So K4's and K5's shared memory holds a chain without context, whatever C.

``fused_coupling_chain`` takes the plain PyTorch version
(``chain_apply_packed_plain``, differentiated by ordinary autograd) for
tensors on the CPU and launches the kernels for CUDA tensors; anything else
raises.  ``chain_apply_split_plain`` is the plain version of the split
route (P first, then the chain on it).  ``LAUNCHES`` counts the kernel
launches.

The narrow pair takes the filter's state dimension (2), float32, a hidden
width up to 16 (fixed at compile time: one library per width, built at first
use; 8 is the filter's default; 3, 4, 6 and 8, which take each of the
forward's lane mappings, and 16 are the widths held against the plain
version on the card; a chain 9-15 wide runs at 16, zero-padded by
``pad_hidden``, which changes no output and whose padding's gradients are
sliced away), at most 8 blocks, and, for K5, a factor tile and twice the
parameters of a chain without context in the card's shared memory (227 KB;
``fwd_smem_bytes``, ``bwd_smem_bytes``, ``ctx_share_smem_bytes``,
``ctx_grad_rows_smem_bytes``, ``ctx_weight_grad_smem_bytes`` and
``ctx_input_grad_smem_bytes`` mirror the kernels' layouts):
``narrow_pair_takes`` says which chains.  Every other chain runs on the
wide pair, one library (``WIDE_BUILD``) whose kernels take the hidden width
and the number of blocks at run time, the context kernels included:

* ``chain_fwd_wide_kernel`` (K4 for the wide chains): a block of 256
  threads walks a tile of rows through the chain's nets, layer 1 a
  register-tiled product of the tile's activations with the net's weights
  streamed through a ring of chunks in shared memory (each net's weights
  read once a tile of rows), the row sums and each row's update after it
  (``wide_fwd_plan``);
* ``chain_bwd_wide_kernel`` (K5 for them): the walk forward keeping each
  row's state after every half step, then the nets backwards on the same
  tile: the layer-1 product again, g1 from a second product on the
  weights' columns, the weight gradient from a third that contracts over
  the tile's rows, all into one partial per thread block
  (``wide_bwd_plan``), summed here; g1 in K5's layout.

The context-weight gradient's kernels take rows of g1 at most
``CTX_GRAD_COLUMNS`` wide; a wider chain's g1 goes through them in column
groups.  ``chain_refusal`` says why a chain runs on neither pair: a hidden
width above ``WIDE_MAX_HIDDEN`` (the context-share kernel takes a thread a
hidden unit of a net, at most 1,024 a block; the wide pair's tile shapes
reach 1,024 units).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.nn import functional as F

from nfdpf_torch.ops.cuda._common import check_launch, kernel_args, on_cpu, read_launch_note
from nfdpf_torch.ops.flows import FlowChain

# kernel launches since the last reset: the forward kernel by direction, the
# backward kernel and the context kernels (the weight gradient's two)
LAUNCHES = {"coupling_chain": 0, "coupling_chain_inverse": 0, "coupling_chain_bwd": 0,
            "coupling_chain_wide": 0, "coupling_chain_wide_inverse": 0,
            "coupling_chain_bwd_wide": 0, "coupling_ctx_share": 0, "coupling_ctx_grad_rows": 0,
            "coupling_ctx_weight_grad": 0, "coupling_ctx_input_grad": 0}

NETS = ("t1", "s1", "t2", "s2")
MAX_HIDDEN = 16                   # the narrow pair's H-wide activations are register arrays
PADDED_ABOVE = 8                  # wider chains run at MAX_HIDDEN, zero-padded
MAX_BLOCKS = 8                    # chain blocks the narrow pair takes
WIDE_BUILD = 0                    # the library whose kernels take H at run time
WIDE_MAX_HIDDEN = 1024            # the widest chain (kWideMaxHidden)
WIDE_THREADS = 256                # threads of a wide block (kWideThreads)
WIDE_STAGES = 3                   # chunks of layer 1 in a wide block's ring (kWideStages)
WIDE_CHUNKS = (64, 32, 16, 8, 4)  # rows of layer 1 a ring chunk may take, the most that fit
# the wide pair's tiles as (widest hidden, TM, TN, TC): a thread TM rows x TN
# units, TC threads across the units, (WIDE_THREADS / TC)·TM rows a tile
# (NFDPF_WIDE_FWD_TILES / NFDPF_WIDE_BWD_TILES in csrc/coupling.cu)
WIDE_FWD_TILES = ((32, 2, 1, 32), (64, 4, 2, 32), (128, 4, 4, 32), (256, 4, 8, 32),
                  (512, 8, 8, 64), (1024, 8, 8, 128))
WIDE_BWD_TILES = ((32, 4, 1, 32), (64, 4, 2, 32), (128, 4, 4, 32), (256, 8, 4, 64),
                  (512, 8, 8, 64), (1024, 4, 8, 128))
WIDE_P_STAGE = 2048               # floats of a tile's rows of P a vector slot takes (kWidePStage)
WIDE_PART_BYTES = 4 << 30         # what the wide backward's partials may take
MAX_SMEM_BYTES = 232448           # dynamic shared memory a Hopper block can opt in to
FWD_ROWS_PER_BLOCK = 32           # forward rows per block
BWD_MAX_GRID = 132                # backward blocks: at most one per SM
BWD_ROWS_PER_BLOCK = 128          # backward rows per block (the entry point may take fewer)
BWD_ROWS_PER_BLOCK_WIDE = 32      # at hidden 16 shared memory holds one or two warps' tiles
BWD_MIN_THREADS = 32              # the smallest backward block (one warp)
# the context kernels' launch plans (``ctx_share_plan``, ``ctx_weight_grad_plan``)
CTX_GRID_TARGET = 132             # blocks that fill the H100's SMs
CTX_SHARE_SMEM_BYTES = 48 * 1024  # what a share block stages at once (no opt-in needed)
CTX_SHARE_DIRECT = 8              # contexts this wide: the share reads global memory directly
CTX_SHARE_WIDE_ROWS = 16          # context rows a thread of a wide share block takes
CTX_THREADS = 256                 # threads of a context-weight-gradient block (kCtxThreads)
CTX_PIECE_ROWS = 64               # rows of one context row a first-kernel block sums
CTX_COLUMN_LANES = 16             # float4 columns of g1 a segment-sum block takes
CTX_MAX_C_TILE = 128              # context entries a first-kernel block takes (dense)
CTX_GRAD_SMEM_BYTES = 100 * 1024  # what a first-kernel block stages (dense): two fit an SM
CTX_SEGMENT_MIN_N = 8             # particles a broadcast context row needs for the segment sums
CTX_IN_CHUNK = 32                 # k entries an input-gradient stage holds (kInChunk)
# the input gradient's tile shapes as (row lanes TY, rows a thread TM,
# entries a thread NJ): TM·TY rows x CTX_IN_LANES·NJ entries,
# TY·CTX_IN_LANES threads, as NFDPF_IN_TILES in csrc/coupling.cu
# instantiates them
CTX_IN_TILES = ((16, 4, 4), (16, 4, 1), (16, 8, 2), (16, 1, 1))
CTX_IN_LANES = 8                  # threads across a tile's entries (kInLanes)
CTX_IN_RING_BYTES = 36 * 1024     # shared memory a tile's ring may take (NFDPF_IN_RING)
CTX_IN_NARROW = 8                 # contexts this wide: tiles of one entry a thread
CTX_IN_ONE_ENTRY = 40             # contexts this wide: the same below CTX_IN_MANY_ROWS rows
CTX_IN_FEW_ROWS = 512             # rows of g1 below which tiles take 16 rows
CTX_IN_MANY_ROWS = 8192           # rows of g1 from which tiles take 128 rows
CTX_GRAD_COLUMNS = 4 * CTX_THREADS  # widest rows of g1 the weight gradient's kernels take
CTX_SHARE_MAX_THREADS = 512       # a share block's whole warps, most threads

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "nfdpf_coupling_chain_fwd": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "nfdpf_coupling_chain_bwd": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _P],
    "nfdpf_coupling_chain_fwd_wide": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _I, _P],
    "nfdpf_coupling_chain_bwd_wide": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "nfdpf_coupling_ctx_share": [_P, _L, _L, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _P, _P],
    "nfdpf_coupling_ctx_grad_rows": [_P, _I, _I, _I, _P, _L, _L, _I, _I, _I, _I, _I, _I,
                                     _P, _P],
    "nfdpf_coupling_ctx_weight_grad": [_P, _I, _I, _P, _L, _I, _I, _I, _I, _I, _P, _P],
    "nfdpf_coupling_ctx_input_grad": [_P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _P, _P],
    "nfdpf_coupling_launch_note": [_I, _P, _P, _I],
}
# the kernels whose last launch the library notes, in its slots' order
NOTED = ("coupling_chain", "coupling_chain_bwd", "coupling_ctx_share", "coupling_ctx_grad_rows",
         "coupling_ctx_weight_grad", "coupling_ctx_input_grad", "coupling_chain_wide",
         "coupling_chain_bwd_wide")
# how K4/K5 find a row's row of P: one row for all (no context), one per
# batch element (a context broadcast over the particles), one per row
ONE_ROW, PER_BATCH, PER_ROW = 0, 1, 2


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_defines(hidden: int) -> tuple:
    """The compile-time defines of the library for one hidden width
    (``WIDE_BUILD``: the wide library)."""
    return (f"NFDPF_HIDDEN={hidden}",)


def kernel_hidden(hidden: int) -> int:
    """The hidden width the kernels run a chain of width ``hidden`` at: its
    own up to 8, MAX_HIDDEN from 9 to 15 (a wider chain is refused)."""
    return MAX_HIDDEN if PADDED_ABOVE < hidden < MAX_HIDDEN else hidden


def pad_hidden(weights: torch.Tensor, biases: torch.Tensor,
               hidden: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A packed chain zero-padded to hidden width ``hidden`` (and its
    ``max_in`` to max(1 + C, hidden)).  A padded unit's activation is
    tanh(0) = 0 and its outgoing weights are 0, so every output gains exact
    zeros; differentiable, so the padding's gradients are sliced away."""
    h, max_in = weights.shape[-1], weights.shape[-2]
    if h == hidden:
        return weights, biases
    return (F.pad(weights, (0, hidden - h, 0, max(max_in, hidden) - max_in)),
            F.pad(biases, (0, hidden - h)))


def _library(hidden: int):
    from nfdpf_torch.ops.cuda.build import load

    return load("coupling", _SIGNATURES, build_defines(hidden))


def narrow_pair_takes(n_blocks: int, hidden: int) -> bool:
    """Whether the narrow pair (K4/K5 of one width, ``kernel_hidden``) takes
    a chain of ``n_blocks`` blocks at hidden width ``hidden``: at most 16
    wide, at most 8 blocks, and its backward's factor tile and parameters
    (and the forward's parameters with a block's most rows of P) within a
    block's shared memory for a single warp."""
    if hidden > MAX_HIDDEN or n_blocks > MAX_BLOCKS:
        return False
    h = kernel_hidden(hidden)
    return (bwd_smem_bytes(n_blocks, h, BWD_MIN_THREADS) <= MAX_SMEM_BYTES
            and fwd_smem_bytes(n_blocks, h, FWD_ROWS_PER_BLOCK) <= MAX_SMEM_BYTES)


def _chain_library(n_blocks: int, hidden: int):
    """The library that runs a chain of ``n_blocks`` at (kernel) width
    ``hidden``: the narrow one of that width, else the wide one."""
    return _library(hidden if narrow_pair_takes(n_blocks, hidden) else WIDE_BUILD)


def launch_note(hidden: int, kernel: str) -> dict:
    """The last launch of ``kernel`` (one of ``NOTED``; the forward kernels in
    either direction) from the library of kernel width ``hidden``
    (``WIDE_BUILD``: the wide library): ``read_launch_note``'s record."""
    return read_launch_note(_library(hidden).nfdpf_coupling_launch_note, NOTED.index(kernel))


def pack_chain_params(chain: FlowChain) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a d=2 RealNVP ``FlowChain`` into dense stacks.

    Returns (weights, biases):
      weights: (K, 4, 3, max_in, hidden) — per block, per net (t1, s1, t2,
               s2), per layer, as (in, out); layer 0 fills 1+ctx_dim rows,
               layers 1-2 ``hidden`` rows; the output layer column 0 only;
               ``max_in = max(1 + ctx_dim, hidden)``, the rest zeros.
      biases:  (K, 4, 3, hidden)
    Made of differentiable ops, so gradients of the stacks flow back to the
    chain's parameters.
    """
    first = chain.flows[0].t1.fc1
    hidden, max_in = first.out_features, max(first.in_features, first.out_features)
    if chain.flows[0].dim != 2:
        raise ValueError("the packed chain supports the filter's state dim (2), got "
                         f"{chain.flows[0].dim}")

    w_rows, b_rows = [], []
    for block in chain.flows:
        w_nets, b_nets = [], []
        for net in NETS:
            sub = getattr(block, net)
            ws, bs = [], []
            for layer in (sub.fc1, sub.fc2, sub.fc3):
                kern = layer.weight.t()                               # (in, out)
                ws.append(F.pad(kern, (0, hidden - kern.shape[1],
                                       0, max_in - kern.shape[0])))
                bs.append(F.pad(layer.bias, (0, hidden - layer.bias.shape[0])))
            w_nets.append(torch.stack(ws))
            b_nets.append(torch.stack(bs))
        w_rows.append(torch.stack(w_nets))
        b_rows.append(torch.stack(b_nets))
    return torch.stack(w_rows), torch.stack(b_rows)


def _chain_plain(x, weights, biases, inverse, layer0):
    """The chain on packed parameters with layer 0's pre-activation from
    ``layer0(k, net, half)``; returns (y, log_det)."""
    n_blocks, hidden = weights.shape[0], weights.shape[-1]
    lower, upper = x[..., 0:1], x[..., 1:2]
    ld = torch.zeros(x.shape[:-1] + (1,), device=x.device, dtype=x.dtype)

    def mlp(k, ni, half):
        h = torch.tanh(layer0(k, ni, half))
        h = torch.tanh(h @ weights[k, ni, 1, :hidden, :] + biases[k, ni, 1])
        return h @ weights[k, ni, 2, :hidden, :1] + biases[k, ni, 2, :1]

    order = range(n_blocks - 1, -1, -1) if inverse else range(n_blocks)
    for k in order:
        if not inverse:
            t1, s1 = mlp(k, 0, lower), mlp(k, 1, lower)
            upper = t1 + upper * torch.exp(s1)
            t2, s2 = mlp(k, 2, upper), mlp(k, 3, upper)
            lower = t2 + lower * torch.exp(s2)
            ld = ld + s1 + s2
        else:
            t2, s2 = mlp(k, 2, upper), mlp(k, 3, upper)
            lower = (lower - t2) * torch.exp(-s2)
            t1, s1 = mlp(k, 0, lower), mlp(k, 1, lower)
            upper = (upper - t1) * torch.exp(-s1)
            ld = ld - s1 - s2
    return torch.cat([lower, upper], dim=-1), ld[..., 0]


def chain_apply_packed_plain(x: torch.Tensor, ctx: Optional[torch.Tensor],
                             weights: torch.Tensor, biases: torch.Tensor,
                             inverse: bool = False):
    """Plain version of the fused kernels on packed parameters: returns
    (y (..., 2), log_det (...)).  Ordinary autograd differentiates it in x,
    ctx, weights and biases; that is the backward kernel's reference."""
    in_dim = 1 + (0 if ctx is None else ctx.shape[-1])

    def layer0(k, ni, half):
        h_in = half if ctx is None else torch.cat([half, ctx], dim=-1)
        return h_in @ weights[k, ni, 0, :in_dim, :] + biases[k, ni, 0]

    return _chain_plain(x, weights, biases, inverse, layer0)


def context_layout(ctx: Optional[torch.Tensor]) -> Tuple[int, int]:
    """(how K4/K5 map a row to its row of P, R = P's rows): ONE_ROW without
    a context; PER_BATCH for a (B, N, C) context broadcast over the
    particles (particle stride 0); else PER_ROW, R = B·N."""
    if ctx is None:
        return ONE_ROW, 1
    if ctx.stride(1) == 0:
        return PER_BATCH, ctx.shape[0]
    return PER_ROW, ctx.shape[0] * ctx.shape[1]


def _context_rows(ctx: torch.Tensor) -> torch.Tensor:
    """The R distinct context rows (R, C) the kernels read."""
    mode, _ = context_layout(ctx)
    return ctx[:, 0] if mode == PER_BATCH else ctx.reshape(-1, ctx.shape[-1])


def ctx_share_plain(ctx: Optional[torch.Tensor], weights: torch.Tensor,
                    biases: torch.Tensor) -> torch.Tensor:
    """Plain version of the context-share kernel: P (R, 4K·H), per distinct
    context row d and net m, layer 0's bias + ctx[d] · w[m][0][1..C]; without
    a context (1, 4K·H), the bias alone."""
    n_blocks, hidden = weights.shape[0], weights.shape[-1]
    bias0 = biases[:, :, 0, :].reshape(1, 4 * n_blocks * hidden)
    if ctx is None:
        return bias0
    wc = weights[:, :, 0, 1:1 + ctx.shape[-1], :]                    # (K, 4, C, H)
    share = torch.einsum("rc,kmch->rkmh", _context_rows(ctx), wc)
    return bias0 + share.reshape(share.shape[0], -1)


def chain_apply_split_plain(x: torch.Tensor, ctx: Optional[torch.Tensor],
                            weights: torch.Tensor, biases: torch.Tensor,
                            inverse: bool = False):
    """Plain version of the split route the kernels take: P from
    ``ctx_share_plain``, then the chain with each row's row of P as layer 0's
    bias and context share.  Differentiable in x, ctx, weights and biases;
    the same function as ``chain_apply_packed_plain``."""
    b, n, _ = x.shape
    n_blocks, hidden = weights.shape[0], weights.shape[-1]
    p = ctx_share_plain(ctx, weights, biases)
    mode, _ = context_layout(ctx)
    if mode == PER_ROW:
        p = p.reshape(b, n, -1)
    else:
        p = p[:, None, :].expand(b, n, -1) if mode == PER_BATCH else p.expand(b, n, -1)
    p = p.reshape(b, n, n_blocks, 4, hidden)

    def layer0(k, ni, half):
        return half * weights[k, ni, 0, 0, :] + p[:, :, k, ni]

    return _chain_plain(x, weights, biases, inverse, layer0)


def ctx_weight_grad_plain(g1: torch.Tensor, ctx: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Plain version of the context-weight-gradient kernel: layer 0's
    context rows of the weight gradient (K, 4, C, H), Σ_d ctx[d] ⊗ G[d] with
    G[d] the sum of g1 (B·N, 4K·H) over the rows of context row d."""
    n_blocks, hidden = weights.shape[0], weights.shape[-1]
    mode, r = context_layout(ctx)
    g = g1.reshape(r, -1, g1.shape[-1]).sum(1) if mode == PER_BATCH else g1
    out = _context_rows(ctx).t() @ g                                   # (C, 4K·H)
    return out.reshape(-1, n_blocks, 4, hidden).permute(1, 2, 0, 3)


def ctx_input_grad_plain(g1: torch.Tensor, weights: torch.Tensor, ctx_dim: int) -> torch.Tensor:
    """Plain version of the context-input-gradient kernel: each row's
    g1 (4K·H) against layer 0's context rows, (B·N, C)."""
    wc = weights[:, :, 0, 1:1 + ctx_dim, :].permute(0, 1, 3, 2)      # (K, 4, H, C)
    return g1 @ wc.reshape(-1, ctx_dim)


def _ctx_arg(ctx: Optional[torch.Tensor]):
    """The context as the kernels read it: float32 with a unit stride along
    its last axis and any strides (0 included: a row broadcast over the
    particles) along batch and particles.  Returns (tensor, pointer, batch
    stride, particle stride)."""
    if ctx is None:
        return None, 0, 0, 0
    if ctx.dtype != torch.float32:
        raise TypeError(f"the coupling kernels take float32, got {ctx.dtype}")
    if ctx.shape[-1] > 1 and ctx.stride(-1) != 1:
        ctx = ctx.contiguous()
    return ctx, ctx.data_ptr(), ctx.stride(0), ctx.stride(1)


def fwd_smem_bytes(n_blocks: int, hidden: int, segments: int) -> int:
    """Shared memory of the forward kernel (``FwdLayout`` without context
    and ``max_ctx_rows`` in ``csrc/coupling.cu``): per net its biases
    (3·hidden), layer 0's row 0, layer 1 and layer 2's column 0; then the
    block's rows of P (at most ``segments``, 4·K·hidden each)."""
    nets = 4 * n_blocks
    return 4 * (nets * (5 * hidden + hidden * hidden) + segments * nets * hidden)


def bwd_smem_bytes(n_blocks: int, hidden: int, threads: int = BWD_MIN_THREADS) -> int:
    """Shared memory of the backward kernel for a block of ``threads`` rows
    (``bwd_smem_floats`` in ``csrc/coupling.cu``): the parameters of a chain
    without context (K·12·(hidden² + hidden)) and their gradient
    accumulators, and the factor tile (K·(7 + 16·hidden) fields of threads +
    4 floats).  The context adds nothing: its share arrives in P."""
    return 4 * (2 * n_blocks * 12 * (hidden * hidden + hidden)
                + n_blocks * (7 + 16 * hidden) * (threads + 4))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wide_part_floats(hidden: int) -> int:
    """A net's entries in the wide backward's partials: layer 1 (H x H),
    layer 0's row 0, layer 2's column 0, layer 0's and 1's biases, layer
    2's bias."""
    return hidden * hidden + 4 * hidden + 1


def wide_vec_floats(hidden: int, tile_rows: int, hp: int) -> int:
    """A slot of the wide block's vector ring (``wide_vec_floats`` in
    ``csrc/coupling.cu``): layer 0's row 0, layer 1's bias and layer 2's
    column (hp floats each), layer 2's bias (4), then the tile's rows of P
    (``tile_rows`` x H rounded to 4) where they take at most
    ``WIDE_P_STAGE`` floats."""
    rows_p = tile_rows * _cdiv(hidden, 4) * 4
    return 3 * hp + 4 + (rows_p if rows_p <= WIDE_P_STAGE else 0)


def wide_smem_bytes(hidden: int, tile_rows: int, tc: int, tn: int, kc: int,
                    backward: bool) -> int:
    """Shared memory of a wide block (``wide_smem_floats`` in
    ``csrc/coupling.cu``): the ring's ``WIDE_STAGES`` chunks of ``kc`` rows
    of hp + 4 floats (hp = tc·tn units) and as many slots of the vector
    ring (``wide_vec_floats``), the tile's h1 (``tile_rows`` rows reaching
    past hp or ⌈H / R⌉·R units, rounded to 4, + 4), with the backward its
    g2 and four sums a row group and unit; the row sums (a float a row and
    warp of its group), each row's half and row of P, and (backward) its
    output gradient."""
    hp = tc * tn
    ldt = _cdiv(max(hp, _cdiv(hidden, tile_rows) * tile_rows), 4) * 4 + 4
    floats = (WIDE_STAGES * (kc * (hp + 4) + wide_vec_floats(hidden, tile_rows, hp))
              + tile_rows * ldt + tile_rows * (tc // 32) + 2 * tile_rows)
    if backward:
        floats += tile_rows * ldt + 4 * (WIDE_THREADS // tc) * hp + tile_rows
    return 4 * floats


def _wide_plan(rows: int, hidden: int, backward: bool) -> dict:
    """The tile shape of ``WIDE_FWD_TILES`` / ``WIDE_BWD_TILES`` for the
    width, and the largest chunk of ``WIDE_CHUNKS`` (at most the next power
    of two of H rounded to 4) whose ring fits a block's shared memory beside
    the tile; a block a tile."""
    _, tm, tn, tc = next(t for t in (WIDE_BWD_TILES if backward else WIDE_FWD_TILES)
                         if hidden <= t[0])
    tile = WIDE_THREADS // tc * tm
    most = 1 << max(2, (_cdiv(hidden, 4) * 4 - 1).bit_length())
    kc = next(k for k in WIDE_CHUNKS if k <= most and
              wide_smem_bytes(hidden, tile, tc, tn, k, backward) <= MAX_SMEM_BYTES)
    return {"tile_rows": tile, "tc": tc, "tm": tm, "tn": tn, "kc": kc,
            "tiles": _cdiv(rows, tile), "grid": _cdiv(rows, tile), "threads": WIDE_THREADS,
            "smem_bytes": wide_smem_bytes(hidden, tile, tc, tn, kc, backward)}


def wide_fwd_plan(rows: int, hidden: int) -> dict:
    """How the wide forward covers ``rows`` rows of a chain at hidden width
    ``hidden``: ``_wide_plan``."""
    return _wide_plan(rows, hidden, False)


def wide_bwd_plan(rows: int, n_blocks: int, hidden: int) -> dict:
    """How the wide backward covers ``rows`` rows: ``_wide_plan``'s tiles
    over fewer blocks where their partials (4K·``wide_part_floats`` floats
    each, ``part_floats`` in all) would pass ``WIDE_PART_BYTES`` (a block
    then adds its later tiles into its partial); ``state_floats``, the
    rows' states after each half step (2K + 1 pairs a row)."""
    plan = _wide_plan(rows, hidden, True)
    per_block = 4 * n_blocks * wide_part_floats(hidden)
    plan["grid"] = max(1, min(plan["tiles"], WIDE_PART_BYTES // (4 * per_block)))
    plan["part_floats"] = plan["grid"] * per_block
    plan["state_floats"] = rows * 2 * (2 * n_blocks + 1)
    return plan


def ctx_share_smem_bytes(rows_a_block: int, nets_a_block: int, hidden: int,
                         c_chunk: int) -> int:
    """Shared memory of the context-share kernel: a chunk of ``c_chunk``
    context entries (rounded up to 4 floats) of the block's ``rows_a_block``
    context rows, and its nets' context rows of layer 0 for that chunk
    (``c_chunk`` x nets_a_block·hidden); none where it reads global memory
    (``c_chunk`` 0)."""
    return 4 * (rows_a_block * _cdiv(c_chunk, 4) * 4 + c_chunk * nets_a_block * hidden)


def ctx_share_plan(ctx_rows: int, n_blocks: int, hidden: int, ctx_dim: int) -> dict:
    """How the context-share kernel covers P (``ctx_rows`` x 4K·H).  Wide,
    where it still makes ``CTX_GRID_TARGET`` blocks: a block takes every net,
    1-4 row lanes of ``CTX_SHARE_WIDE_ROWS`` context rows a thread (the
    weights staged once for many rows).  Else narrow: a block per (tile of context rows,
    net), a thread per (row, unit), whole warps of about 128 threads, and
    up to 256 while the target still fills.  C is staged ``c_chunk`` entries at a
    time, as many as ``CTX_SHARE_SMEM_BYTES`` holds; a context at most
    ``CTX_SHARE_DIRECT`` wide (or none) is read from global memory
    (``c_chunk`` 0)."""
    nets = 4 * n_blocks
    # wide: the most row lanes of every entry (at most 4, 128-512 threads)
    # that still make the target
    lanes = next((k for k in (4, 2, 1) if 128 <= k * nets * hidden <= 512
                  and _cdiv(ctx_rows, k * CTX_SHARE_WIDE_ROWS) >= CTX_GRID_TARGET), 0)
    if ctx_dim and lanes:
        rows, nets_a_block, rows_a_thread = lanes * CTX_SHARE_WIDE_ROWS, nets, CTX_SHARE_WIDE_ROWS
    else:
        # whole warps, about 128 threads (the plan sweep's best at the filter's
        # shapes), more while the target still fills; a wide odd width whose
        # whole warps would pass CTX_SHARE_MAX_THREADS takes any row count
        unit = 32 // math.gcd(32, hidden)
        if unit * hidden > CTX_SHARE_MAX_THREADS:
            unit = 1
        rows = unit * max(1, 128 // hidden // unit)
        while 2 * rows * hidden <= 256 and _cdiv(ctx_rows, 2 * rows) * nets >= CTX_GRID_TARGET:
            rows *= 2
        nets_a_block, rows_a_thread = 1, 1
    chunk = 0
    if ctx_dim > CTX_SHARE_DIRECT:
        chunk = min(ctx_dim, (CTX_SHARE_SMEM_BYTES // 4 - 4 * rows) // (rows + nets_a_block * hidden))
    return {"rows_a_block": rows, "nets_a_block": nets_a_block, "rows_a_thread": rows_a_thread,
            "c_chunk": chunk, "grid": (_cdiv(ctx_rows, rows), nets // nets_a_block),
            "threads": rows // rows_a_thread * nets_a_block * hidden,
            "smem_bytes": ctx_share_smem_bytes(rows, nets_a_block, hidden, chunk)}


def ctx_grad_rows_smem_bytes(rows_per_block: int, ps: int, c_tile: int, segments: bool) -> int:
    """Shared memory of the context-weight gradient's first kernel
    (``ctx_grad_rows_smem_floats`` in ``csrc/coupling.cu``) for g1 rows
    ``ps`` = 4K·H wide: with ``segments`` a float4 sum a thread; else the
    chunk's ``rows_per_block`` rows of g1 and
    their context entries (``c_tile`` rounded up to 4), or, where larger,
    the lane groups' products laid over them."""
    ps4 = ps // 4
    if segments:
        return 16 * CTX_THREADS
    ldc = _cdiv(c_tile, 4) * 4
    return 4 * max(rows_per_block * (ps + ldc), CTX_THREADS // (ldc // 4 * ps4) * ldc * ps)


def ctx_weight_grad_smem_bytes() -> int:
    """Shared memory of the context-weight gradient's second kernel: one
    float4 sum a thread."""
    return 16 * CTX_THREADS


def ctx_weight_grad_plan(rows: int, n: int, mode: int, ctx_dim: int, ps: int) -> dict:
    """How the two kernels of the context-weight gradient cover ``rows`` rows
    of g1 (``ps`` = 4K·H wide) and ``ctx_dim`` context entries.

    The first folds the rows into ``parts``: with a context broadcast over
    n >= ``CTX_SEGMENT_MIN_N`` particles (``segments``) a block sums one
    piece of at most ``CTX_PIECE_ROWS`` rows of a context row over
    ``CTX_COLUMN_LANES`` x 4 columns (J = context rows x pieces parts of ps
    floats); else a block takes a chunk of
    ``rows_per_block`` rows against a tile of ``c_tile1`` context entries
    (J = chunks parts of ctx_dim x ps floats), tiles as wide as 4 entries x 4
    columns a thread keep two lane groups, chunks as many as fill
    ``CTX_GRID_TARGET`` blocks and fit ``CTX_GRAD_SMEM_BYTES``.  The second
    weighs and adds the J parts, a block per context entry (the plan
    sweep's best: ``tools/ctx_plan_sweep.py``)."""
    ps4 = ps // 4
    segments = mode == PER_BATCH and n >= CTX_SEGMENT_MIN_N
    if segments:
        rows_per_block, c_tile1 = min(n, CTX_PIECE_ROWS), 1
        pieces = _cdiv(n, rows_per_block)
        parts = rows // n * pieces
        grid1 = (parts, _cdiv(ps4, CTX_COLUMN_LANES))
        part_floats = parts * ps
    else:
        tile_most = max(1, min(CTX_MAX_C_TILE, 4 * (CTX_THREADS // 2 // ps4)))
        q1 = _cdiv(ctx_dim, tile_most)
        c_tile1 = _cdiv(ctx_dim, q1)
        q1 = _cdiv(ctx_dim, c_tile1)
        ldc = _cdiv(c_tile1, 4) * 4
        rows_per_block = min(_cdiv(rows, max(1, CTX_GRID_TARGET // q1)),
                             CTX_GRAD_SMEM_BYTES // 4 // (ps + ldc))
        pieces, parts = 1, _cdiv(rows, rows_per_block)
        grid1 = (parts, q1)
        part_floats = parts * ctx_dim * ps
    return {"segments": segments, "rows_per_block": rows_per_block, "c_tile1": c_tile1,
            "pieces": pieces, "parts": parts, "grid1": grid1, "part_floats": part_floats,
            "smem_bytes1": ctx_grad_rows_smem_bytes(rows_per_block, ps, c_tile1, segments),
            "grid2": ctx_dim, "smem_bytes2": ctx_weight_grad_smem_bytes(),
            "threads": CTX_THREADS}


def ctx_input_grad_stages(tile_rows: int, tile_cols: int) -> int:
    """Buffers of the input gradient's ring (``in_grad_stages`` in
    ``csrc/coupling.cu``): as many stages as ``CTX_IN_RING_BYTES`` hold, 2
    to 4."""
    stage = 4 * (tile_rows + tile_cols) * (CTX_IN_CHUNK + 4)
    return min(4, max(2, CTX_IN_RING_BYTES // stage))


def ctx_input_grad_smem_bytes(tile_rows: int, tile_cols: int) -> int:
    """Shared memory of the context-input-gradient kernel
    (``in_grad_smem_floats`` in ``csrc/coupling.cu``) for a tile of
    ``tile_rows`` rows x ``tile_cols`` context entries: the ring's stages
    of the block's rows of g1 and of its context rows of layer 0,
    ``CTX_IN_CHUNK`` k entries each, rows padded by 4 floats."""
    return (4 * ctx_input_grad_stages(tile_rows, tile_cols) * (tile_rows + tile_cols)
            * (CTX_IN_CHUNK + 4))


def in_tile_plan(rows: int, ctx_dim: int, ps: int, tile) -> dict:
    """The input gradient's launch on the shape ``tile`` (TY, TM, NJ)."""
    ty, tm, nj = tile
    tile_rows, tile_cols = tm * ty, CTX_IN_LANES * nj
    return {"tile_rows": tile_rows, "tile_cols": tile_cols, "rows_a_thread": tm,
            "threads": ty * CTX_IN_LANES,
            "grid": (_cdiv(rows, tile_rows), _cdiv(ctx_dim, tile_cols)),
            "chunks": _cdiv(ps, CTX_IN_CHUNK),
            "smem_bytes": ctx_input_grad_smem_bytes(tile_rows, tile_cols)}


def ctx_input_grad_plan(rows: int, ctx_dim: int, ps: int) -> dict:
    """How the context-input-gradient kernel covers gctx (``rows`` x
    ``ctx_dim``) from g1 (``rows`` x ``ps`` = 4K·H): a block per tile of
    ``tile_rows`` x ``tile_cols`` (a shape of ``CTX_IN_TILES``),
    ``CTX_IN_LANES`` threads across the entries and tile_rows /
    ``rows_a_thread`` across the rows, a thread rows_a_thread rows x
    tile_cols / CTX_IN_LANES entries; k staged ``CTX_IN_CHUNK`` at a time
    in ``chunks`` stages.  Fewer than ``CTX_IN_FEW_ROWS`` rows take 16 x 8
    tiles (an entry a thread: enough blocks for the card); a context at
    most ``CTX_IN_NARROW`` wide, or ``CTX_IN_ONE_ENTRY`` below
    ``CTX_IN_MANY_ROWS`` rows, 64 x 8 (an entry a thread); a wider one 64 x
    32 (4 x 4 a thread), or 128 x 16 (8 x 2) from ``CTX_IN_MANY_ROWS`` rows
    on: the fastest of the plan sweep's shapes at the filter's, the dense
    and the edge shapes (``tools/ctx_plan_sweep.py``; ``PERF.md`` §6)."""
    if rows < CTX_IN_FEW_ROWS:
        tile = CTX_IN_TILES[3]
    elif ctx_dim <= CTX_IN_NARROW or (ctx_dim <= CTX_IN_ONE_ENTRY
                                      and rows < CTX_IN_MANY_ROWS):
        tile = CTX_IN_TILES[1]
    elif rows >= CTX_IN_MANY_ROWS:
        tile = CTX_IN_TILES[2]
    else:
        tile = CTX_IN_TILES[0]
    return in_tile_plan(rows, ctx_dim, ps, tile)


def ctx_grad_rows_plain(g1: torch.Tensor, ctx: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain version of the context-weight gradient's first kernel, on the
    same plan: the parts, (J, ps) sums of g1 over each piece of each
    context row (``segments``) or (J, C, ps) products ctx^T · g1 over each
    chunk of rows."""
    rows, ps = g1.shape
    b, n, ctx_dim = ctx.shape
    mode, _ = context_layout(ctx)
    plan = ctx_weight_grad_plan(rows, n, mode, ctx_dim, ps)
    rpb, parts = plan["rows_per_block"], plan["parts"]
    if plan["segments"]:
        pad = plan["pieces"] * rpb - n
        g = F.pad(g1.reshape(b, n, ps), (0, 0, 0, pad))
        return g.reshape(parts, rpb, ps).sum(1)
    pad = parts * rpb - rows
    g = F.pad(g1, (0, 0, 0, pad)).reshape(parts, rpb, ps)
    c = F.pad(ctx.reshape(rows, ctx_dim), (0, 0, 0, pad)).reshape(parts, rpb, ctx_dim)
    return torch.einsum("jrc,jre->jce", c, g)


def chain_refusal(hidden: int) -> Optional[str]:
    """Why neither pair of coupling kernels takes a chain of hidden width
    ``hidden`` (of the filter's state dimension 2, in float32: the wrapper
    checks both), None when one does: the narrow pair where
    ``narrow_pair_takes``, the wide pair any other chain up to
    ``WIDE_MAX_HIDDEN`` wide with any number of blocks and any context.
    The wrapper raises it at launch, the filter when it is built."""
    if hidden > WIDE_MAX_HIDDEN:
        return (f"the coupling kernels take hidden <= {WIDE_MAX_HIDDEN} (the context share "
                f"takes a thread a hidden unit of a net, 1,024 a block), got hidden={hidden}")
    return None


def _check_chain(x, ctx, weights, biases):
    """Shapes the packed chain must have; on CUDA also what the kernels take."""
    b, n, d = x.shape
    n_blocks, hidden, max_in = weights.shape[0], weights.shape[-1], weights.shape[-2]
    ctx_dim = 0 if ctx is None else ctx.shape[-1]
    if (d != 2 or b * n == 0 or weights.shape != (n_blocks, 4, 3, max_in, hidden)
            or biases.shape != (n_blocks, 4, 3, hidden) or n_blocks == 0
            or max_in != max(1 + ctx_dim, hidden)
            or (ctx is not None and ctx.shape != (b, n, ctx_dim))):
        raise ValueError(
            f"bad shapes x{tuple(x.shape)} "
            f"ctx{None if ctx is None else tuple(ctx.shape)} "
            f"weights{tuple(weights.shape)} biases{tuple(biases.shape)}")
    if not x.is_cuda:
        return
    why = chain_refusal(hidden)
    if why is not None:
        raise ValueError(why)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_ctx_share(lib, ctx, weights, biases):
    """(P (R, 4K·H), how a row finds its row of P) on the card: the
    context-share kernel of ``lib``."""
    ctx, ctx_ptr, ctx_sb, ctx_sn = _ctx_arg(ctx)
    mode, r = context_layout(ctx)
    weights, biases = kernel_args(weights, biases)
    n_blocks, hidden = weights.shape[0], weights.shape[-1]
    ctx_dim = 0 if ctx is None else ctx.shape[-1]
    plan = ctx_share_plan(r, n_blocks, hidden, ctx_dim)
    p = torch.empty((r, 4 * n_blocks * hidden), device=weights.device, dtype=torch.float32)
    rc = lib.nfdpf_coupling_ctx_share(
        ctx_ptr, ctx_sb, ctx_sn, 1 if ctx is None else ctx.shape[1], ctx_dim, mode,
        weights.data_ptr(), biases.data_ptr(), weights.shape[-2], n_blocks, hidden, r,
        plan["rows_a_block"], plan["nets_a_block"], plan["rows_a_thread"], plan["c_chunk"],
        p.data_ptr(), _stream(weights))
    check_launch(rc, "coupling_ctx_share")
    LAUNCHES["coupling_ctx_share"] += 1
    return p, mode


def _launch_forward(x, p, mode: int, weights, biases, inverse: bool):
    """K4 on rows x with P (``mode``: how a row finds its row of P)."""
    b, n, _ = x.shape
    x, p, weights, biases = kernel_args(x, p, weights, biases)
    y = torch.empty((b, n, 2), device=x.device, dtype=torch.float32)
    ld = torch.empty((b, n), device=x.device, dtype=torch.float32)
    rc = _library(weights.shape[-1]).nfdpf_coupling_chain_fwd(
        x.data_ptr(), p.data_ptr(), mode, weights.data_ptr(), biases.data_ptr(),
        y.data_ptr(), ld.data_ptr(), b * n, n, weights.shape[0], weights.shape[-2],
        weights.shape[-1], int(inverse), _stream(x))
    counter = "coupling_chain_inverse" if inverse else "coupling_chain"
    check_launch(rc, counter)
    LAUNCHES[counter] += 1
    return y, ld


def _wide_args(plan: dict) -> tuple:
    """A wide plan as the wide entry points take it."""
    return tuple(plan[k] for k in ("tile_rows", "tc", "tm", "tn", "kc", "grid"))


def _launch_forward_wide(x, p, mode: int, weights, biases, inverse: bool):
    """The wide forward on rows x with P, on ``wide_fwd_plan``."""
    b, n, _ = x.shape
    x, p, weights, biases = kernel_args(x, p, weights, biases)
    n_blocks, hidden = weights.shape[0], weights.shape[-1]
    plan = wide_fwd_plan(b * n, hidden)
    y = torch.empty((b, n, 2), device=x.device, dtype=torch.float32)
    ld = torch.empty((b, n), device=x.device, dtype=torch.float32)
    rc = _library(WIDE_BUILD).nfdpf_coupling_chain_fwd_wide(
        x.data_ptr(), p.data_ptr(), mode, weights.data_ptr(), biases.data_ptr(),
        y.data_ptr(), ld.data_ptr(), b * n, n, n_blocks, weights.shape[-2], hidden,
        int(inverse), *_wide_args(plan), _stream(x))
    counter = "coupling_chain_wide_inverse" if inverse else "coupling_chain_wide"
    check_launch(rc, counter)
    LAUNCHES[counter] += 1
    return y, ld


def _launch_backward(x, p, mode: int, weights, biases, gy, gld, inverse: bool,
                     with_g1: bool):
    """K5: (gx, each row's g1 (B·N, 4K·H) or None, the weight gradient of a
    chain without context (K, 4, 3, H, H), the bias gradient)."""
    b, n, _ = x.shape
    x, p, weights, biases, gy, gld = kernel_args(x, p, weights, biases, gy, gld)
    dev = x.device
    n_blocks, hidden = weights.shape[0], weights.shape[-1]
    per_block = BWD_ROWS_PER_BLOCK if hidden <= PADDED_ABOVE else BWD_ROWS_PER_BLOCK_WIDE
    grid = min(-(-b * n // per_block), BWD_MAX_GRID)
    gx = torch.empty((b, n, 2), device=dev, dtype=torch.float32)
    g1 = (torch.empty((b * n, 4 * n_blocks * hidden), device=dev, dtype=torch.float32)
          if with_g1 else None)
    gw_part = torch.empty((grid, n_blocks, 4, 3, hidden, hidden), device=dev,
                          dtype=torch.float32)
    gb_part = torch.empty((grid,) + biases.shape, device=dev, dtype=torch.float32)
    rc = _library(hidden).nfdpf_coupling_chain_bwd(
        x.data_ptr(), p.data_ptr(), mode, weights.data_ptr(), biases.data_ptr(),
        gy.data_ptr(), gld.data_ptr(), gx.data_ptr(), 0 if g1 is None else g1.data_ptr(),
        gw_part.data_ptr(), gb_part.data_ptr(), b * n, n, n_blocks, weights.shape[-2],
        hidden, int(inverse), grid, _stream(x))
    check_launch(rc, "coupling_chain_bwd")
    LAUNCHES["coupling_chain_bwd"] += 1
    return gx, g1, torch.sum(gw_part, dim=0), torch.sum(gb_part, dim=0)


def wide_grads(parts: torch.Tensor, hidden: int,
               max_in: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed weight (K, 4, 3, max_in, H) and bias (K, 4, 3, H) gradients
    of a chain without context from the wide backward's summed partials
    (K, 4, ``wide_part_floats(H)``): layer 1, layer 0's row 0, layer 2's
    column 0, then the biases; every other entry 0 (layer 0's context rows
    are the context-weight gradient's)."""
    n_blocks, h, hh = parts.shape[0], hidden, hidden * hidden
    gw = parts.new_zeros((n_blocks, 4, 3, max_in, h))
    gb = parts.new_zeros((n_blocks, 4, 3, h))
    gw[:, :, 1, :h] = parts[..., :hh].reshape(n_blocks, 4, h, h)
    gw[:, :, 0, 0] = parts[..., hh:hh + h]
    gw[:, :, 2, :h, 0] = parts[..., hh + h:hh + 2 * h]
    gb[:, :, 0] = parts[..., hh + 2 * h:hh + 3 * h]
    gb[:, :, 1] = parts[..., hh + 3 * h:hh + 4 * h]
    gb[:, :, 2, 0] = parts[..., hh + 4 * h]
    return gw, gb


def wide_backward_parts(x, p, mode: int, weights, biases, gy, gld, inverse: bool,
                        with_g1: bool):
    """The wide backward kernel on ``wide_bwd_plan``: (gx, each row's g1
    (B·N, 4K·H) or None, the blocks' partials (grid, K, 4,
    ``wide_part_floats(H)``))."""
    b, n, _ = x.shape
    x, p, weights, biases, gy, gld = kernel_args(x, p, weights, biases, gy, gld)
    dev, rows = x.device, b * n
    n_blocks, hidden = weights.shape[0], weights.shape[-1]
    plan = wide_bwd_plan(rows, n_blocks, hidden)
    gx = torch.empty((b, n, 2), device=dev, dtype=torch.float32)
    g1 = (torch.empty((rows, 4 * n_blocks * hidden), device=dev, dtype=torch.float32)
          if with_g1 else None)
    gpart = torch.empty(plan["part_floats"], device=dev, dtype=torch.float32)
    states = torch.empty(plan["state_floats"], device=dev, dtype=torch.float32)
    rc = _library(WIDE_BUILD).nfdpf_coupling_chain_bwd_wide(
        x.data_ptr(), p.data_ptr(), mode, weights.data_ptr(), biases.data_ptr(),
        gy.data_ptr(), gld.data_ptr(), gx.data_ptr(), 0 if g1 is None else g1.data_ptr(),
        gpart.data_ptr(), states.data_ptr(), rows, n, n_blocks, weights.shape[-2], hidden,
        int(inverse), *_wide_args(plan), _stream(x))
    check_launch(rc, "coupling_chain_bwd_wide")
    LAUNCHES["coupling_chain_bwd_wide"] += 1
    return gx, g1, gpart.view(plan["grid"], n_blocks, 4, wide_part_floats(hidden))


def _launch_backward_wide(x, p, mode: int, weights, biases, gy, gld, inverse: bool,
                          with_g1: bool):
    """The wide backward: (gx, each row's g1 (B·N, 4K·H) or None, the packed
    weight gradient of a chain without context (K, 4, 3, max_in, H), the
    bias gradient), the partials summed here."""
    gx, g1, parts = wide_backward_parts(x, p, mode, weights, biases, gy, gld, inverse, with_g1)
    return (gx, g1) + wide_grads(parts.sum(0), weights.shape[-1], weights.shape[-2])


def _launch_ctx_grad_rows(lib, g1, ctx, n_blocks: int, hidden: int):
    """(the parts, the plan) of K5's g1: the context-weight gradient's first
    kernel of ``lib``."""
    ctx, ctx_ptr, ctx_sb, ctx_sn = _ctx_arg(ctx)
    mode, _ = context_layout(ctx)
    (g1,) = kernel_args(g1)
    if g1.data_ptr() % 16:        # the kernel reads g1 16 bytes at a time
        g1 = g1.clone()
    rows, ps = g1.shape
    plan = ctx_weight_grad_plan(rows, ctx.shape[1], mode, ctx.shape[-1], ps)
    parts = torch.empty(plan["part_floats"], device=g1.device, dtype=torch.float32)
    rc = lib.nfdpf_coupling_ctx_grad_rows(
        g1.data_ptr(), rows, ctx.shape[1], mode, ctx_ptr, ctx_sb, ctx_sn, ctx.shape[-1],
        n_blocks, hidden, plan["rows_per_block"], plan["c_tile1"], int(plan["segments"]),
        parts.data_ptr(), _stream(g1))
    check_launch(rc, "coupling_ctx_grad_rows")
    LAUNCHES["coupling_ctx_grad_rows"] += 1
    return parts, plan


def _launch_ctx_weight_grad(lib, g1, ctx, gw):
    """Write layer 0's context rows of the packed weight gradient ``gw``
    (K, 4, 3, max_in, H) from K5's g1: the two kernels of the
    context-weight gradient of ``lib``."""
    n_blocks, max_in, hidden = gw.shape[0], gw.shape[-2], gw.shape[-1]
    parts, plan = _launch_ctx_grad_rows(lib, g1, ctx, n_blocks, hidden)
    ctx, ctx_ptr, ctx_sb, _ = _ctx_arg(ctx)
    rc = lib.nfdpf_coupling_ctx_weight_grad(
        parts.data_ptr(), plan["parts"], plan["pieces"], ctx_ptr, ctx_sb, ctx.shape[-1],
        n_blocks, max_in, hidden, int(plan["segments"]), gw.data_ptr(), _stream(gw))
    check_launch(rc, "coupling_ctx_weight_grad")
    LAUNCHES["coupling_ctx_weight_grad"] += 1


def ctx_grad_groups(ps: int) -> list:
    """The column groups (start, width) in which the context-weight
    gradient's kernels take rows of g1 ``ps`` wide: at most
    ``CTX_GRAD_COLUMNS`` each."""
    return [(a, min(CTX_GRAD_COLUMNS, ps - a)) for a in range(0, ps, CTX_GRAD_COLUMNS)]


def _ctx_weight_grad_into(g1, ctx, gw):
    """Layer 0's context rows of the packed weight gradient ``gw`` from g1 on
    the library that runs the chain (``_chain_library``).  Rows of g1 wider
    than ``CTX_GRAD_COLUMNS`` (only the wide pair's chains have them) go
    through the kernels in column groups (``ctx_grad_groups``), each as a
    chain of one block a quarter of the group wide, into a gradient of its
    own, whose context rows are then laid into ``gw``'s."""
    n_blocks, hidden, ps = gw.shape[0], gw.shape[-1], g1.shape[1]
    lib = _chain_library(n_blocks, hidden)
    if ps <= CTX_GRAD_COLUMNS:
        _launch_ctx_weight_grad(lib, g1, ctx, gw)
        return
    c, cols = ctx.shape[-1], []
    for a, width in ctx_grad_groups(ps):
        part = torch.empty((1, 4, 3, 1 + c, width // 4), device=gw.device, dtype=torch.float32)
        _launch_ctx_weight_grad(lib, g1[:, a:a + width].contiguous(), ctx, part)
        cols.append(part[0, :, 0, 1:].permute(1, 0, 2).reshape(c, width))
    rows = torch.cat(cols, 1).reshape(c, n_blocks, 4, hidden)
    gw[:, :, 0, 1:1 + c] = rows.permute(1, 2, 0, 3)


def _launch_ctx_input_grad(lib, g1, weights, ctx_dim: int):
    """The context's gradient (B·N, C) from K5's g1: the
    context-input-gradient kernel of ``lib``."""
    g1, weights = kernel_args(g1, weights)
    if g1.data_ptr() % 16:        # the kernel stages g1 16 bytes at a time
        g1 = g1.clone()
    if g1.dim() != 2 or g1.shape[1] != 4 * weights.shape[0] * weights.shape[-1]:
        raise ValueError(f"g1{tuple(g1.shape)} does not match the chain's weights"
                         f"{tuple(weights.shape)}")
    plan = ctx_input_grad_plan(g1.shape[0], ctx_dim, g1.shape[1])
    gctx = torch.empty((g1.shape[0], ctx_dim), device=g1.device, dtype=torch.float32)
    rc = lib.nfdpf_coupling_ctx_input_grad(
        g1.data_ptr(), g1.shape[0], ctx_dim, weights.shape[0], weights.shape[-2],
        weights.shape[-1], weights.data_ptr(), plan["tile_rows"], plan["tile_cols"],
        plan["rows_a_thread"], gctx.data_ptr(), _stream(g1))
    check_launch(rc, "coupling_ctx_input_grad")
    LAUNCHES["coupling_ctx_input_grad"] += 1
    return gctx


def ctx_share(ctx: Optional[torch.Tensor], weights: torch.Tensor,
              biases: torch.Tensor) -> torch.Tensor:
    """P (R, 4K·H), layer 0's bias and context share per distinct context
    row: the context-share kernel on CUDA tensors, its plain version on the
    CPU."""
    tensors = [t for t in (ctx, weights, biases) if t is not None]
    if on_cpu(*tensors):
        return ctx_share_plain(ctx, weights, biases)
    lib = _chain_library(weights.shape[0], weights.shape[-1])
    return _launch_ctx_share(lib, ctx, weights, biases)[0]


def ctx_weight_grad(g1: torch.Tensor, ctx: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Layer 0's context rows of the weight gradient (K, 4, C, H) from the
    rows' g1: the context-weight-gradient kernels on CUDA tensors, their
    plain version on the CPU."""
    if on_cpu(g1, ctx, weights):
        return ctx_weight_grad_plain(g1, ctx, weights)
    # the kernels write every entry returned (layer 0's context rows)
    gw = torch.empty(weights.shape, device=weights.device, dtype=torch.float32)
    _ctx_weight_grad_into(g1, ctx, gw)
    return gw[:, :, 0, 1:1 + ctx.shape[-1]]


def ctx_grad_rows(g1: torch.Tensor, ctx: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The context-weight gradient's parts (see ``ctx_grad_rows_plain``): its
    first kernel on CUDA tensors (rows of g1 at most ``CTX_GRAD_COLUMNS``
    wide), the plain version on the CPU."""
    if on_cpu(g1, ctx, weights):
        return ctx_grad_rows_plain(g1, ctx, weights)
    n_blocks, hidden = weights.shape[0], weights.shape[-1]
    parts, plan = _launch_ctx_grad_rows(_chain_library(n_blocks, hidden), g1, ctx, n_blocks,
                                        hidden)
    ps = g1.shape[1]
    return parts.reshape((plan["parts"], ps) if plan["segments"]
                         else (plan["parts"], ctx.shape[-1], ps))


def ctx_input_grad(g1: torch.Tensor, weights: torch.Tensor, ctx_dim: int) -> torch.Tensor:
    """The context's gradient (B·N, C) from the rows' g1: the
    context-input-gradient kernel on CUDA tensors, its plain version on the
    CPU."""
    if on_cpu(g1, weights):
        return ctx_input_grad_plain(g1, weights, ctx_dim)
    lib = _chain_library(weights.shape[0], weights.shape[-1])
    return _launch_ctx_input_grad(lib, g1, weights, ctx_dim)


class FusedCouplingChain(torch.autograd.Function):
    """(y, log_det) of a packed chain on CUDA tensors: the context-share
    kernel and the forward kernel; in the backward the backward kernel and,
    with a context, the context-weight-gradient kernels and (only when the
    context asks for one) the context-input-gradient kernel.  The narrow
    pair where it takes the chain (``narrow_pair_takes``), else the wide
    pair, with the wide library's context kernels."""

    @staticmethod
    def forward(fn, x, ctx, weights, biases, inverse):
        _check_chain(x, ctx, weights, biases)
        n_blocks, hidden = weights.shape[0], weights.shape[-1]
        fn.wide = not narrow_pair_takes(n_blocks, hidden)
        p, mode = _launch_ctx_share(_chain_library(n_blocks, hidden), ctx, weights, biases)
        fn.save_for_backward(x, ctx, weights, biases, p)
        fn.inverse, fn.mode = inverse, mode
        launch = _launch_forward_wide if fn.wide else _launch_forward
        return launch(x, p, mode, weights, biases, inverse)

    @staticmethod
    def backward(fn, gy, gld):
        x, ctx, weights, biases, p = fn.saved_tensors
        ctx_dim, hidden = 0 if ctx is None else ctx.shape[-1], weights.shape[-1]
        if fn.wide:
            gx, g1, gw, gb = _launch_backward_wide(x, p, fn.mode, weights, biases, gy, gld,
                                                   fn.inverse, ctx_dim > 0)
        else:
            gx, g1, gw_plain, gb = _launch_backward(x, p, fn.mode, weights, biases, gy, gld,
                                                    fn.inverse, ctx_dim > 0)
            # the packed weight gradient: the rows of a chain without context,
            # then layer 0's context rows (max_in >= hidden rows a layer)
            gw = torch.zeros(weights.shape, device=weights.device, dtype=torch.float32)
            gw[:, :, :, :hidden] = gw_plain
        gctx = None
        if ctx_dim:
            _ctx_weight_grad_into(g1, ctx, gw)
            if fn.needs_input_grad[1]:
                lib = _chain_library(weights.shape[0], hidden)
                gctx = _launch_ctx_input_grad(lib, g1, weights, ctx_dim).reshape(ctx.shape)
        return gx, gctx, gw, gb, None


def fused_coupling_chain(x: torch.Tensor, ctx: Optional[torch.Tensor],
                         weights: torch.Tensor, biases: torch.Tensor,
                         inverse: bool = False):
    """Apply a packed RealNVP chain to (B, N, 2) rows.

    Returns (y, log_det) equal to ``FlowChain.forward`` (its log_det; the
    prior term is separate) or ``FlowChain.inverse``.  ctx is (B, N, C) or
    None.  Differentiable in x, ctx, weights and biases.  On CUDA a chain
    the narrow pair takes 9-15 wide is padded to 16 (``pad_hidden``) for
    it; every other chain runs on the wide pair as it is.
    """
    tensors = [t for t in (x, ctx, weights, biases) if t is not None]
    if on_cpu(*tensors):
        _check_chain(x, ctx, weights, biases)
        return chain_apply_packed_plain(x, ctx, weights, biases, inverse)
    n_blocks, hidden = weights.shape[0], weights.shape[-1]
    if narrow_pair_takes(n_blocks, hidden):
        weights, biases = pad_hidden(weights, biases, kernel_hidden(hidden))
    return FusedCouplingChain.apply(x, ctx, weights, biases, bool(inverse))
