"""A whole RealNVP coupling chain in one hand-written CUDA kernel, with a
fused backward.

Counterpart of ``nfdpf_tpu/ops/pallas/coupling_pallas.py``.  Two kernels
(``csrc/coupling.cu``) apply K coupling blocks × 4 conditioner MLPs to every
(B, N, 2) particle row with the chain's parameters resident in shared
memory:

* ``chain_fwd_kernel`` (replaces ``_chain_kernel``, ``coupling_pallas.py:100``):
  outputs and the summed log-det, forward or inverse.  A row takes eight
  lanes at hidden width 8, four per net of a coupling half, 32 rows a block;
  the context's share of layer 0 is computed once per distinct context row;
* ``chain_bwd_kernel`` (replaces ``_chain_bwd_kernel``, ``:262``): recomputes
  the forward from the inputs and emits the gradients of x, ctx and one
  weight/bias partial per thread block, summed here.  A block of 1-8 warps
  (one row per thread) loops over tiles of rows; the forward sweep keeps each
  row's activations in shared memory, the reverse sweep adds the gradients
  there, and each weight and bias gradient is then a sum over the tile's
  rows; the context's share of layer 0 is computed once per distinct
  context row.

``fused_coupling_chain`` takes the plain PyTorch version
(``chain_apply_packed_plain``, differentiated by ordinary autograd) for
tensors on the CPU and launches the kernels for CUDA tensors; anything else
raises.  ``LAUNCHES`` counts the kernel launches.

The kernels take the filter's state dimension (2), float32, a hidden width
up to 16 (fixed at compile time: one library per width, built at first use;
8 is the filter's default; 3, 4, 6 and 8, which take each of the forward's
lane mappings, and 16 are the widths held against the plain version on the
card; a chain 9-15 wide runs at 16, zero-padded by ``pad_hidden``, which
changes no output and whose padding's gradients are sliced away), at
most 8 blocks, and parameters that fit the card's shared memory (227 KB;
``fwd_smem_bytes`` and ``bwd_smem_bytes`` mirror the kernels' layouts, the
backward's twice the parameters' size plus its tiles).  ``chain_refusal``
says what a chain breaks of these, for the wrapper at launch and for the
filter when it is built.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.nn import functional as F

from nfdpf_torch.ops.cuda._common import check_launch, kernel_args, on_cpu
from nfdpf_torch.ops.flows import FlowChain

# kernel launches since the last reset: the forward kernel by direction, and
# the backward kernel
LAUNCHES = {"coupling_chain": 0, "coupling_chain_inverse": 0, "coupling_chain_bwd": 0}

NETS = ("t1", "s1", "t2", "s2")
MAX_HIDDEN = 16                   # the H-wide activations are register arrays
PADDED_ABOVE = 8                  # wider chains run at MAX_HIDDEN, zero-padded
MAX_BLOCKS = 8                    # chain blocks the kernels take
MAX_SMEM_BYTES = 232448           # dynamic shared memory a Hopper block can opt in to
FWD_ROWS_PER_BLOCK = 32           # forward rows per block
BWD_MAX_GRID = 132                # backward blocks: at most one per SM
BWD_ROWS_PER_BLOCK = 128          # backward rows per block (the entry point may take fewer)
BWD_ROWS_PER_BLOCK_WIDE = 32      # at hidden 16 shared memory holds one or two warps' tiles
BWD_MIN_THREADS = 32              # the smallest backward block (one warp)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "nfdpf_coupling_chain_fwd": [_P, _P, _L, _L, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _P],
    "nfdpf_coupling_chain_bwd": [_P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_defines(hidden: int) -> tuple:
    """The compile-time defines of the library for one hidden width."""
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


def chain_apply_packed_plain(x: torch.Tensor, ctx: Optional[torch.Tensor],
                             weights: torch.Tensor, biases: torch.Tensor,
                             inverse: bool = False):
    """Plain version of the fused kernels on packed parameters: returns
    (y (..., 2), log_det (...)).  Ordinary autograd differentiates it in x,
    ctx, weights and biases; that is the backward kernel's reference."""
    n_blocks, hidden = weights.shape[0], weights.shape[-1]
    in_dim = 1 + (0 if ctx is None else ctx.shape[-1])
    lower, upper = x[..., 0:1], x[..., 1:2]
    ld = torch.zeros(x.shape[:-1] + (1,), device=x.device, dtype=x.dtype)

    def cat(half):
        return half if ctx is None else torch.cat([half, ctx], dim=-1)

    def mlp(k, ni, h_in):
        h = torch.tanh(h_in @ weights[k, ni, 0, :in_dim, :] + biases[k, ni, 0])
        h = torch.tanh(h @ weights[k, ni, 1, :hidden, :] + biases[k, ni, 1])
        return h @ weights[k, ni, 2, :hidden, :1] + biases[k, ni, 2, :1]

    order = range(n_blocks - 1, -1, -1) if inverse else range(n_blocks)
    for k in order:
        if not inverse:
            t1, s1 = mlp(k, 0, cat(lower)), mlp(k, 1, cat(lower))
            upper = t1 + upper * torch.exp(s1)
            t2, s2 = mlp(k, 2, cat(upper)), mlp(k, 3, cat(upper))
            lower = t2 + lower * torch.exp(s2)
            ld = ld + s1 + s2
        else:
            t2, s2 = mlp(k, 2, cat(upper)), mlp(k, 3, cat(upper))
            lower = (lower - t2) * torch.exp(-s2)
            t1, s1 = mlp(k, 0, cat(lower)), mlp(k, 1, cat(lower))
            upper = (upper - t1) * torch.exp(-s1)
            ld = ld - s1 - s2
    return torch.cat([lower, upper], dim=-1), ld[..., 0]


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


def fwd_smem_bytes(n_blocks: int, ctx_dim: int, hidden: int, segments: int) -> int:
    """Shared memory of the forward kernel (``FwdLayout`` and
    ``fwd_ctx_floats`` in ``csrc/coupling.cu``): per net its biases
    (3·hidden), layer 0's rows 0..ctx_dim, layer 1 and layer 2's column 0;
    then per distinct context row of a block (at most ``segments``) its
    context and its layer-0 shares (4·K·hidden)."""
    nets = 4 * n_blocks
    params = nets * (3 * hidden + (1 + ctx_dim) * hidden + hidden * hidden + hidden)
    return 4 * (params + (segments * ctx_dim + 3) // 4 * 4 + segments * nets * hidden)


def bwd_smem_bytes(n_blocks: int, ctx_dim: int, max_in: int, hidden: int,
                   threads: int = BWD_MIN_THREADS, segments: int = BWD_MIN_THREADS) -> int:
    """Shared memory of the backward kernel for a block of ``threads`` rows
    (``bwd_smem_floats`` in ``csrc/coupling.cu``): the parameters and their
    gradient accumulators, the factor tile (K·(7 + 16·hidden) fields of
    threads + 4 floats) and, per distinct context row of a tile (at most
    ``segments``), its context, its summed layer-0 gradients (4·K·hidden)
    and its layer-0 shares (4·K·hidden + 1)."""
    params = n_blocks * 12 * (max_in * hidden + hidden)
    nets = 4 * n_blocks
    if not ctx_dim:
        segments = 1
    cs_stride = (segments + 3) // 4 * 4 + 4
    floats = (2 * params + n_blocks * (7 + 16 * hidden) * (threads + 4)
              + (ctx_dim * cs_stride + segments * nets * hidden if ctx_dim else 0)
              + segments * (nets * hidden + 1))
    return 4 * floats


def chain_refusal(n_blocks: int, hidden: int, ctx_dim: int, n: int, broadcast: bool,
                  backward: bool) -> Optional[str]:
    """Why the forward kernel (K4) or, with ``backward``, the backward kernel
    (K5) cannot take a chain of ``n_blocks`` blocks at hidden width
    ``hidden`` with a ``ctx_dim``-wide context over ``n`` particles per batch
    element (``broadcast``: one context row per batch element, particle
    stride 0, as the filter passes it); None when it can.  The wrapper raises
    it at launch, the filter when it is built; a chain 9-15 wide is counted
    at the width it runs at, 16."""
    if hidden > MAX_HIDDEN or n_blocks > MAX_BLOCKS:
        return (f"the coupling kernels take hidden <= {MAX_HIDDEN} and at most "
                f"{MAX_BLOCKS} blocks, got hidden={hidden}, blocks={n_blocks}")
    hidden = kernel_hidden(hidden)
    max_in = max(1 + ctx_dim, hidden)
    # the distinct context rows of a block's (the backward's smallest block's)
    # rows: a run per batch element when the context is broadcast over the
    # particles, else a row
    rows = BWD_MIN_THREADS if backward else FWD_ROWS_PER_BLOCK
    segments = (1 if not ctx_dim else
                min(rows, (rows - 1) // n + 2) if broadcast else rows)
    if backward:
        smem = bwd_smem_bytes(n_blocks, ctx_dim, max_in, hidden, rows, segments)
    else:
        smem = fwd_smem_bytes(n_blocks, ctx_dim, hidden, segments)
    if smem > MAX_SMEM_BYTES:
        return (f"the chain needs {smem} bytes of shared memory in the "
                f"{'backward' if backward else 'forward'} kernel; a block has {MAX_SMEM_BYTES}")
    return None


def _check_chain(x, ctx, weights, biases, backward: bool):
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
    why = chain_refusal(n_blocks, hidden, ctx_dim, n,
                        ctx is not None and ctx.stride(1) == 0, backward)
    if why is not None:
        raise ValueError(why)


def _launch_forward(x, ctx, weights, biases, inverse: bool):
    ctx, ctx_ptr, ctx_sb, ctx_sn = _ctx_arg(ctx)
    _check_chain(x, ctx, weights, biases, backward=False)
    b, n, _ = x.shape
    x, weights, biases = kernel_args(x, weights, biases)
    y = torch.empty((b, n, 2), device=x.device, dtype=torch.float32)
    ld = torch.empty((b, n), device=x.device, dtype=torch.float32)
    rc = _library(weights.shape[-1]).nfdpf_coupling_chain_fwd(
        x.data_ptr(), ctx_ptr, ctx_sb, ctx_sn, weights.data_ptr(), biases.data_ptr(),
        y.data_ptr(), ld.data_ptr(), b * n, n, weights.shape[0],
        0 if ctx is None else ctx.shape[-1], weights.shape[-2], weights.shape[-1],
        int(inverse), torch.cuda.current_stream(x.device).cuda_stream)
    counter = "coupling_chain_inverse" if inverse else "coupling_chain"
    check_launch(rc, counter)
    LAUNCHES[counter] += 1
    return y, ld


def _launch_backward(x, ctx, weights, biases, gy, gld, inverse: bool, want_gctx: bool):
    ctx, ctx_ptr, ctx_sb, ctx_sn = _ctx_arg(ctx)
    _check_chain(x, ctx, weights, biases, backward=True)
    b, n, _ = x.shape
    x, weights, biases, gy, gld = kernel_args(x, weights, biases, gy, gld)
    dev = x.device
    per_block = BWD_ROWS_PER_BLOCK if weights.shape[-1] <= PADDED_ABOVE \
        else BWD_ROWS_PER_BLOCK_WIDE
    grid = min(-(-b * n // per_block), BWD_MAX_GRID)
    gx = torch.empty((b, n, 2), device=dev, dtype=torch.float32)
    # the kernel adds each MLP's share into its row of gctx
    gctx = torch.zeros(ctx.shape, device=dev, dtype=torch.float32) if want_gctx else None
    gw_part = torch.empty((grid,) + weights.shape, device=dev, dtype=torch.float32)
    gb_part = torch.empty((grid,) + biases.shape, device=dev, dtype=torch.float32)
    rc = _library(weights.shape[-1]).nfdpf_coupling_chain_bwd(
        x.data_ptr(), ctx_ptr, ctx_sb, ctx_sn, weights.data_ptr(), biases.data_ptr(),
        gy.data_ptr(), gld.data_ptr(), gx.data_ptr(),
        0 if gctx is None else gctx.data_ptr(), gw_part.data_ptr(), gb_part.data_ptr(),
        b * n, n, weights.shape[0], 0 if ctx is None else ctx.shape[-1],
        weights.shape[-2], weights.shape[-1], int(inverse), grid,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "coupling_chain_bwd")
    LAUNCHES["coupling_chain_bwd"] += 1
    return gx, gctx, torch.sum(gw_part, dim=0), torch.sum(gb_part, dim=0)


class FusedCouplingChain(torch.autograd.Function):
    """(y, log_det) of a packed chain on CUDA tensors: the forward kernel,
    and the backward kernel for the gradients of x, ctx (only when it asks
    for one), weights and biases."""

    @staticmethod
    def forward(fn, x, ctx, weights, biases, inverse):
        fn.save_for_backward(x, ctx, weights, biases)
        fn.inverse = inverse
        return _launch_forward(x, ctx, weights, biases, inverse)

    @staticmethod
    def backward(fn, gy, gld):
        x, ctx, weights, biases = fn.saved_tensors
        want_gctx = ctx is not None and fn.needs_input_grad[1]
        gx, gctx, gw, gb = _launch_backward(x, ctx, weights, biases, gy, gld,
                                            fn.inverse, want_gctx)
        return gx, gctx, gw, gb, None


def fused_coupling_chain(x: torch.Tensor, ctx: Optional[torch.Tensor],
                         weights: torch.Tensor, biases: torch.Tensor,
                         inverse: bool = False):
    """Apply a packed RealNVP chain to (B, N, 2) rows.

    Returns (y, log_det) equal to ``FlowChain.forward`` (its log_det; the
    prior term is separate) or ``FlowChain.inverse``.  ctx is (B, N, C) or
    None.  Differentiable in x, ctx, weights and biases.  On CUDA a chain
    9-15 wide is padded to 16 (``pad_hidden``) for the kernels.
    """
    tensors = [t for t in (x, ctx, weights, biases) if t is not None]
    if on_cpu(*tensors):
        _check_chain(x, ctx, weights, biases, backward=False)
        return chain_apply_packed_plain(x, ctx, weights, biases, inverse)
    weights, biases = pad_hidden(weights, biases, kernel_hidden(weights.shape[-1]))
    return FusedCouplingChain.apply(x, ctx, weights, biases, bool(inverse))
