"""The yardstick's arithmetic: the card's peaks, operations and bytes from
shapes, and the least time a piece of work needs.

``bound_ms``, ``k3_ops_bytes`` (``k3_bound_ms`` there), ``chain_ops`` and
``share_ops`` are copies of the arithmetic in the repository's
``chip_smoke.py``, kept here so that a change to the program cannot move the
yardstick.  Operations are fp32
operations with a multiply-add counted as two and ``exp`` as one.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W power limit
H100_BYTES_PER_S = 3.35e12     # HBM3
H100_FP32_OPS_PER_S = 67e12    # float32 outside the tensor cores
F4 = 4.0                       # bytes of a float32

# the conv encoder and decoder (nfdpf_torch/models/nets.py): 5 layers of
# k4 s2 p1 on 128x128x3 frames, 3 -> 16 -> 32 -> 64 -> 128 -> 256 at 4x4
ENC_CHANNELS = (3, 16, 32, 64, 128, 256)
KERNEL = 4


def bound_ms(nbytes: float, ops: float):
    """(the least ms, "bytes" or "operations"): the larger of the bytes at
    the HBM bandwidth and the operations at the float32 peak."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k3_ops_bytes(b: int, n: int, iters: int):
    """(operations, bytes) of one streaming OT call (``chip_smoke.py``'s
    ``k3_bound_ms``): the
    K1 work (G = 2) of the cold start, each iteration and the final round,
    the column normaliser (G = 1) and K2, with the update's ~9 floats per
    particle and iteration and the inputs read once."""
    pairs = b * n * n
    ops = pairs * ((iters + 2) * (7 + 4 * 2) + (7 + 4) + 14)
    nbytes = 4.0 * (3 * b * n + iters * 9 * b * n + 2 * b * n + 2 * b * n)
    return float(ops), nbytes


def ot_backward_ops_bytes(b: int, n: int):
    """(operations, bytes) of the transport's backward, Tᵀg: K2's 14
    operations per pair, the cotangent read and the gradient written."""
    return 14.0 * b * n * n, F4 * (2 * b * n + 2 * b * n + 3 * b * n)


def chain_ops(rows: int, n_blocks: int, hidden: int) -> float:
    """fp32 operations one pass of K4 needs: per row and MLP the products of
    layers 0 (the half's column), 1 and 2 (multiply and add counted apart),
    the bias adds (layer 0's is P, the context's share) and 2·H tanh (one
    each); per row and block four MLPs, two exp and six more for the affine
    updates.  The context's share of layer 0 is ``share_ops``."""
    h = hidden
    mlp_row = 2 * h + 2 * h * h + 2 * h + 2 * h + 1 + 2 * h
    return float(rows) * n_blocks * (4 * mlp_row + 8)


def share_ops(ctx_rows: int, n_blocks: int, ctx_dim: int, hidden: int) -> float:
    """fp32 operations of the context share: per distinct context row and
    each of the 4K·H entries of P, C multiply-adds and the bias."""
    return float(ctx_rows) * 4 * n_blocks * hidden * (2 * ctx_dim + 1)


def coupling_ops_bytes(rows: int, ctx_rows: int, ctx_dim: int, n_blocks: int, hidden: int,
                       max_in: int, backward: bool):
    """(operations, bytes) of one packed chain call, forward or its
    backward (three times the forward's chain work, plus folding each row's
    layer-0 gradient into its context row and the context-weight product).
    Bytes: the layer's inputs read once and its outputs written once
    (rows of x, y and the log-det; the cotangents and x's gradient in the
    backward; the context rows; the packed parameters, and their gradients
    in the backward)."""
    params = F4 * n_blocks * 4 * 3 * (max_in + 1) * hidden
    ctx = F4 * ctx_rows * ctx_dim
    fwd_ops = chain_ops(rows, n_blocks, hidden) + share_ops(ctx_rows, n_blocks, ctx_dim, hidden)
    if not backward:
        return fwd_ops, F4 * rows * (2 + 2 + 1) + ctx + params
    ops = (3 * chain_ops(rows, n_blocks, hidden) + float(rows) * 4 * n_blocks * hidden
           + share_ops(ctx_rows, n_blocks, ctx_dim, hidden))
    return ops, F4 * rows * (2 + 2 + 1 + 2) + ctx + 2 * params


def conv_ops_per_frame(width: int = 128) -> tuple:
    """(encoder, decoder) forward operations of one frame: each conv
    2·Cin·Cout·k²·Hout², each transposed conv 2·Cin·Cout·k²·Hin²."""
    enc = dec = 0.0
    side = width
    pairs = list(zip(ENC_CHANNELS[:-1], ENC_CHANNELS[1:]))
    for ci, co in pairs:
        side //= 2
        enc += 2.0 * ci * co * KERNEL * KERNEL * side * side
    side = width // 2 ** len(pairs)
    for ci, co in zip(ENC_CHANNELS[::-1][:-1], ENC_CHANNELS[::-1][1:]):
        dec += 2.0 * ci * co * KERNEL * KERNEL * side * side
        side *= 2
    return enc, dec


def first_conv_ops(width: int = 128) -> float:
    """The encoder's first conv, forward, one frame (its input needs no
    gradient, so its backward is the weight gradient alone)."""
    side = width // 2
    return 2.0 * ENC_CHANNELS[0] * ENC_CHANNELS[1] * KERNEL * KERNEL * side * side


def mlp_ops(widths) -> float:
    """Forward operations of one row through dense layers of ``widths``."""
    return sum(2.0 * a * b for a, b in zip(widths[:-1], widths[1:]))


def step_model_ops(cfg, b: int, n: int, t: int) -> float:
    """Model operations of one train step outside the Sinkhorn loop, forward
    and backward (twice the forward's, but the first conv's once): the
    conv encoder and decoder over the B·T frames with their dense layers,
    the particle encoder, the CRNVP measurement's nets and the flows' chains
    (``chain_ops``/``share_ops``, the backward three times the forward) at
    each of the T steps over B·N rows.  Recomputation is left out."""
    frames = b * t
    rows = b * n
    h = cfg.hidden_size
    enc, dec = conv_ops_per_frame(cfg.width)
    dense = mlp_ops((256 * 16, h)) + mlp_ops((h, 256 * 16))
    ops = frames * (3 * (enc + dec + dense) - first_conv_ops(cfg.width))
    per_step = 3 * rows * mlp_ops((cfg.state_dim, 16, 32, h))
    if cfg.measurement == "CRNVP":
        half = h // 2
        net = mlp_ops((half + h, cfg.flow_hidden_dim, cfg.flow_hidden_dim, h - half))
        per_step += 3 * rows * cfg.n_sequence * 4 * net
    stats = 2 * cfg.state_dim
    chains = []
    if cfg.nf_dyn:
        chains.append(stats)                    # the dynamics inverse
    if cfg.nf_cond:
        chains.append(stats + h)                # the proposal inverse
        if cfg.nf_dyn:
            chains.append(stats)                # the dynamics forward on the proposal
    for ctx_dim in chains:
        fwd = (chain_ops(rows, cfg.n_sequence, cfg.flow_hidden_dim)
               + share_ops(b, cfg.n_sequence, ctx_dim, cfg.flow_hidden_dim))
        per_step += 4 * fwd
    return ops + t * per_step


def sinkhorn_ops(b: int, n: int, calls: int, iters: int) -> float:
    """Operations of ``calls`` streaming OT firings that made ``iters``
    iterations in all, each with the transport's backward."""
    pairs = float(b) * n * n
    return pairs * (15.0 * (iters + 2 * calls) + calls * (11 + 14 + 14))
