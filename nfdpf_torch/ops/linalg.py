"""Batched small-matrix linear algebra: log|det W| and W⁻¹ over the last two
axes, for the conditional GLOW's per-sample 1×1 convolution.

Counterpart of ``nfdpf_tpu/ops/linalg.py``, with its algorithm: Gaussian
elimination with partial pivoting unrolled over the (small, static) matrix
size n, each step a batched elementwise or gather op over (B, n, n); the
inverse is Gauss-Jordan on [W | I] followed by one Newton step
Y ← Y(2I − WY).  Pivot ties go to the first row, as ``torch.argmax`` and
``jnp.argmax`` both take the first maximum.

The gradients are analytic (``torch.autograd.Function``):
d log|det W| / dW = W⁻ᵀ, and the VJP of the inverse is −Yᵀ ḡ Yᵀ; the
elimination itself is never differentiated through.
"""

from __future__ import annotations

import torch


def _pivot_swap(A: torch.Tensor, k: int):
    """Swap row k with the row of largest |A[:, k]| among rows ≥ k, batched.
    ``A`` may be augmented, (B, n, m ≥ n); rows are counted on axis −2.
    Returns (A, pivot)."""
    n, m = A.shape[-2], A.shape[-1]
    rows = torch.arange(n, device=A.device)
    col = A[..., :, k].abs().masked_fill(rows < k, float("-inf"))   # rows ≥ k only
    p = torch.argmax(col, dim=-1)                                   # (B,)
    row_k = A[..., k, :]
    row_p = torch.gather(A, -2, p[..., None, None].expand(p.shape + (1, m)))[..., 0, :]
    # the old row k where row p was, then the pivot row in row k
    is_p = rows[:, None] == p[..., None, None]                      # (B, n, 1)
    A = torch.where(is_p, row_k[..., None, :], A)
    A = torch.where(rows[:, None] == k, row_p[..., None, :], A)
    return A, A[..., k, k]


def _logabsdet_impl(W: torch.Tensor) -> torch.Tensor:
    n = W.shape[-1]
    A = W
    logdet = torch.zeros(W.shape[:-2], dtype=W.dtype, device=W.device)
    rows = torch.arange(n, device=W.device)
    for k in range(n):
        A, pivot = _pivot_swap(A, k)
        logdet = logdet + torch.log(torch.abs(pivot))
        factors = A[..., :, k] / pivot[..., None]
        factors = torch.where(rows > k, factors, torch.zeros_like(factors))
        A = A - factors[..., :, None] * A[..., k:k + 1, :]
    return logdet


def _inv_impl(W: torch.Tensor) -> torch.Tensor:
    """Gauss-Jordan with partial pivoting on [W | I], unrolled over n, then
    one Newton step."""
    n = W.shape[-1]
    eye = torch.eye(n, dtype=W.dtype, device=W.device).expand(W.shape)
    A = torch.cat([W, eye], dim=-1)                                 # (B, n, 2n)
    rows = torch.arange(n, device=W.device)
    for k in range(n):
        A, pivot = _pivot_swap(A, k)
        row_k = A[..., k, :] / pivot[..., None]                     # normalised pivot row
        A = torch.where(rows[:, None] == k, row_k[..., None, :], A)
        factors = A[..., :, k]
        factors = torch.where(rows != k, factors, torch.zeros_like(factors))
        A = A - factors[..., :, None] * row_k[..., None, :]
    Y = A[..., :, n:]
    return torch.matmul(Y, 2.0 * eye - torch.matmul(W, Y))


class _LogAbsDet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, W):
        ctx.save_for_backward(W)
        return _logabsdet_impl(W)

    @staticmethod
    def backward(ctx, g):
        (W,) = ctx.saved_tensors
        return g[..., None, None] * _inv_impl(W).transpose(-1, -2)


class _Inv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, W):
        Y = _inv_impl(W)
        ctx.save_for_backward(Y)
        return Y

    @staticmethod
    def backward(ctx, g):
        (Y,) = ctx.saved_tensors
        YT = Y.transpose(-1, -2)
        return -torch.matmul(torch.matmul(YT, g), YT)


def logabsdet(W: torch.Tensor) -> torch.Tensor:
    """log|det W| over the last two axes (``torch.linalg.slogdet(W)[1]``)."""
    return _LogAbsDet.apply(W)


def inv(W: torch.Tensor) -> torch.Tensor:
    """Batched inverse over the last two axes (``torch.linalg.inv``)."""
    return _Inv.apply(W)
