"""Geometry helpers of the ε-annealed Sinkhorn resampler.

Counterparts of ``nfdpf_tpu/ops/sinkhorn.py:37-82``.  ``softmin`` over a
materialised cost is the plain version of the streaming softmin kernel
(``nfdpf_torch/ops/cuda/sinkhorn_cuda.py``).  The dense loop
(``sinkhorn_loop``/``ot_resample``) is not ported yet.
"""

from __future__ import annotations

import torch


def squared_distances(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise ‖x_i − y_j‖² over the particle axis: (B,N,d),(B,M,d) → (B,N,M)."""
    x2 = torch.sum(x**2, dim=-1)
    y2 = torch.sum(y**2, dim=-1)
    xy = torch.einsum("bnd,bmd->bnm", x, y)
    return torch.clamp_min(x2[..., :, None] + y2[..., None, :] - 2.0 * xy, 0.0)


def cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """½·squared distance."""
    return squared_distances(x, y) / 2.0


def diameter(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Max over dims of the per-batch BIASED std, floored at 1 when zero: (B,)."""
    dx = torch.amax(torch.std(x, dim=1, correction=0), dim=-1)
    dy = torch.amax(torch.std(y, dim=1, correction=0), dim=-1)
    res = torch.maximum(dx, dy)
    return torch.where(res == 0.0, torch.ones_like(res), res)


def max_min(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Annealing scale proxy, (B,).

    The original takes ``min_min`` from ``x.max(dim=1).min()`` — a
    max-then-min, not min-then-min — and so does this.
    """
    max_max = torch.maximum(torch.amax(x, dim=(1, 2)), torch.amax(y, dim=(1, 2)))
    min_min = torch.minimum(torch.amin(torch.amax(x, dim=1), dim=-1),
                            torch.amin(y, dim=(1, 2)))
    return max_max - min_min


def softmin(epsilon, cost_matrix: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """−ε·logsumexp(f − C/ε) over the last axis.

    epsilon: (B,) or scalar; cost_matrix: (B, N, M); f: (B, M) → (B, N).
    """
    eps = torch.as_tensor(epsilon, dtype=cost_matrix.dtype,
                          device=cost_matrix.device).expand(cost_matrix.shape[0])
    val = f[:, None, :] - cost_matrix / eps[:, None, None]
    return -eps[:, None] * torch.logsumexp(val, dim=2)
