"""RealNVP flows: the conditioner MLP, the affine coupling block and the
flow composer with its diagonal-Gaussian prior.

Counterparts of ``nfdpf_tpu/ops/flows.py:38-119`` (``FCNN``,
``AffineCoupling``) and ``:447-509`` (``FlowChain``, ``realnvp_chain``).
Every flow works on ``(..., d)`` with any leading axes; the conditional and
the unconditional coupling are one module (``ctx=None``).  torch's ``Linear``
fixes its input width at construction, so the context width is a
constructor argument here (flax infers it at ``init``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn


class FCNN(nn.Module):
    """3-layer tanh MLP conditioner.  With ``init_std`` the weights are drawn
    from N(0, init_std²) and the biases are zero (``flax_init_`` reads the
    layers' ``init_std``); without it they get flax's default initialiser."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 8,
                 init_std: Optional[float] = None):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.fc3 = nn.Linear(hidden_dim, out_dim)
        for layer in (self.fc1, self.fc2, self.fc3):
            layer.init_std = init_std

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc3(torch.tanh(self.fc2(torch.tanh(self.fc1(x)))))


class AffineCoupling(nn.Module):
    """RealNVP block: two alternating affine couplings over a half split.
    ``ctx`` (when the block was built with ``ctx_dim > 0``) is concatenated to
    the input of every conditioner.

    forward:  upper' = t1(lower⊕ctx) + upper·exp(s1(lower⊕ctx));
              lower' = t2(upper'⊕ctx) + lower·exp(s2(upper'⊕ctx));
    log_det = Σ s1 + Σ s2.  ``inverse`` undoes it.
    """

    def __init__(self, dim: int, hidden_dim: int = 8,
                 init_std: Optional[float] = 0.01, ctx_dim: int = 0):
        super().__init__()
        self.dim = dim
        half = dim // 2
        # t1/s1 read the lower half (half wide), t2/s2 the upper (dim − half)
        self.t1 = FCNN(half + ctx_dim, dim - half, hidden_dim, init_std)
        self.s1 = FCNN(half + ctx_dim, dim - half, hidden_dim, init_std)
        self.t2 = FCNN(dim - half + ctx_dim, half, hidden_dim, init_std)
        self.s2 = FCNN(dim - half + ctx_dim, half, hidden_dim, init_std)

    def _split(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        half = self.dim // 2
        return x[..., :half], x[..., half:]

    @staticmethod
    def _cat(half: torch.Tensor, ctx: Optional[torch.Tensor]) -> torch.Tensor:
        return half if ctx is None else torch.cat([half, ctx], dim=-1)

    def forward(self, x: torch.Tensor, ctx: Optional[torch.Tensor] = None):
        lower, upper = self._split(x)
        a = self._cat(lower, ctx)
        t1, s1 = self.t1(a), self.s1(a)
        upper = t1 + upper * torch.exp(s1)
        b = self._cat(upper, ctx)
        t2, s2 = self.t2(b), self.s2(b)
        lower = t2 + lower * torch.exp(s2)
        z = torch.cat([lower, upper], dim=-1)
        return z, torch.sum(s1, dim=-1) + torch.sum(s2, dim=-1)

    def inverse(self, z: torch.Tensor, ctx: Optional[torch.Tensor] = None):
        lower, upper = self._split(z)
        b = self._cat(upper, ctx)
        t2, s2 = self.t2(b), self.s2(b)
        lower = (lower - t2) * torch.exp(-s2)
        a = self._cat(lower, ctx)
        t1, s1 = self.t1(a), self.s1(a)
        upper = (upper - t1) * torch.exp(-s1)
        x = torch.cat([lower, upper], dim=-1)
        return x, -torch.sum(s1, dim=-1) - torch.sum(s2, dim=-1)


class FlowChain(nn.Module):
    """Flow composer with a diagonal-Gaussian prior.  ``forward`` maps data →
    latent and returns ``(z, prior_logprob(z), log_det)``; ``inverse`` applies
    the flows reversed and returns ``(x, log_det)``."""

    def __init__(self, flows: Sequence[nn.Module], prior_mean: float = 0.0,
                 prior_std: float = 1.0):
        super().__init__()
        self.flows = nn.ModuleList(flows)
        self.prior_mean = prior_mean
        self.prior_std = prior_std

    def _prior_logprob(self, z: torch.Tensor) -> torch.Tensor:
        d = z.shape[-1]
        var = self.prior_std**2
        return (-0.5 * d * math.log(2 * math.pi) - 0.5 * d * math.log(var)
                - 0.5 * torch.sum((z - self.prior_mean) ** 2, dim=-1) / var)

    def forward(self, x: torch.Tensor, ctx: Optional[torch.Tensor] = None):
        log_det = torch.zeros(x.shape[:-1], device=x.device, dtype=x.dtype)
        for flow in self.flows:
            x, ld = flow.forward(x, ctx)
            log_det = log_det + ld
        return x, self._prior_logprob(x), log_det

    def inverse(self, z: torch.Tensor, ctx: Optional[torch.Tensor] = None):
        log_det = torch.zeros(z.shape[:-1], device=z.device, dtype=z.dtype)
        for flow in reversed(self.flows):
            z, ld = flow.inverse(z, ctx)
            log_det = log_det + ld
        return z, log_det

    def sample_with_dim(self, generator: Optional[torch.Generator], sample_shape,
                        dim: int, ctx: Optional[torch.Tensor] = None,
                        device=None) -> torch.Tensor:
        """Draw z from the prior with ``generator`` and push it through the
        inverse."""
        normal = torch.randn(tuple(sample_shape) + (dim,), generator=generator,
                             device=device)
        x, _ = self.inverse(self.prior_mean + self.prior_std * normal, ctx)
        return x


def realnvp_chain(n_blocks: int, dim: int, hidden_dim: int = 8,
                  init_std: float = 0.01, prior_mean: float = 0.0,
                  prior_std: float = 1.0, ctx_dim: int = 0) -> FlowChain:
    """``n_blocks`` RealNVP blocks, near-identity at init (std 0.01), with an
    isotropic Gaussian prior."""
    return FlowChain(
        [AffineCoupling(dim, hidden_dim, init_std, ctx_dim) for _ in range(n_blocks)],
        prior_mean, prior_std)
