"""The flow library: the conditioner MLP, the affine coupling block (RealNVP),
MAF, ActNorm, the LU-parameterised invertible linear map, planar and radial
flows, the autoregressive and the coupling neural-spline flows, and the flow
composer with its diagonal-Gaussian prior.

Counterpart of ``nfdpf_tpu/ops/flows.py``, flow for flow, with its forward,
inverse and log-det formulas and its parameter names.  Every flow works on
``(..., d)`` with any leading axes, takes a ``ctx`` (only the coupling block
reads it) and returns ``(output, log_det)``; the conditional and the
unconditional coupling are one module (``ctx=None``).  torch's ``Linear``
fixes its input width at construction, so every width is a constructor
argument here (flax infers it at ``init``).  Parameters that flax draws from
``uniform(scale)`` (U[0, scale)) are drawn so at construction and by
``flax_init_`` (``param_init_uniform``); the flows shift them inside
``forward`` as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from nfdpf_torch.ops.rqs import softplus, unconstrained_rqs


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


def _uniform_param(shape, scale: float) -> nn.Parameter:
    """A parameter drawn from U[0, scale), flax's ``uniform(scale)``."""
    return nn.Parameter(torch.empty(shape).uniform_(0.0, scale))


class MAF(nn.Module):
    """Masked autoregressive flow: dimension i is shifted and scaled by
    (mu, alpha) from ``layers[i-1]`` of the dimensions before it (the first
    by ``initial_param``); the output is flipped."""

    def __init__(self, dim: int, hidden_dim: int = 8):
        super().__init__()
        self.dim = dim
        scale = 2 * math.sqrt(0.5)
        self.initial_param = _uniform_param((2,), scale)
        self.param_init_uniform = {"initial_param": scale}
        self.layers = nn.ModuleList(FCNN(i + 1, 2, hidden_dim) for i in range(dim - 1))

    def _shift_scale(self, i: int, before: Optional[torch.Tensor]):
        if i == 0:
            init = self.initial_param - math.sqrt(0.5)   # U[-√0.5, √0.5)
            return init[0], init[1]
        out = self.layers[i - 1](before)
        return out[..., 0], out[..., 1]

    def forward(self, x: torch.Tensor, ctx=None):
        zs, log_det = [], x.new_zeros(x.shape[:-1])
        for i in range(self.dim):
            mu, alpha = self._shift_scale(i, x[..., :i])
            zs.append((x[..., i] - mu) / torch.exp(alpha))
            log_det = log_det - alpha
        return torch.flip(torch.stack(zs, dim=-1), (-1,)), log_det

    def inverse(self, z: torch.Tensor, ctx=None):
        z = torch.flip(z, (-1,))
        xs, log_det = [], z.new_zeros(z.shape[:-1])
        for i in range(self.dim):
            mu, alpha = self._shift_scale(i, torch.stack(xs, dim=-1) if xs else None)
            xs.append(mu + torch.exp(alpha) * z[..., i])
            log_det = log_det + alpha
        return torch.stack(xs, dim=-1), log_det


class ActNorm(nn.Module):
    """Per-dimension affine ``z = x·e^{log_sigma} + mu`` (both zero at init)."""

    def __init__(self, dim: int):
        super().__init__()
        self.mu = nn.Parameter(torch.zeros(dim))
        self.log_sigma = nn.Parameter(torch.zeros(dim))
        self.param_init_std = {"mu": 0.0, "log_sigma": 0.0}

    def forward(self, x: torch.Tensor, ctx=None):
        z = x * torch.exp(self.log_sigma) + self.mu
        return z, torch.sum(self.log_sigma).expand(x.shape[:-1])

    def inverse(self, z: torch.Tensor, ctx=None):
        x = (z - self.mu) * torch.exp(-self.log_sigma)
        return x, (-torch.sum(self.log_sigma)).expand(z.shape[:-1])


def _lu_qr_init(generator: torch.Generator, dim: int):
    """A fixed permutation and the L, diag(U), strict-upper U factors of a
    random orthogonal matrix (Q of a normal draw from ``generator``), in
    float64 on the CPU and returned as float32."""
    w = torch.randn((dim, dim), generator=generator, dtype=torch.float64)
    q, _ = torch.linalg.qr(w)
    p, l, u = torch.linalg.lu(q)
    return (p.float(), l.float(), torch.diagonal(u).float(), torch.triu(u, 1).float())


class InvertibleLinear(nn.Module):
    """LU-parameterised invertible linear map ("1x1 conv"):
    ``z = x·(P L (U + diag(S)))``, log-det Σ log|S|.  The permutation ``P``
    is a buffer; L's strict lower triangle, U's strict upper triangle and S
    are trained.  The structure is the same whatever the seed (the JAX
    package draws it from a fixed key; here a fixed-seed generator), and
    ``flax_init_`` leaves it alone.  ``inverse`` inverts W at every call."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        p, l, s, u = _lu_qr_init(torch.Generator().manual_seed(0), dim)
        self.register_buffer("P", p)
        self.L = nn.Parameter(l)
        self.S = nn.Parameter(s)
        self.U = nn.Parameter(u)

    def _w(self) -> torch.Tensor:
        eye = torch.eye(self.dim, dtype=self.L.dtype, device=self.L.device)
        l = torch.tril(self.L, -1) + eye
        return self.P @ l @ (torch.triu(self.U, 1) + torch.diag(self.S))

    def _log_det(self, lead) -> torch.Tensor:
        return torch.sum(torch.log(torch.abs(self.S))).expand(lead)

    def forward(self, x: torch.Tensor, ctx=None):
        return x @ self._w(), self._log_det(x.shape[:-1])

    def inverse(self, z: torch.Tensor, ctx=None):
        return z @ torch.linalg.inv(self._w()), -self._log_det(z.shape[:-1])


class Planar(nn.Module):
    """Planar flow ``z = x + û·tanh(wᵀx + b)``, with the tanh invertibility
    correction on u (û).  Forward only."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        scale = 2 * math.sqrt(1.0 / dim)
        self.w = _uniform_param((dim,), scale)
        self.u = _uniform_param((dim,), scale)
        self.b = _uniform_param((1,), scale)
        self.param_init_uniform = {"w": scale, "u": scale, "b": scale}

    def forward(self, x: torch.Tensor, ctx=None):
        bound = math.sqrt(1.0 / self.dim)              # the draws shifted to U[-bound, bound)
        w, u, b = self.w - bound, self.u - bound, self.b - bound
        wu = torch.dot(w, u)
        scal = torch.log1p(torch.exp(wu)) - wu - 1.0
        u_hat = u + scal * w / torch.sum(w**2)
        lin = torch.sum(x * w, dim=-1, keepdim=True) + b
        z = x + u_hat * torch.tanh(lin)
        phi = (1.0 - torch.tanh(lin) ** 2) * w
        log_det = torch.log(torch.abs(1.0 + torch.sum(phi * u_hat, dim=-1)) + 1e-4)
        return z, log_det

    def inverse(self, z, ctx=None):
        raise NotImplementedError("Planar flow has no algebraic inverse.")


class Radial(nn.Module):
    """Radial flow ``z = x + β h(α, r)(x − x0)``, r the per-sample distance
    to x0.  Forward only (no ``inverse``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        scale = 2 * math.sqrt(1.0 / dim)
        self.x0 = _uniform_param((dim,), scale)
        self.log_alpha = _uniform_param((1,), scale)
        self.beta = _uniform_param((1,), scale)
        self.param_init_uniform = {"x0": scale, "log_alpha": scale, "beta": scale}

    def forward(self, x: torch.Tensor, ctx=None):
        bound = math.sqrt(1.0 / self.dim)              # the draws shifted to U[-bound, bound)
        x0 = self.x0 - bound
        log_alpha = self.log_alpha[0] - bound
        beta_raw = self.beta[0] - bound
        n = x.shape[-1]
        r = torch.linalg.vector_norm(x - x0, dim=-1, keepdim=True)
        h = 1.0 / (torch.exp(log_alpha) + r)
        beta = -torch.exp(log_alpha) + torch.log1p(torch.exp(beta_raw))
        z = x + beta * h * (x - x0)
        bh = beta * h[..., 0]
        log_det = (n - 1) * torch.log1p(bh) + torch.log1p(
            bh - beta * r[..., 0] / (torch.exp(log_alpha) + r[..., 0]) ** 2)
        return z, log_det


def _spline_split(out: torch.Tensor, K: int, B: float):
    """(..., 3K−1) conditioner output → widths and heights 2B·softmax, and
    the K−1 inner derivatives softplus."""
    w, h, d = out[..., :K], out[..., K:2 * K], out[..., 2 * K:]
    return (2 * B * torch.softmax(w, dim=-1), 2 * B * torch.softmax(h, dim=-1), softplus(d))


class NSFAutoregressive(nn.Module):
    """Autoregressive neural spline flow: dimension i goes through an RQS
    with identity tails outside ±B whose K bins come from ``layers[i-1]``
    of the dimensions before it (the first from ``init_param``)."""

    def __init__(self, dim: int, K: int = 5, B: float = 3.0, hidden_dim: int = 8):
        super().__init__()
        self.dim, self.K, self.B = dim, K, B
        self.init_param = _uniform_param((3 * K - 1,), 1.0)
        self.param_init_uniform = {"init_param": 1.0}
        self.layers = nn.ModuleList(FCNN(i + 1, 3 * K - 1, hidden_dim) for i in range(dim - 1))

    def _params_for(self, cond: Optional[torch.Tensor], batch_shape):
        if cond is None:
            out = (self.init_param - 0.5).expand(tuple(batch_shape) + (3 * self.K - 1,))
        else:
            out = self.layers[cond.shape[-1] - 1](cond)
        return _spline_split(out, self.K, self.B)

    def forward(self, x: torch.Tensor, ctx=None):
        zs, log_det = [], x.new_zeros(x.shape[:-1])
        for i in range(self.dim):
            w, h, d = self._params_for(x[..., :i] if i else None, x.shape[:-1])
            zi, ld = unconstrained_rqs(x[..., i], w, h, d, inverse=False, tail_bound=self.B)
            zs.append(zi)
            log_det = log_det + ld
        return torch.stack(zs, dim=-1), log_det

    def inverse(self, z: torch.Tensor, ctx=None):
        xs, log_det = [], z.new_zeros(z.shape[:-1])
        for i in range(self.dim):
            w, h, d = self._params_for(torch.stack(xs, dim=-1) if xs else None, z.shape[:-1])
            xi, ld = unconstrained_rqs(z[..., i], w, h, d, inverse=True, tail_bound=self.B)
            xs.append(xi)
            log_det = log_det + ld
        return torch.stack(xs, dim=-1), log_det


class NSFCoupling(nn.Module):
    """Coupling neural spline flow: the upper part through an RQS whose bins
    come from ``f1`` of the lower part, then the lower part through one from
    ``f2`` of the new upper part.  Both nets give ``dim // 2`` sets of
    spline parameters; at an odd ``dim`` the upper part is one wider, and
    its entries share the one set (dim 3), as they broadcast in the JAX
    package."""

    def __init__(self, dim: int, K: int = 5, B: float = 3.0, hidden_dim: int = 8):
        super().__init__()
        self.dim, self.K, self.B = dim, K, B
        half = dim // 2
        self.f1 = FCNN(half, (3 * K - 1) * half, hidden_dim)
        self.f2 = FCNN(dim - half, (3 * K - 1) * half, hidden_dim)

    def _spline_params(self, net: FCNN, cond: torch.Tensor):
        out = net(cond).reshape(cond.shape[:-1] + (self.dim // 2, 3 * self.K - 1))
        return _spline_split(out, self.K, self.B)

    def _spline(self, net, cond, x, inverse):
        w, h, d = self._spline_params(net, cond)
        y, ld = unconstrained_rqs(x, w, h, d, inverse=inverse, tail_bound=self.B)
        return y, torch.sum(ld, dim=-1)

    def forward(self, x: torch.Tensor, ctx=None):
        half = self.dim // 2
        lower, upper = x[..., :half], x[..., half:]
        upper, ld1 = self._spline(self.f1, lower, upper, False)
        lower, ld2 = self._spline(self.f2, upper, lower, False)
        return torch.cat([lower, upper], dim=-1), ld1 + ld2

    def inverse(self, z: torch.Tensor, ctx=None):
        half = self.dim // 2
        lower, upper = z[..., :half], z[..., half:]
        lower, ld1 = self._spline(self.f2, upper, lower, True)
        upper, ld2 = self._spline(self.f1, lower, upper, True)
        return torch.cat([lower, upper], dim=-1), ld1 + ld2


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
