"""NN building blocks: observation encoder/decoder, particle encoder, the
likelihood head and the learned transition.

Counterparts of ``nfdpf_tpu/models/nets.py:59-179``.  The public functions
keep the JAX package's NHWC image layout; the convolutions run in PyTorch's
NCHW inside.  Layer order is Conv → ReLU → BatchNorm, with the flax
BatchNorm's rule for running statistics (``FlaxBatchNorm``).

The encoder and decoder take a ``compute_dtype`` as flax's ``dtype``: the
parameters stay float32, the input and each layer's kernel are cast to it
where the layer runs, BatchNorm computes its statistics and its affine map
in float32 and returns the compute dtype, dense layers add their bias
after the product and the decoder's sigmoid is XLA's 1/(1 + exp(−x)), each
op rounded, and the output is cast back to float32.  The casts are
explicit (``torch.autocast``'s op lists are not flax's).  With
``torch_init`` a net's dense and conv layers are marked for torch's default
initialisation instead of flax's (``flax_init_``).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from nfdpf_torch.parallel.mesh import DATA_AXIS, axis_size, psum

ENC_CHANNELS = (3, 16, 32, 64, 128, 256)


class FlaxBatchNorm(nn.Module):
    """BatchNorm over dim 1 that follows ``flax.linen.BatchNorm``:

    * batch variance E[x²] − E[x]² (clipped at 0), biased, both for
      normalising and for the running variance (torch's own BatchNorm stores
      the unbiased one, which breaks eval-mode parity);
    * running = (1 − momentum)·running + momentum·batch, torch momentum 0.1
      = flax momentum 0.9; eps 1e-5;
    * under a ``mesh`` whose data axis shards the batch, the statistics are
      the global batch's: the data group's mean of each rank's means of x
      and x² (all-reduced differentiably), as GSPMD reduces flax's means.
    """

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5,
                 mesh=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.mesh = mesh
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Statistics, running statistics and the affine map in the
        parameters' dtype, float32 (as flax promotes a bfloat16 input); the
        result in ``x``'s dtype."""
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.to(self.weight.dtype)
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            moments = psum(torch.stack([torch.mean(xf, dim=dims), torch.mean(xf * xf, dim=dims)]),
                           self.mesh, DATA_AXIS) / axis_size(self.mesh, DATA_AXIS)
            mean, mean2 = moments[0], moments[1]
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mark_torch_init(*layers: nn.Module) -> None:
    """Mark dense and conv layers for torch's default initialisation."""
    for layer in layers:
        for m in layer.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                m.torch_init = True


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` in ``x``'s dtype: below float32, as flax's ``Dense``, the
    product in it and then the bias added in it (two roundings)."""
    if x.dtype == layer.weight.dtype:
        return layer(x)
    return F.linear(x, layer.weight.to(x.dtype)) + layer.bias.to(x.dtype)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic; below float32 as XLA expands it, 1/(1 + exp(−x)) with
    every op rounded to the compute dtype."""
    if torch.finfo(x.dtype).bits >= 32:
        return torch.sigmoid(x)
    return torch.reciprocal(1.0 + torch.exp(-x))


class ObservationEncoder(nn.Module):
    """5× (Conv k4 s2 p1 → ReLU → BN) 3→16→32→64→128→256 over 128²→4²,
    flatten in NHWC order, Linear → out_features.  (..., H, W, 3) → (..., out),
    computed in ``compute_dtype``, returned in float32."""

    def __init__(self, out_features: int = 32, compute_dtype: torch.dtype = torch.float32,
                 torch_init: bool = False, mesh=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        pairs = list(zip(ENC_CHANNELS[:-1], ENC_CHANNELS[1:]))
        self.convs = nn.ModuleList(
            nn.Conv2d(ci, co, 4, stride=2, padding=1, bias=False) for ci, co in pairs)
        self.norms = nn.ModuleList(FlaxBatchNorm(co, mesh=mesh) for _, co in pairs)
        self.dense = nn.Linear(256 * 4 * 4, out_features)
        if torch_init:
            _mark_torch_init(self.convs, self.dense)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        lead = images.shape[:-3]
        dt = self.compute_dtype
        x = images.reshape((-1,) + images.shape[-3:]).permute(0, 3, 1, 2).to(dt)
        for conv, norm in zip(self.convs, self.norms):
            x = F.conv2d(x, conv.weight.to(dt), None, conv.stride, conv.padding)
            x = norm(F.relu(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return _linear(self.dense, x).to(self.dense.weight.dtype).reshape(lead + (-1,))


class ObservationDecoder(nn.Module):
    """Linear → (4, 4, 256) → 4× (ConvTranspose k4 s2 → ReLU → BN) →
    ConvTranspose to 3 channels → BN → Sigmoid.  (..., in) → (..., 128, 128, 3),
    computed in ``compute_dtype``, returned in float32.  With ``torch_init``
    a ConvTranspose's fan-in is torch's, out_ch·kh·kw."""

    def __init__(self, in_features: int = 32, compute_dtype: torch.dtype = torch.float32,
                 torch_init: bool = False, mesh=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        chans = ENC_CHANNELS[::-1]                      # 256 → 3
        pairs = list(zip(chans[:-1], chans[1:]))
        self.dense = nn.Linear(in_features, 256 * 4 * 4)
        self.deconvs = nn.ModuleList(
            nn.ConvTranspose2d(ci, co, 4, stride=2, padding=1, bias=False)
            for ci, co in pairs)
        self.norms = nn.ModuleList(FlaxBatchNorm(co, mesh=mesh) for _, co in pairs)
        if torch_init:
            _mark_torch_init(self.dense, self.deconvs)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        lead = z.shape[:-1]
        dt = self.compute_dtype
        x = _linear(self.dense, z.reshape(-1, z.shape[-1]).to(dt))
        x = x.reshape(-1, 4, 4, 256).permute(0, 3, 1, 2)
        last = len(self.deconvs) - 1
        for k, (deconv, norm) in enumerate(zip(self.deconvs, self.norms)):
            x = F.conv_transpose2d(x, deconv.weight.to(dt), None, deconv.stride,
                                   deconv.padding)
            x = norm(x if k == last else F.relu(x))
        x = _sigmoid(x).to(self.dense.weight.dtype).permute(0, 2, 3, 1)
        return x.reshape(lead + x.shape[1:])


class ParticleEncoder(nn.Module):
    """MLP state(d)→16→32→out, applied on (..., d)."""

    def __init__(self, out_features: int = 32, state_dim: int = 2, torch_init: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(state_dim, 16)
        self.fc2 = nn.Linear(16, 32)
        self.fc3 = nn.Linear(32, out_features)
        if torch_init:
            _mark_torch_init(self)

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(s)))))


class LikelihoodNet(nn.Module):
    """MLP in→64→64→1 + sigmoid, the ``NN`` measurement's head, applied on
    (..., in)."""

    def __init__(self, in_features: int = 64, torch_init: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 64)
        self.fc2 = nn.Linear(64, 64)
        self.fc3 = nn.Linear(64, 1)
        if torch_init:
            _mark_torch_init(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.fc3(F.relu(self.fc2(F.relu(self.fc1(x))))))


class TransitionMLP(nn.Module):
    """Learned transition state→64→64→state with ReLUs, applied on
    (..., state_dim).  No configuration uses it (nor does the JAX package's
    filter); flax's default initialisers."""

    def __init__(self, state_dim: int = 2):
        super().__init__()
        self.fc1 = nn.Linear(state_dim, 64)
        self.fc2 = nn.Linear(64, 64)
        self.fc3 = nn.Linear(64, state_dim)

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(s)))))


def _normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """``t`` ← N(0, std²) drawn on the CPU, or zeros (no draw) at std 0."""
    if std == 0.0:
        t.zero_()
    else:
        t.copy_(torch.empty(t.shape).normal_(0.0, std, generator=generator))


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise ``module`` with flax's defaults, as the JAX package does:
    lecun-normal kernels (normal with variance 1/fan_in, truncated at two
    standard deviations), zero biases, BatchNorm scale 1 / bias 0 and
    running statistics 0 / 1.  A layer that carries an ``init_std`` (the
    flows' conditioners, the conditional GLOW's layers) draws its weights
    from N(0, init_std²) instead (zeros at 0), and its bias from
    N(0, bias_std²) where it carries a ``bias_std``; a module with a
    ``param_init_std`` dict draws each of the named parameters so, and one
    with a ``param_init_uniform`` dict draws each from U[0, scale), as
    flax's ``uniform(scale)``.
    ``generator`` must live on the CPU; the draws are copied to the
    parameters' device, in the order the modules were registered.  The
    ``torch_init`` layers are drawn after all of them, and the flax draw
    each replaces is still taken (and dropped): every other parameter gets
    the draw it gets without ``torch_init``, as the JAX package's
    per-module keys give it."""
    torch_layers = []
    for m in module.modules():
        for name, std in getattr(m, "param_init_std", {}).items():
            _normal_(getattr(m, name), std, generator)
        for name, scale in getattr(m, "param_init_uniform", {}).items():
            p = getattr(m, name)
            p.copy_(torch.empty(p.shape).uniform_(0.0, scale, generator=generator))
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            draw = torch.empty(w.shape)
            init_std = getattr(m, "init_std", None)
            if init_std is not None:
                _normal_(draw, init_std, generator)
            else:
                if isinstance(m, nn.Linear):
                    fan_in = w.shape[1]
                else:  # flax counts the kernel's input channels for both convs
                    in_ch = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
                    fan_in = in_ch * w.shape[2] * w.shape[3]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
            if getattr(m, "torch_init", False):
                torch_layers.append(m)
                continue
            w.copy_(draw)
            if m.bias is not None:
                _normal_(m.bias, getattr(m, "bias_std", None) or 0.0, generator)
        elif isinstance(m, FlaxBatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    for m in torch_layers:
        bound = m.weight[0].numel() ** -0.5
        for p in (m.weight, m.bias):
            if p is not None:
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))
