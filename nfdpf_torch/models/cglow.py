"""Conditional GLOW: an image-space conditional normalizing flow.

Counterpart of ``nfdpf_tpu/models/cglow.py``, module for module and with
its names.  Tensors are NHWC as in the JAX package: ``squeeze2d``'s
(c, fh, fw) channel order, the 1×1 convolution's weight and ``Split2d``'s
halving all index those channels.  The convolutions run in PyTorch's NCHW,
permuted in and out around each ``conv2d`` call only.  The per-sample
invertible 1×1 convolution is one batched product, its log-determinant and
inverse the unrolled eliminations of ``nfdpf_torch/ops/linalg.py``.

Structure (defaults: x = y = (8, 8, 3), K = 1, L = 1):

    CondGlowModel
      └─ L × [squeeze ; K × CondGlowStep ; Split2d (if l < L−1)]
           CondGlowStep = CondActNorm → Cond1x1Conv → CondAffineCoupling
    nll = −(logdet + prior logp − log(n_bins)·D) / (log 2 · D)   [bits/dim]

Initialisation follows the JAX package's initialisers (``flax_init_`` reads
each layer's ``init_std`` and ``bias_std`` and each module's
``param_init_std``): zeros for the resizing convolutions, the zero-init
dense layers and ``ConvZerosY``; N(0, 0.1²) for ``ConvZeros`` and both
tensors of ``DenseNorm``; N(0, 0.05²) for ``ConvNormY``'s convolution and
the image actnorm.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from nfdpf_torch.ops import linalg


def _init_std(layer: nn.Module, weight_std: float, bias_std: Optional[float] = None):
    """Mark ``layer`` for ``flax_init_``: weights N(0, weight_std²) (zeros at
    0), bias N(0, bias_std²) or zeros."""
    layer.init_std = weight_std
    layer.bias_std = bias_std
    return layer


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on an NHWC tensor, in NCHW inside."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _same_conv(in_ch: int, out_ch: int, kernel: int, std: float, bias: bool = True):
    """A stride-1 'SAME' convolution (odd kernel: symmetric padding)."""
    conv = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2, bias=bias)
    return _init_std(conv, std)


class _PatchConv(nn.Module):
    """Non-overlapping (stride = kernel) convolution as space-to-depth and
    one matmul.  ``weight`` is the (kh, kw, I, O) kernel flattened to
    (kh·kw·I, O), the contraction order of the patches."""

    def __init__(self, kh: int, kw: int, in_ch: int, out_ch: int):
        super().__init__()
        self.kh, self.kw = kh, kw
        self.weight = nn.Parameter(torch.zeros(kh * kw * in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.param_init_std = {"weight": 0.0, "bias": 0.0}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        h, w, c = x.shape[-3:]
        ho, wo = h // self.kh, w // self.kw
        x = x.reshape(lead + (ho, self.kh, wo, self.kw, c))
        # (..., ho, kh, wo, kw, C) → (..., ho, wo, kh, kw, C): the kernel's order
        x = x.transpose(-4, -3).reshape(lead + (ho, wo, self.kh * self.kw * c))
        return x @ self.weight + self.bias


class ConvResize(nn.Module):
    """Zero-init VALID convolution whose kernel and stride hit ``out_hw``
    exactly.  Where the stride equals the kernel (CGLOW's 8→4→2→1 halvings)
    it is a ``_PatchConv``; otherwise a strided convolution over the same
    (kh·kw·I, O) weight."""

    def __init__(self, in_hw: Tuple[int, int], out_hw: Tuple[int, int], in_ch: int,
                 out_ch: int):
        super().__init__()
        sh, sw = in_hw[0] // out_hw[0], in_hw[1] // out_hw[1]
        kh = in_hw[0] - (out_hw[0] - 1) * sh
        kw = in_hw[1] - (out_hw[1] - 1) * sw
        self.stride = (sh, sw)
        self.patch = (kh, kw) == (sh, sw)
        self.conv = _PatchConv(kh, kw, in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.patch:
            return self.conv(x)
        p = self.conv
        kernel = p.weight.reshape(p.kh, p.kw, -1, p.weight.shape[-1]).permute(3, 2, 0, 1)
        out = F.conv2d(x.permute(0, 3, 1, 2), kernel, p.bias, stride=self.stride)
        return out.permute(0, 2, 3, 1)


class ConvZeros(nn.Module):
    """3×3 SAME convolution, weights N(0, 0.1²) (not zeros, despite the
    name kept from the reference), bias zeros."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3):
        super().__init__()
        self.conv = _same_conv(in_ch, out_ch, kernel, 0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.conv, x)


class ImageActNorm(nn.Module):
    """Per-channel (x + bias)·exp(logs) over NHWC."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.logs = nn.Parameter(torch.zeros(num_channels))
        self.param_init_std = {"bias": 0.05, "logs": 0.05}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x + self.bias) * torch.exp(self.logs)


class ConvNormY(nn.Module):
    """SAME convolution without bias, N(0, 0.05²), then ``ImageActNorm``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3):
        super().__init__()
        self.conv = _same_conv(in_ch, out_ch, kernel, 0.05, bias=False)
        self.actnorm = ImageActNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.actnorm(_conv_nhwc(self.conv, x))


class ConvZerosY(nn.Module):
    """Zero-init 3×3 convolution, then (x + newbias)·exp(3·logs): the
    coupling's zero-at-init head."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = _same_conv(in_ch, out_ch, 3, 0.0)
        self.logs = nn.Parameter(torch.zeros(out_ch))
        self.newbias = nn.Parameter(torch.zeros(out_ch))
        self.param_init_std = {"logs": 0.0, "newbias": 0.0}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (_conv_nhwc(self.conv, x) + self.newbias) * torch.exp(self.logs * 3.0)


def DenseZeros(in_features: int, out_features: int) -> nn.Linear:
    """Zero-init dense layer."""
    return _init_std(nn.Linear(in_features, out_features), 0.0)


def DenseNorm(in_features: int, out_features: int) -> nn.Linear:
    """Dense layer with weights and bias N(0, 0.1²)."""
    return _init_std(nn.Linear(in_features, out_features), 0.1, 0.1)


class ConditioningNet(nn.Module):
    """The condition tower: 3 × (ConvResize halving H and W, ReLU), flatten
    in NHWC order, two zero-init dense layers with ReLU and a head
    (``DenseZeros`` for ``head_init="zeros"``, ``DenseNorm`` for "norm"),
    tanh."""

    def __init__(self, x_hw: Tuple[int, int], x_channels: int, hidden_channels: int,
                 hidden_size: int, out_features: int, head_init: str = "zeros"):
        super().__init__()
        hw, chans, resize = tuple(x_hw), x_channels, []
        for _ in range(3):
            nhw = (hw[0] // 2, hw[1] // 2)
            resize.append(ConvResize(hw, nhw, chans, hidden_channels))
            hw, chans = nhw, hidden_channels
        self.resize = nn.ModuleList(resize)
        head = DenseZeros if head_init == "zeros" else DenseNorm
        self.dense = nn.ModuleList([DenseZeros(chans * hw[0] * hw[1], hidden_size),
                                    DenseZeros(hidden_size, hidden_size),
                                    head(hidden_size, out_features)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = x
        for conv in self.resize:
            z = F.relu(conv(z))
        z = z.reshape(z.shape[:-3] + (-1,))
        z = F.relu(self.dense[0](z))
        z = F.relu(self.dense[1](z))
        return torch.tanh(self.dense[2](z))


class CondActNorm(nn.Module):
    """Actnorm whose per-channel logs and bias come from the condition;
    log-det = H·W·Σ logs per sample."""

    def __init__(self, x_hw, x_channels, x_hidden_channels, x_hidden_size, y_channels):
        super().__init__()
        self.net = ConditioningNet(x_hw, x_channels, x_hidden_channels, x_hidden_size,
                                   2 * y_channels, head_init="zeros")

    def forward(self, x, y, logdet, reverse: bool = False):
        logs, bias = torch.chunk(self.net(x), 2, dim=-1)    # first half logs
        logs, bias = logs[:, None, None, :], bias[:, None, None, :]
        dlogdet = y.shape[-3] * y.shape[-2] * torch.sum(logs, dim=(-3, -2, -1))
        if not reverse:
            return (y + bias) * torch.exp(logs), logdet + dlogdet
        return y * torch.exp(-logs) - bias, logdet - dlogdet


class Cond1x1Conv(nn.Module):
    """Per-sample invertible 1×1 convolution with a weight (C, C) made from
    the condition; log-det = H·W·log|det W|."""

    def __init__(self, x_hw, x_channels, x_hidden_channels, x_hidden_size, y_channels):
        super().__init__()
        self.y_channels = y_channels
        self.net = ConditioningNet(x_hw, x_channels, x_hidden_channels, x_hidden_size,
                                   y_channels ** 2, head_init="norm")

    def forward(self, x, y, logdet, reverse: bool = False):
        c = self.y_channels
        weight = self.net(x).reshape(x.shape[0], c, c)      # (B, out k, in i)
        dlogdet = linalg.logabsdet(weight) * (y.shape[-3] * y.shape[-2])
        if reverse:
            weight = linalg.inv(weight)
            dlogdet = -dlogdet
        z = torch.einsum("bhwi,bki->bhwk", y, weight)
        return z, logdet + dlogdet


class CondAffineCoupling(nn.Module):
    """Channel-split affine coupling: x resized to z1's spatial shape,
    concatenated with z1, through a small conv net giving (shift, scale)
    from its even and odd channels; scale = sigmoid(raw + 2)."""

    def __init__(self, x_hw, x_channels, y_half_channels, y_hw, hidden_channels):
        super().__init__()
        self.rx1 = ConvZeros(x_channels, 16)
        self.rx2 = ConvResize(tuple(x_hw), tuple(y_hw), 16, y_half_channels)
        self.rx3 = ConvZeros(y_half_channels, y_half_channels)
        self.f1 = ConvNormY(2 * y_half_channels, hidden_channels)
        self.f2 = ConvNormY(hidden_channels, hidden_channels, kernel=1)
        self.f3 = ConvZerosY(hidden_channels, 2 * y_half_channels)

    def _shift_scale(self, x, z1):
        xr = F.relu(self.rx1(x))
        xr = F.relu(self.rx2(xr))
        xr = F.relu(self.rx3(xr))
        h = torch.cat([xr, z1], dim=-1)
        h = F.relu(self.f1(h))
        h = F.relu(self.f2(h))
        h = torch.tanh(self.f3(h))
        return h[..., 0::2], torch.sigmoid(h[..., 1::2] + 2.0)

    def forward(self, x, y, logdet, reverse: bool = False):
        c = y.shape[-1] // 2
        z1, z2 = y[..., :c], y[..., c:]
        shift, scale = self._shift_scale(x, z1)
        if not reverse:
            z2 = (z2 + shift) * scale
            logdet = logdet + torch.sum(torch.log(scale), dim=(-3, -2, -1))
        else:
            z2 = z2 / scale - shift
            logdet = logdet - torch.sum(torch.log(scale), dim=(-3, -2, -1))
        return torch.cat([z1, z2], dim=-1), logdet


def squeeze2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Space-to-depth on NHWC, channel order (c, fh, fw)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // factor, w // factor, c * factor * factor)


def unsqueeze2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    b, h, w, cf = x.shape
    c = cf // (factor * factor)
    x = x.reshape(b, h, w, c, factor, factor)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * factor, w * factor, c)


def gaussian_logp(mean: torch.Tensor, logs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Diagonal-Gaussian log-density summed over H, W and C."""
    ll = -0.5 * (logs * 2.0 + ((x - mean) ** 2) / torch.exp(logs * 2.0)
                 + math.log(2 * math.pi))
    return torch.sum(ll, dim=(-3, -2, -1))


class Split2d(nn.Module):
    """Halve the channels; z2 is priced under a Gaussian whose mean and logs
    (even and odd channels) come from z1."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.prior_conv = ConvZeros(num_channels // 2, num_channels)

    def _prior(self, z1):
        h = torch.tanh(self.prior_conv(z1))
        return h[..., 0::2], h[..., 1::2]

    def forward(self, y, logdet, reverse: bool = False, eps=None):
        if not reverse:
            c = y.shape[-1] // 2
            z1, z2 = y[..., :c], y[..., c:]
            mean, logs = self._prior(z1)
            return z1, logdet + gaussian_logp(mean, logs, z2)
        mean, logs = self._prior(y)
        z2 = mean + torch.exp(logs) * (eps if eps is not None else 0.0)
        return torch.cat([y, z2], dim=-1), logdet


class CondGlowStep(nn.Module):
    """actnorm → 1×1 convolution → affine coupling."""

    def __init__(self, x_hw, x_channels, x_hidden_channels, x_hidden_size, y_channels,
                 y_hw, y_hidden_channels):
        super().__init__()
        cond = (x_hw, x_channels, x_hidden_channels, x_hidden_size, y_channels)
        self.actnorm = CondActNorm(*cond)
        self.invconv = Cond1x1Conv(*cond)
        self.affine = CondAffineCoupling(x_hw, x_channels, y_channels // 2, y_hw,
                                         y_hidden_channels)

    def forward(self, x, y, logdet, reverse: bool = False):
        order = ((self.actnorm, self.invconv, self.affine) if not reverse
                 else (self.affine, self.invconv, self.actnorm))
        for layer in order:
            y, logdet = layer(x, y, logdet, reverse)
        return y, logdet


class CondGlowModel(nn.Module):
    """The whole conditional GLOW.  Inputs NHWC: ``x`` the condition (the
    particle's encoding), ``y`` the target (the observation's encoding).
    ``forward`` returns (z, nll in bits/dim); ``decode`` inverts ``encode``.
    ``x_size`` and ``y_size`` are CHW, as configured."""

    def __init__(self, x_size=(3, 8, 8), y_size=(3, 8, 8), x_hidden_channels: int = 8,
                 x_hidden_size: int = 16, y_hidden_channels: int = 8, flow_depth: int = 1,
                 num_levels: int = 1, learn_top: bool = False, y_bins: float = 256.0):
        super().__init__()
        cx, hx, wx = x_size
        c, h, w = y_size
        self.learn_top = learn_top
        self.y_bins = y_bins
        kinds, mods = [], []
        for level in range(num_levels):
            c, h, w = c * 4, h // 2, w // 2
            kinds.append("squeeze")
            for _ in range(flow_depth):
                kinds.append("step")
                mods.append(CondGlowStep((hx, wx), cx, x_hidden_channels, x_hidden_size,
                                         c, (h, w), y_hidden_channels))
            if level < num_levels - 1:
                kinds.append("split")
                mods.append(Split2d(c))
                c //= 2
        self.layer_kinds = tuple(kinds)
        self.layer_mods = nn.ModuleList(mods)
        if learn_top:
            self.top_mean = nn.Parameter(torch.zeros(1, h, w, c))
            self.top_logs = nn.Parameter(torch.zeros(1, h, w, c))
            self.param_init_std = {"top_mean": 0.0, "top_logs": 0.0}

    def _modules_in_order(self):
        mods = iter(self.layer_mods)
        return [(kind, None if kind == "squeeze" else next(mods)) for kind in self.layer_kinds]

    def _prior(self, z):
        if self.learn_top:
            return self.top_mean, self.top_logs
        return torch.zeros_like(z), torch.zeros_like(z)

    def encode(self, x, y, logdet):
        for kind, mod in self._modules_in_order():
            if kind == "squeeze":
                y = squeeze2d(y)
            elif kind == "split":
                y, logdet = mod(y, logdet, reverse=False)
            else:
                y, logdet = mod(x, y, logdet, reverse=False)
        return y, logdet

    def decode(self, x, y, logdet, eps=None):
        for kind, mod in reversed(self._modules_in_order()):
            if kind == "squeeze":
                y = unsqueeze2d(y)
            elif kind == "split":
                y, logdet = mod(y, logdet, reverse=True, eps=eps)
            else:
                y, logdet = mod(x, y, logdet, reverse=True)
        return y, logdet

    def forward(self, x: torch.Tensor, y: torch.Tensor):
        """(z, nll): nll in bits/dim, with the −log(n_bins)·D dequantisation
        constant."""
        dims = y.shape[-3] * y.shape[-2] * y.shape[-1]
        logdet = torch.full(y.shape[:1], -math.log(self.y_bins) * dims, dtype=y.dtype,
                            device=y.device)
        z, objective = self.encode(x, y, logdet)
        mean, logs = self._prior(z)
        objective = objective + gaussian_logp(mean, logs, z)
        return z, -objective / (math.log(2.0) * dims)
