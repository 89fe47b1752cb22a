"""Rational-quadratic spline transforms (Durkan et al. 2019).

Counterpart of ``nfdpf_tpu/ops/rqs.py``, with its choices kept:

  * no boolean indexing: the tails are handled with ``torch.where`` masks,
    the spline evaluated on the input clamped into the interval;
  * the bin lookup is a comparison-sum against the bin edges (the last edge
    raised by ``eps``), not a binary search;
  * every function works on any leading axes, and the spline parameters
    broadcast against the inputs (``torch.gather`` does not broadcast, so
    ``_take`` expands its operands first).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.nn import functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) as ``jax.nn.softplus`` computes it, ``logaddexp(x, 0)``
    (``F.softplus`` turns linear above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _searchsorted(bin_locations: torch.Tensor, inputs: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """The number of bin edges at or below each input, less one."""
    bin_locations = torch.cat([bin_locations[..., :-1], bin_locations[..., -1:] + eps], dim=-1)
    return torch.sum(inputs[..., None] >= bin_locations, dim=-1) - 1


def _edges(unnormalized: torch.Tensor, min_bin: float, low: float, high: float):
    """Softmax bins, at least ``min_bin`` of the box each, as cumulative edges
    from ``low`` to ``high`` (the two ends set exactly) and as widths."""
    num_bins = unnormalized.shape[-1]
    bins = min_bin + (1 - min_bin * num_bins) * torch.softmax(unnormalized, dim=-1)
    cum = (high - low) * F.pad(torch.cumsum(bins, dim=-1), (1, 0)) + low
    cum = torch.cat([torch.full_like(cum[..., :1], low), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], high)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(a, idx, -1)[..., 0]`` with the leading axes of ``a``
    and ``idx`` broadcast against each other."""
    lead = torch.broadcast_shapes(a.shape[:-1], idx.shape[:-1])
    return torch.gather(a.expand(lead + a.shape[-1:]), -1, idx.expand(lead + (1,)))[..., 0]


def rqs(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monotone RQS on the box [left, right] × [bottom, top].

    inputs: (...,); unnormalized_{widths,heights}: (..., K);
    unnormalized_derivatives: (..., K+1).  Returns (outputs, logabsdet).
    """
    num_bins = unnormalized_widths.shape[-1]
    cumwidths, widths = _edges(unnormalized_widths, min_bin_width, left, right)
    cumheights, heights = _edges(unnormalized_heights, min_bin_height, bottom, top)
    derivatives = min_derivative + softplus(unnormalized_derivatives)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)[..., None]
    bin_idx = torch.clamp(bin_idx, 0, num_bins - 1)

    input_cumwidths = _take(cumwidths, bin_idx)
    input_bin_widths = _take(widths, bin_idx)
    input_cumheights = _take(cumheights, bin_idx)
    delta = heights / widths
    input_delta = _take(delta, bin_idx)
    input_derivatives = _take(derivatives, bin_idx)
    input_derivatives_p1 = _take(derivatives[..., 1:], bin_idx)
    input_heights = _take(heights, bin_idx)
    slope_sum = input_derivatives + input_derivatives_p1 - 2 * input_delta

    if inverse:
        a = (inputs - input_cumheights) * slope_sum + input_heights * (
            input_delta - input_derivatives)
        b = input_heights * input_derivatives - (inputs - input_cumheights) * slope_sum
        c = -input_delta * (inputs - input_cumheights)
        discriminant = torch.clamp_min(b**2 - 4 * a * c, 0.0)
        theta = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs = theta * input_bin_widths + input_cumwidths
    else:
        theta = (inputs - input_cumwidths) / input_bin_widths
    theta_1m = theta * (1 - theta)
    denominator = input_delta + slope_sum * theta_1m
    deriv_num = input_delta**2 * (input_derivatives_p1 * theta**2
                                  + 2 * input_delta * theta_1m
                                  + input_derivatives * (1 - theta) ** 2)
    logabsdet = torch.log(deriv_num) - 2 * torch.log(denominator)
    if inverse:
        return outputs, -logabsdet
    numerator = input_heights * (input_delta * theta**2 + input_derivatives * theta_1m)
    return input_cumheights + numerator / denominator, logabsdet


def unconstrained_rqs(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RQS with identity tails outside ±tail_bound: the spline on the inputs
    clamped into the interval, ``where``-selected against the identity.  The
    boundary derivatives are padded with softplus⁻¹(1 − min_derivative), so
    the spline's slope is 1 at both ends."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.exp(1 - min_derivative) - 1)
    derivs = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    clamped = torch.clamp(inputs, -tail_bound, tail_bound)
    spl_out, spl_ld = rqs(
        clamped, unnormalized_widths, unnormalized_heights, derivs, inverse=inverse,
        left=-tail_bound, right=tail_bound, bottom=-tail_bound, top=tail_bound,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative)
    outputs = torch.where(inside, spl_out, inputs)
    logabsdet = torch.where(inside, spl_ld, torch.zeros_like(spl_ld))
    return outputs, logabsdet
