"""Soft / systematic differentiable resampling, and multinomial resampling.

Counterpart of ``nfdpf_tpu/ops/resampling.py``:

* the sampling distribution is q = α·w + (1−α)/N, with the importance
  correction w/q on the chosen particles (α = 1: hard resampling, uniform
  weights);
* systematic markers: one offset per row in [0, 1/N) plus the evenly spaced
  ``basic`` grid; the chosen index is #{j : cum[j] < marker} after
  ``cum[:, -1] = 1``, i.e. ``searchsorted(..., right=False)``;
* the returned weights are renormalised over the resampled set, and the
  ancestor indices are per batch row, in [0, N).

Indices carry no gradient; it flows through the gathered particle values
and the importance-corrected weights.  The random draws come in as tensors
(``offset``, ``uniform``) or from a ``torch.Generator``.

With the particle axis sharded over P ranks, the soft resampler all-gathers
the weights and the particles (two differentiable all-gathers a firing),
draws the ancestors of all N slots on every rank from the same offsets, as
one rank does, and keeps its own N/P slots: their global ancestor indices,
the particles at them and the weights renormalised over all N, with one
rank's bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nfdpf_torch.parallel.mesh import PARTICLE_AXIS, all_gather, local_slice


def systematic_basic(n: int, device=None) -> torch.Tensor:
    """The markers' grid ``linspace(0, (n−1)/n, n)`` with the float32 bits of
    the JAX package's: XLA computes ``iota · (stop · (1/(n−1)))`` (the
    division by a constant turned into a product and the two constants
    folded), then appends ``stop``; ``torch.linspace`` rounds differently."""
    # both constants are float32 values: the kernels below take them as
    # arguments, with no host-to-device copy (which would sync each firing)
    stop = float(np.float32((n - 1.0) / n))
    end = torch.full((1,), stop, device=device)
    if n == 1:
        return end
    step = float(np.float32(stop) * (np.float32(1.0) / np.float32(n - 1)))
    return torch.cat([torch.arange(n - 1, dtype=torch.float32, device=device) * step, end])


def systematic_indices(q_probs: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Systematic ancestor indices, int32 (B, N).

    q_probs: (B, N) sampling distribution (rows sum to 1); offset: (B, 1)
    uniform in [0, 1/N).
    """
    n = q_probs.shape[1]
    markers = offset + systematic_basic(n, q_probs.device)[None, :]
    cum = torch.cumsum(q_probs.detach(), dim=1)
    cum[:, -1] = 1.0
    idx = torch.searchsorted(cum, markers.detach().contiguous(), right=False)
    return torch.clamp(idx, 0, n - 1).to(torch.int32)


def _gather(particles: torch.Tensor, probs: torch.Tensor, idx: torch.Tensor):
    i = idx.long()
    return (torch.gather(particles, 1, i[..., None].expand(-1, -1, particles.shape[-1])),
            torch.gather(probs, 1, i))


def soft_systematic_resample(
    particles: torch.Tensor,
    probs: torch.Tensor,
    alpha: float,
    offset: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    mesh=None,
):
    """Soft resampling (Karkus et al.) with systematic sampling.

    particles: (B, N, d); probs: (B, N) linear weights; alpha in (0, 1];
    offset: (B, 1) in [0, 1/N), drawn from ``generator`` when absent.
    Returns (particles', probs' linear and renormalised, ancestor indices).
    On a ``mesh`` particles and probs are this rank's (B, N/P) block, the
    offset its data rank's, and so are the results, with the indices global.
    """
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must lie in (0, 1], got {alpha}")
    particles = all_gather(particles, mesh, PARTICLE_AXIS, 1)
    probs = all_gather(probs, mesh, PARTICLE_AXIS, 1)
    batch, n = probs.shape
    uniform = torch.full_like(probs, 1.0 / n)
    if alpha < 1.0:
        q = alpha * probs + (1.0 - alpha) * uniform
        q = q / torch.sum(q, dim=-1, keepdim=True)
        corrected = probs / q
    else:
        q, corrected = probs, uniform
    if offset is None:
        offset = torch.rand((batch, 1), generator=generator, device=probs.device) * (1.0 / n)
    idx = systematic_indices(q, offset)
    new_particles, new_probs = _gather(particles, corrected, idx)
    new_probs = new_probs / torch.sum(new_probs, dim=-1, keepdim=True)
    return tuple(local_slice(t, mesh, PARTICLE_AXIS, 1) for t in (new_particles, new_probs, idx))


def multinomial_resample(
    particles: torch.Tensor,
    probs: torch.Tensor,
    uniform: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Plain multinomial resampling, as ``jax.random.choice(p=...)`` draws it:
    index = searchsorted(cum, cum[-1]·(1 − u)) for u ~ U[0, 1), (B, N),
    drawn from ``generator`` when ``uniform`` is absent.  Returns
    (particles', uniform probs, ancestor indices)."""
    cum = torch.cumsum(probs.detach(), dim=1)
    if uniform is None:
        uniform = torch.rand(probs.shape, generator=generator, device=probs.device)
    r = cum[:, -1:] * (1 - uniform)
    idx = torch.searchsorted(cum, r.contiguous()).to(torch.int32)
    new_particles, _ = _gather(particles, probs, idx)
    return new_particles, torch.full_like(probs, 1.0 / probs.shape[1]), idx
