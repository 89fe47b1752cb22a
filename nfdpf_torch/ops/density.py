"""Weight / density primitives shared by the filter engine.

Counterparts of ``nfdpf_tpu/ops/density.py:16-83``, as plain functions on
tensors with the particle axis last (weights) or second to last (states).
"""

from __future__ import annotations

import math

import torch


def normalize_log_weights(log_w: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max-shifted softmax over the particle axis → linear probabilities.

    The shift is NOT detached: the original routes gradient through
    ``.max()`` to the argmax element, and so does this.
    """
    shifted = log_w - torch.amax(log_w, dim=dim, keepdim=True)
    w = torch.exp(shifted)
    return w / torch.sum(w, dim=dim, keepdim=True)


def effective_sample_size(probs: torch.Tensor) -> torch.Tensor:
    """Mean ESS over the batch: ``mean_b 1/Σ_i w_bi²`` — one scalar."""
    return torch.mean(1.0 / torch.sum(probs**2, dim=-1))


def log_normal_density(noise: torch.Tensor, std_pos: float,
                       std_vel: float) -> torch.Tensor:
    """Factored diagonal-Gaussian log-pdf with separate position / velocity σ.

    Position block ``noise[..., :2]``, velocity block ``noise[..., 2:]``
    (empty when d == 2, leaving the constant ``-(d-2)·log σ_v = 0``).
    """
    d = noise.shape[-1]
    log_c = -0.5 * math.log(2.0 * math.pi)
    pos_term = -torch.sum(noise[..., :2] ** 2, dim=-1) / (2.0 * std_pos**2)
    vel_term = -torch.sum(noise[..., 2:] ** 2, dim=-1) / (2.0 * std_vel**2)
    const = d * log_c - 2.0 * math.log(std_pos) - (d - 2) * math.log(std_vel)
    return const + pos_term + vel_term


def cosine_distance(a: torch.Tensor, b: torch.Tensor,
                    eps: float = 1e-12) -> torch.Tensor:
    """``1 − cos_sim`` of L2-normalised encodings."""
    a = a / torch.clamp_min(torch.linalg.vector_norm(a, dim=-1, keepdim=True), eps)
    b = b / torch.clamp_min(torch.linalg.vector_norm(b, dim=-1, keepdim=True), eps)
    return 1.0 - torch.sum(a * b, dim=-1)


def weighted_mean(particles: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Posterior mean ``Σ_i w_i x_i``: (..., N, d), (..., N) → (..., d)."""
    return torch.sum(particles * probs[..., None], dim=-2)


def uniform_log_weights(batch_size: int, num_particles: int,
                        device=None) -> torch.Tensor:
    """``log(1/N)`` initial weights, (B, N)."""
    return torch.full((batch_size, num_particles), -math.log(num_particles),
                      device=device)
