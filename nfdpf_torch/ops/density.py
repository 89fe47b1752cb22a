"""Weight / density primitives shared by the filter engine.

Counterparts of ``nfdpf_tpu/ops/density.py:16-83``, as plain functions on
tensors with the particle axis last (weights) or second to last (states).
Those that reduce over particles or the batch take a ``mesh``: with the
particle axis sharded their sums and maxima run over the particle group,
with the batch sharded the batch mean over the data group.
"""

from __future__ import annotations

import math

import torch

from nfdpf_torch.parallel.mesh import DATA_AXIS, PARTICLE_AXIS, axis_size, psum, row_max


def normalize_log_weights(log_w: torch.Tensor, mesh=None) -> torch.Tensor:
    """Max-shifted softmax over the particle axis (the last) → linear
    probabilities.

    The shift is NOT detached: the original routes gradient through
    ``.max()`` to the argmax element, and so does this (across the particle
    group under a mesh).
    """
    w = torch.exp(log_w - row_max(log_w, mesh))
    return w / psum(torch.sum(w, dim=-1, keepdim=True), mesh, PARTICLE_AXIS)


def effective_sample_size(probs: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean ESS over the batch: ``mean_b 1/Σ_i w_bi²`` — one scalar, the
    same on every rank of a mesh."""
    inv = 1.0 / psum(torch.sum(probs**2, dim=-1), mesh, PARTICLE_AXIS)
    return batch_mean(inv, mesh)


def batch_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The mean of ``x`` over the global batch, whose leading axis is
    sharded over the data axis: the data group's mean of the ranks' equal
    blocks' means (unsharded: ``torch.mean(x)`` itself, bit for bit)."""
    return psum(torch.mean(x), mesh, DATA_AXIS) / axis_size(mesh, DATA_AXIS)


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


def weighted_mean(particles: torch.Tensor, probs: torch.Tensor, mesh=None) -> torch.Tensor:
    """Posterior mean ``Σ_i w_i x_i``: (..., N, d), (..., N) → (..., d)."""
    return psum(torch.sum(particles * probs[..., None], dim=-2), mesh, PARTICLE_AXIS)


def uniform_log_weights(batch_size: int, num_particles: int,
                        device=None) -> torch.Tensor:
    """``log(1/N)`` initial weights, (B, N)."""
    return torch.full((batch_size, num_particles), -math.log(num_particles),
                      device=device)
