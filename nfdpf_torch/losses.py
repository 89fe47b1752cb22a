"""Training objectives: supervised RMSE, autoencoder MSE and the SDPF's
blockwise pseudo-likelihood.

Counterparts of ``nfdpf_tpu/losses.py``.  The pseudo-likelihood's ancestor
walk is two Python loops (blocks ascending, steps within a block
descending) of per-batch ``torch.gather``s where the JAX package scans.

On a ``mesh`` each rank passes its block (B/D sequences, N/P particles) and
gets the global loss: the estimate sums over the particle group, the means
over the global batch sum over the data group.  The pseudo-likelihood's
walk follows global ancestor indices across ranks: its (B, T, N/P) inputs
are all-gathered over the particle group once a loss (differentiably) and
every rank walks all N.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from nfdpf_torch.ops.density import batch_mean, weighted_mean
from nfdpf_torch.parallel.mesh import PARTICLE_AXIS, all_gather


def supervised_loss(
    particles: torch.Tensor,    # (B, T, N, d)
    weights: torch.Tensor,      # (B, T, N)
    true_state: torch.Tensor,   # (B, T, >=2)
    mask,                       # (B, T) tensor or scalar 1.0
    train: bool,
    labeled_ratio: float = 1.0,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked RMSE of the weighted-mean estimate.

    Train: sqrt(mean(mask·err²)/labeled_ratio); eval: plain RMSE.
    Returns (loss, prediction).
    """
    prediction = weighted_mean(particles, weights, mesh)
    err2 = (prediction - true_state[..., :2]) ** 2
    if not train:
        return torch.sqrt(batch_mean(err2, mesh)), prediction
    if labeled_ratio == 0:
        return torch.zeros((), device=err2.device), prediction
    mask = torch.as_tensor(mask, dtype=err2.dtype, device=err2.device)
    if mask.dim() == 2:
        mask = mask[..., None]
    return torch.sqrt(batch_mean(mask * err2, mesh) / labeled_ratio), prediction


def autoencoder_loss(images: torch.Tensor, reconstruction: torch.Tensor,
                     mesh=None) -> torch.Tensor:
    """MSE over all frames."""
    return batch_mean((reconstruction - images) ** 2, mesh)


def semi_supervised_mask(batch_size: int, seq_len: int, labeled_ratio: float,
                         generator: Optional[torch.Generator] = None,
                         device=None) -> torch.Tensor:
    """Exactly ⌊B·T·ratio⌋ ones shuffled over a (B, T) grid."""
    total = batch_size * seq_len
    n1 = int(total * labeled_ratio)
    flat = torch.cat([torch.zeros(total - n1, device=device),
                      torch.ones(n1, device=device)])
    perm = torch.randperm(total, generator=generator, device=device)
    return flat[perm].reshape(batch_size, seq_len)


def _ancestor_walk(
    likelihoods: torch.Tensor,   # (B, T, N)
    indices: torch.Tensor,       # (B, T, N) within-batch ancestor indices
    prior_terms: torch.Tensor,   # (B, T, N) per-step prior log term
    weights: torch.Tensor,       # (B, T, N)
    block_len: int,
    mesh=None,
) -> torch.Tensor:
    """The blockwise backward ancestor walk, Q/b per batch element, (B,).
    On a ``mesh`` the inputs are this rank's (B, T, N/P) blocks, with
    global indices, gathered here over the particle group.

    Each block of ``block_len`` steps walks from its last step back to its
    first, following the ancestor indices from the identity and adding the
    gathered prior and likelihood terms to the accumulator ``logyita``;
    Q adds the block-end weights times the accumulator.  Kept from the
    reference, as in the JAX package: ``logyita`` is never reset between
    blocks (block k's term holds every earlier block's sum), and a trailing
    partial block is ignored."""
    likelihoods, indices, prior_terms, weights = (
        all_gather(t, mesh, PARTICLE_AXIS, 2)
        for t in (likelihoods, indices, prior_terms, weights))
    batch, seq_len, n = likelihoods.shape
    nb = seq_len // block_len
    idx = indices.long()
    identity = torch.arange(n, device=likelihoods.device).expand(batch, n)
    q = torch.zeros(batch, dtype=likelihoods.dtype, device=likelihoods.device)
    ly = torch.zeros(batch, n, dtype=likelihoods.dtype, device=likelihoods.device)
    for k in range(nb):
        index_a = identity
        for j in reversed(range(k * block_len, (k + 1) * block_len)):
            ly = (ly + torch.gather(prior_terms[:, j], -1, index_a)
                  + torch.gather(likelihoods[:, j], -1, index_a))
            index_a = torch.gather(idx[:, j], -1, index_a)
        q = q + torch.sum(weights[:, (k + 1) * block_len - 1] * ly, dim=-1)
    return q / nb


def pseudolikelihood_loss(
    weights: torch.Tensor,
    noise: torch.Tensor,         # (B, T, N, d) motion noise
    likelihoods: torch.Tensor,
    indices: torch.Tensor,
    block_len: int = 10,
    std_pos: float = 1.0,
    std_vel: float = 1.0,
    mesh=None,
) -> torch.Tensor:
    """Gaussian-prior pseudo-likelihood.  The per-step prior term prices the
    stored motion noise, with the reference's constants: the velocity's
    normalising constant is there even for 2-D noise."""
    log_c = -0.5 * math.log(2 * math.pi)
    term_pos = (2 * log_c - 2 * math.log(std_pos)
                - torch.sum(noise[..., :2] ** 2 / (2 * std_pos ** 2), dim=-1))
    term_vel = (2 * log_c - 2 * math.log(std_vel)
                - torch.sum(noise[..., 2:] ** 2 / (2 * std_vel ** 2), dim=-1))
    q = _ancestor_walk(likelihoods, indices, term_pos + term_vel, weights, block_len, mesh)
    return -batch_mean(q, mesh)


def pseudolikelihood_loss_nf(
    weights: torch.Tensor,
    noise: torch.Tensor,
    likelihoods: torch.Tensor,
    indices: torch.Tensor,
    jacobians: torch.Tensor,     # (B, T, N): not added, as in the reference
    priors: torch.Tensor,        # (B, T, N)
    block_len: int = 10,
    mesh=None,
) -> torch.Tensor:
    """NF-prior pseudo-likelihood: the walk over the filter's prior terms.
    The reference gathers the dynamics Jacobians along the ancestors but
    never adds them; only prior + likelihood enter, here too."""
    q = _ancestor_walk(likelihoods, indices, priors, weights, block_len, mesh)
    return -batch_mean(q, mesh)
