"""Training objectives: supervised RMSE and autoencoder MSE.

Counterparts of ``nfdpf_tpu/losses.py:22-70``.  The SDPF pseudo-likelihood
losses wait for ROADMAP queue 1, item 13.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nfdpf_torch.ops.density import weighted_mean


def supervised_loss(
    particles: torch.Tensor,    # (B, T, N, d)
    weights: torch.Tensor,      # (B, T, N)
    true_state: torch.Tensor,   # (B, T, >=2)
    mask,                       # (B, T) tensor or scalar 1.0
    train: bool,
    labeled_ratio: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked RMSE of the weighted-mean estimate.

    Train: sqrt(mean(mask·err²)/labeled_ratio); eval: plain RMSE.
    Returns (loss, prediction).
    """
    prediction = weighted_mean(particles, weights)
    err2 = (prediction - true_state[..., :2]) ** 2
    if not train:
        return torch.sqrt(torch.mean(err2)), prediction
    if labeled_ratio == 0:
        return torch.zeros((), device=err2.device), prediction
    mask = torch.as_tensor(mask, dtype=err2.dtype, device=err2.device)
    if mask.dim() == 2:
        mask = mask[..., None]
    return torch.sqrt(torch.mean(mask * err2) / labeled_ratio), prediction


def autoencoder_loss(images: torch.Tensor, reconstruction: torch.Tensor) -> torch.Tensor:
    """MSE over all frames."""
    return torch.mean((reconstruction - images) ** 2)


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
