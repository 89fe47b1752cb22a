"""Measurement models: p(observation | particle) in encoding space.

Counterpart of ``nfdpf_tpu/models/measurement.py``.  The port has the
cosine model of the bootstrap DPF; the other four wait for their ROADMAP
items.
"""

from __future__ import annotations

import torch
from torch import nn

from nfdpf_torch.config import DPFConfig
from nfdpf_torch.models.nets import ParticleEncoder
from nfdpf_torch.ops.density import cosine_distance


class CosineMeasurement(nn.Module):
    """``log 1/(1e-7 + cos-distance)`` between the observation encoding and
    each encoded particle: (B, h), (B, N, d) → (B, N)."""

    def __init__(self, hidden_size: int = 32, state_dim: int = 2):
        super().__init__()
        self.particle_encoder = ParticleEncoder(hidden_size, state_dim)

    def forward(self, encodings: torch.Tensor, particles: torch.Tensor) -> torch.Tensor:
        e_state = self.particle_encoder(particles)
        lik = 1.0 / (1e-7 + cosine_distance(encodings[:, None, :], e_state))
        return torch.log(lik)


def build_measurement_model(config: DPFConfig) -> nn.Module:
    """Dispatch on ``--measurement``."""
    kind = config.measurement
    if kind == "cos":
        return CosineMeasurement(config.hidden_size, config.state_dim)
    if kind in ("NN", "gaussian", "CRNVP"):
        raise NotImplementedError(
            f"measurement {kind!r} is not ported yet (ROADMAP queue 1, item 12)")
    if kind == "CGLOW":
        raise NotImplementedError(
            "measurement 'CGLOW' is not ported yet (ROADMAP queue 1, item 15)")
    raise ValueError(f"unknown measurement model {kind!r}")
