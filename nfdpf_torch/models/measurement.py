"""Measurement models: p(observation | particle) in encoding space.

Counterpart of ``nfdpf_tpu/models/measurement.py``.  Each module takes the
observation encodings (B, h) and particles (B, N, d) and returns
per-particle log-likelihoods (B, N), and owns its particle encoder.  The
Gaussian, CRNVP and CGLOW models subtract each row's maximum (``torch.amax``,
whose gradient splits between ties as ``jnp.max``'s does), over the
particle group of their ``mesh`` when the particle axis is sharded.  ``torch_init``
reaches the particle encoder and the NN head, as in the JAX package; the
flows' and the CGLOW's own draws do not change with it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nfdpf_torch.config import DPFConfig
from nfdpf_torch.models.cglow import CondGlowModel
from nfdpf_torch.models.nets import LikelihoodNet, ParticleEncoder
from nfdpf_torch.ops.density import cosine_distance
from nfdpf_torch.ops.flows import realnvp_chain
from nfdpf_torch.parallel.mesh import row_max


def _minus_row_max(lik: torch.Tensor, mesh=None) -> torch.Tensor:
    return lik - row_max(lik, mesh)


class CosineMeasurement(nn.Module):
    """``log 1/(1e-7 + cos-distance)`` between the observation encoding and
    each encoded particle."""

    def __init__(self, hidden_size: int = 32, state_dim: int = 2, torch_init: bool = False):
        super().__init__()
        self.particle_encoder = ParticleEncoder(hidden_size, state_dim, torch_init)

    def forward(self, encodings: torch.Tensor, particles: torch.Tensor) -> torch.Tensor:
        e_state = self.particle_encoder(particles)
        lik = 1.0 / (1e-7 + cosine_distance(encodings[:, None, :], e_state))
        return torch.log(lik)


class NNMeasurement(nn.Module):
    """``log sigmoid(MLP(e_obs ‖ e_state))``, the log taken of the sigmoid's
    value as in the JAX package (not ``logsigmoid``: the two differ where
    the sigmoid saturates in float32)."""

    def __init__(self, hidden_size: int = 32, state_dim: int = 2, torch_init: bool = False):
        super().__init__()
        self.particle_encoder = ParticleEncoder(hidden_size, state_dim, torch_init)
        self.likelihood_net = LikelihoodNet(2 * hidden_size, torch_init)

    def forward(self, encodings: torch.Tensor, particles: torch.Tensor) -> torch.Tensor:
        e_state = self.particle_encoder(particles)
        e_obs = encodings[:, None, :].expand_as(e_state)
        lik = self.likelihood_net(torch.cat([e_obs, e_state], dim=-1))
        return torch.log(lik[..., 0])


class GaussianMeasurement(nn.Module):
    """``MVN(mean·𝟙, variance·I).log_prob(e_obs − e_state)`` minus the row
    maximum."""

    def __init__(self, hidden_size: int = 32, state_dim: int = 2, mean: float = 1.0,
                 variance: float = 100.0, torch_init: bool = False, mesh=None):
        super().__init__()
        self.particle_encoder = ParticleEncoder(hidden_size, state_dim, torch_init)
        self.mean = mean
        self.variance = variance
        self.mesh = mesh

    def forward(self, encodings: torch.Tensor, particles: torch.Tensor) -> torch.Tensor:
        diff = encodings[:, None, :] - self.particle_encoder(particles)
        h = diff.shape[-1]
        lik = (-0.5 * h * math.log(2 * math.pi) - 0.5 * h * math.log(self.variance)
               - 0.5 * torch.sum((diff - self.mean) ** 2, dim=-1) / self.variance)
        return _minus_row_max(lik, self.mesh)


class CRNVPMeasurement(nn.Module):
    """Conditional-RealNVP density of e_obs given e_state, minus the row
    maximum: a chain of ``n_sequence`` blocks over the hidden_size-wide
    encoding, prior N(0, 2.5²), context e_state."""

    def __init__(self, hidden_size: int = 32, n_sequence: int = 2,
                 flow_hidden_dim: int = 8, state_dim: int = 2, torch_init: bool = False,
                 mesh=None):
        super().__init__()
        self.particle_encoder = ParticleEncoder(hidden_size, state_dim, torch_init)
        self.cnf = realnvp_chain(n_sequence, hidden_size, flow_hidden_dim, 0.01,
                                 prior_std=2.5, ctx_dim=hidden_size)
        self.mesh = mesh

    def forward(self, encodings: torch.Tensor, particles: torch.Tensor) -> torch.Tensor:
        e_state = self.particle_encoder(particles)
        e_obs = encodings[:, None, :].expand_as(e_state)
        _, log_prob_z, log_det = self.cnf(e_obs, e_state)
        return _minus_row_max(log_prob_z + log_det, self.mesh)


class CGlowMeasurement(nn.Module):
    """Conditional-GLOW bits/dim of e_obs given e_state, negated, minus the
    row maximum.  Both encodings are ``glow_ctx_features`` (3·8·8 = 192)
    wide and are reshaped to (b·n, h, w, c), NHWC, as the JAX package does,
    although ``x_size`` is given as CHW: only the agreement of the two
    sides matters, and parity needs JAX's layout."""

    def __init__(self, config: DPFConfig, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.x_size = tuple(config.x_size)
        self.particle_encoder = ParticleEncoder(config.glow_ctx_features, config.state_dim,
                                                config.torch_init)
        self.cglow = CondGlowModel(
            x_size=config.x_size, y_size=config.y_size,
            x_hidden_channels=config.x_hidden_channels, x_hidden_size=config.x_hidden_size,
            y_hidden_channels=config.y_hidden_channels, flow_depth=config.flow_depth,
            num_levels=config.num_levels, learn_top=config.learn_top, y_bins=config.y_bins)

    def forward(self, encodings: torch.Tensor, particles: torch.Tensor) -> torch.Tensor:
        b, n, _ = particles.shape
        c, h, w = self.x_size
        e_state = self.particle_encoder(particles).reshape(b * n, h, w, c)
        e_obs = encodings[:, None, :].expand(b, n, encodings.shape[-1]).reshape(b * n, h, w, c)
        _, nll = self.cglow(e_state, e_obs)
        return _minus_row_max(-nll.reshape(b, n), self.mesh)


def build_measurement_model(config: DPFConfig, mesh=None) -> nn.Module:
    """Dispatch on ``--measurement``; ``mesh`` reaches the models that
    subtract the row maximum."""
    kind = config.measurement
    ti = config.torch_init
    if kind == "cos":
        return CosineMeasurement(config.hidden_size, config.state_dim, ti)
    if kind == "NN":
        return NNMeasurement(config.hidden_size, config.state_dim, ti)
    if kind == "gaussian":
        return GaussianMeasurement(config.hidden_size, config.state_dim, torch_init=ti,
                                   mesh=mesh)
    if kind == "CRNVP":
        return CRNVPMeasurement(config.hidden_size, config.n_sequence,
                                config.flow_hidden_dim, config.state_dim, ti, mesh)
    if kind == "CGLOW":
        return CGlowMeasurement(config, mesh)
    raise ValueError(f"unknown measurement model {kind!r}")
