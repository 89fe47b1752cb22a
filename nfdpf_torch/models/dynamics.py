"""Motion model and the importance-weight bookkeeping of the bootstrap DPF.

Counterparts of ``nfdpf_tpu/models/dynamics.py:32-39`` (``motion_update``),
the ``use_nf=False`` branch of ``nf_dynamic_model`` (``:82-83``) and the
bootstrap branch of ``proposal_likelihood`` (``:177-183``).  The flow
branches wait for ROADMAP queue 1, item 11.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from nfdpf_torch.ops.density import log_normal_density


def motion_update(
    particles: torch.Tensor,
    vel: torch.Tensor,
    pos_noise: float,
    normal: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bootstrap-prior propagation: particles + vel + pos_noise·N(0, 1).

    ``normal`` is the (B, N, d) standard-normal draw; when absent it is drawn
    from ``generator``.  vel is the teacher-forced (B, d) input.
    Returns (particles', noise) with noise = pos_noise·normal.
    """
    if normal is None:
        normal = torch.randn(particles.shape, generator=generator,
                             device=particles.device)
    noise = pos_noise * normal
    return particles + vel[:, None, :] + noise, noise


def nf_dynamic_model(particles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamics flow switched off: identity and zero jacobian (B, N)."""
    return particles, torch.zeros(particles.shape[:2], device=particles.device)


def proposal_likelihood(
    measurement_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    particles_dynamic: torch.Tensor,
    encodings: torch.Tensor,
    noise: torch.Tensor,
    jac_dynamic: torch.Tensor,
    pos_noise: float,
    vel_noise: float,
):
    """Bootstrap weight bookkeeping: prior == proposal, so the filter's
    ``log w += lki + prior − propose`` reduces to ``log w += lki``.

    Returns (proposed_particles, lki_log, prior_log, propose_log).
    """
    prior_log = log_normal_density(noise, pos_noise, vel_noise) + jac_dynamic
    lki_log = measurement_fn(encodings, particles_dynamic)
    return particles_dynamic, lki_log, prior_log, prior_log
