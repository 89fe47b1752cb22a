"""Motion model, NF dynamics, NF proposal, and the importance-weight
bookkeeping that ties them together.

Counterpart of ``nfdpf_tpu/models/dynamics.py``.  The flows are the port's
``FlowChain`` modules; ``fused`` optionally carries a chain's packed
(weights, biases) and routes it through the fused coupling kernels
(``ops/cuda/coupling_cuda.py``).

Stop-gradient topology, as in the JAX package:

* the particle mean/std contexts are detached;
* the observation encodings are detached before they enter the proposal:
  the gradient reaches the encoder only through the measurement model and
  the AE loss.

The particle std is the unbiased (N−1) estimator (``torch.std``'s default).
A context is one row per batch element broadcast over the particles; it is
returned as an expanded view, not a copy.  Under a ``mesh`` whose particle
axis is sharded the mean and std are those of all N particles, gathered
over the particle group (B·N·d values), so every rank computes them as the
unsharded run does.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from nfdpf_torch.ops.cuda.coupling_cuda import fused_coupling_chain
from nfdpf_torch.ops.density import log_normal_density
from nfdpf_torch.ops.flows import FlowChain
from nfdpf_torch.parallel.mesh import PARTICLE_AXIS, all_gather
from nfdpf_torch.utils.profiling import bracket_backward

Packed = Optional[Tuple[torch.Tensor, torch.Tensor]]


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


def _particle_stats(particles: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Detached per-batch particle mean and unbiased std, (B, 1, d) each."""
    p = all_gather(particles.detach(), mesh, PARTICLE_AXIS, 1)
    return torch.mean(p, dim=1, keepdim=True), torch.std(p, dim=1, keepdim=True)


def _stats_context(particles: torch.Tensor, mean=None, std=None,
                   lead: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Detached mean‖std (of ``particles`` unless given), with ``lead``
    (B, 1, h) in front when given, broadcast to a per-particle context
    (B, N, [h +] 2d)."""
    if mean is None:
        mean, std = _particle_stats(particles, mesh)
    parts = [mean.detach(), std.detach()]
    if lead is not None:
        parts.insert(0, lead)
    ctx = torch.cat(parts, dim=-1)                            # (B, 1, C)
    return ctx.expand(particles.shape[0], particles.shape[1], ctx.shape[-1])


def _apply_chain(flow: Optional[FlowChain], x: torch.Tensor, ctx: torch.Tensor,
                 fused: Packed, inverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x', log_det) of a flow chain with its context, inverse or forward:
    the packed chain through ``fused_coupling_chain`` where ``fused`` holds
    it, else the ``FlowChain`` module."""
    if fused is not None:
        return fused_coupling_chain(x, ctx, fused[0], fused[1], inverse)
    if inverse:
        return flow.inverse(x, ctx)
    out, _, log_det = flow.forward(x, ctx)
    return out, log_det


def nf_dynamic_model(
    dyn_flow: Optional[FlowChain],
    particles: torch.Tensor,
    use_nf: bool,
    forward: bool = False,
    mean: Optional[torch.Tensor] = None,
    std: Optional[torch.Tensor] = None,
    fused: Packed = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Conditional-)flow refinement of physically propagated particles.

    ``forward=False`` (the filter's path) applies the INVERSE of the dynamics
    flow; ``forward=True`` is the consistency pass used when inverting
    proposals.  The context is the detached mean‖std of ``particles``, or
    the given ``mean``/``std`` (detached here).  Returns (particles', jac)
    with jac = −log_det, (B, N); with ``use_nf`` off, the identity and zeros.
    """
    if not use_nf:
        return particles, torch.zeros(particles.shape[:2], device=particles.device)
    ctx = _stats_context(particles, mean, std, mesh=mesh)
    out, log_det = bracket_backward("dynamics", _apply_chain, dyn_flow, particles, ctx, fused,
                                    not forward)
    return out, -log_det


def normalising_flow_propose(
    cond_flow: Optional[FlowChain],
    particles_pred: torch.Tensor,
    obs_encoding: torch.Tensor,
    fused: Packed = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conditional-NF proposal: the inverse of the proposal flow with the
    per-particle context obs encoding ‖ detached particle mean ‖ std.
    Returns (proposed, jac = −log_det)."""
    ctx = _stats_context(particles_pred, lead=obs_encoding[:, None, :], mesh=mesh)
    out, log_det = bracket_backward("proposal", _apply_chain, cond_flow, particles_pred, ctx,
                                    fused, True)
    return out, -log_det


def proposal_likelihood(
    cond_flow: Optional[FlowChain],
    dyn_flow: Optional[FlowChain],
    measurement_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    particles_dynamic: torch.Tensor,
    particles_physical: torch.Tensor,
    encodings: torch.Tensor,
    noise: torch.Tensor,
    jac_dynamic: torch.Tensor,
    use_nf: bool,
    use_nf_cond: bool,
    pos_noise: float,
    vel_noise: float,
    fused_dyn: Packed = None,
    fused_cond: Packed = None,
    mesh=None,
):
    """Central importance-weight bookkeeping.

    Returns (proposed_particles, lki_log, prior_log, propose_log) so the
    filter can update ``log w += lki + prior − propose``.  With the proposal
    flow off, prior == propose and the update reduces to the bootstrap
    ``log w += lki``.
    """
    def density(x):
        return log_normal_density(x, pos_noise, vel_noise)

    if use_nf_cond:
        propose, jac_prop = normalising_flow_propose(
            cond_flow, particles_dynamic, encodings.detach(), fused=fused_cond, mesh=mesh)
        if use_nf:
            phys_mean, phys_std = _particle_stats(particles_physical, mesh)
            prop_dyn_inv, jac_prop_dyn_inv = nf_dynamic_model(
                dyn_flow, propose, use_nf=True, forward=True,
                mean=phys_mean, std=phys_std, fused=fused_dyn, mesh=mesh)
            prior_log = (density(prop_dyn_inv - (particles_physical - noise))
                         - jac_prop_dyn_inv)
        else:
            prior_log = density(propose - (particles_physical - noise))
        propose_log = density(noise) + jac_dynamic + jac_prop
    else:
        propose = particles_dynamic
        prior_log = density(noise) + jac_dynamic
        propose_log = prior_log

    lki_log = bracket_backward("measurement", measurement_fn, encodings, propose)
    return propose, lki_log, prior_log, propose_log
