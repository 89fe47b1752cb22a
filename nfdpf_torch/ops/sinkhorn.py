"""Entropy-regularised OT resampling over materialised (B, N, N) costs: the
ε-annealed Sinkhorn and its geometry helpers.

Counterpart of ``nfdpf_tpu/ops/sinkhorn.py``.  ``softmin`` over a
materialised cost is also the plain version of the streaming softmin kernel
(``nfdpf_torch/ops/cuda/sinkhorn_cuda.py``), which takes over under
``use_pallas``.

Gradient topology, as in the JAX package: the annealing loop runs on
detached potentials (``torch.no_grad()``, where JAX's ``while_loop`` is off
the tape) and only the final softmin round at the target ε is
differentiable.  ``ot_resample(transport_grad=False)`` detaches the whole
plan: the gradient reaches the particles only through ``T @ particles`` and
never the weights.  With ``transport_grad=True`` the final round stays on
the tape and the gradient also flows through T into particles and weights.

The loop stops on data, so each loop test is read on the host: one device
sync per test in eager PyTorch.  ``DENSE_LOOP`` counts the firings, the
iterations (as the JAX package counts them, ``i + 2``) and these syncs.
With a ``mesh`` whose data axis shards the batch, the loop test is taken
over the whole batch (an all-reduce over the data group), so every data
rank runs until the global batch converges, as GSPMD runs JAX's loop.

With the particle axis sharded over P ranks (each holding N/P particles),
the rows are sharded the way K6 shards them, and no rank holds an (N, N)
matrix:

* the particles and log-weights are all-gathered once a firing
  (differentiably), and the centring, the diameter and ``max_min`` are
  built from the whole cloud alike on every rank;
* each rank holds its (B, N/P, N) rows of both costs; a softmin round is
  the two softmins on those rows and one all-gather of their (B, 2, N/P)
  result, after which every rank runs the average, max|Δ|, the ε step and
  the stop test over all N: the same bits as one rank (the cost's cross
  term is summed per coordinate, so a row block has the whole matrix's bits),
  so the same iterations, with no all-reduce in the loop;
* the plan's column normaliser is each rank's column logsumexp,
  all-gathered and reduced over the P ranks; each rank applies its rows to
  the gathered particles and returns its own N/P outputs.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from nfdpf_torch.parallel.mesh import (
    DATA_AXIS,
    PARTICLE_AXIS,
    agree,
    all_gather,
    axis_index,
    axis_size,
    local_slice,
)

# dense Sinkhorn loops since the last reset: calls, iterations, host syncs
DENSE_LOOP = {"calls": 0, "iters": 0, "host_syncs": 0}


def reset_dense_loop() -> None:
    for k in DENSE_LOOP:
        DENSE_LOOP[k] = 0


def squared_distances(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise ‖x_i − y_j‖² over the particle axis: (B,N,d),(B,M,d) → (B,N,M).

    The cross term is summed coordinate by coordinate, not by a matrix
    product: a GEMM library picks its kernel (and whether it fuses the
    multiply-add) by shape, so a block of rows would not keep the whole
    matrix's bits, and the sharded loop's iterations hang on them."""
    x2 = torch.sum(x**2, dim=-1)
    y2 = torch.sum(y**2, dim=-1)
    xy = x[..., :, None, 0] * y[..., None, :, 0]
    for k in range(1, x.shape[-1]):
        xy = xy + x[..., :, None, k] * y[..., None, :, k]
    return torch.clamp_min(x2[..., :, None] + y2[..., None, :] - 2.0 * xy, 0.0)


def cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """½·squared distance."""
    return squared_distances(x, y) / 2.0


def diameter(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Max over dims of the per-batch BIASED std, floored at 1 when zero: (B,)."""
    dx = torch.amax(torch.std(x, dim=1, correction=0), dim=-1)
    dy = torch.amax(torch.std(y, dim=1, correction=0), dim=-1)
    res = torch.maximum(dx, dy)
    return torch.where(res == 0.0, torch.ones_like(res), res)


def max_min(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Annealing scale proxy, (B,).

    The original takes ``min_min`` from ``x.max(dim=1).min()`` — a
    max-then-min, not min-then-min — and so does this.
    """
    max_max = torch.maximum(torch.amax(x, dim=(1, 2)), torch.amax(y, dim=(1, 2)))
    min_min = torch.minimum(torch.amin(torch.amax(x, dim=1), dim=-1),
                            torch.amin(y, dim=(1, 2)))
    return max_max - min_min


def softmin(epsilon, cost_matrix: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """−ε·logsumexp(f − C/ε) over the last axis.

    epsilon: (B,) or scalar; cost_matrix: (B, N, M); f: (B, M) → (B, N).
    """
    eps = torch.as_tensor(epsilon, dtype=cost_matrix.dtype,
                          device=cost_matrix.device).expand(cost_matrix.shape[0])
    val = f[:, None, :] - cost_matrix / eps[:, None, None]
    return -eps[:, None] * torch.logsumexp(val, dim=2)


def _softmin_pair(eps, cost_xy, cost_yx, f_a, f_b, mesh):
    """``softmin(eps, cost_yx, f_a)`` and ``softmin(eps, cost_xy, f_b)`` over
    all N rows, (B, N) each: this rank's rows, then one all-gather of both
    over the particle group (differentiable; the identity on one rank)."""
    both = torch.stack([softmin(eps, cost_yx, f_a), softmin(eps, cost_xy, f_b)], dim=1)
    both = all_gather(both, mesh, PARTICLE_AXIS, 2)
    return both[:, 0], both[:, 1]


def sinkhorn_loop(
    log_alpha: torch.Tensor,
    log_beta: torch.Tensor,
    cost_xy: torch.Tensor,
    cost_yx: torch.Tensor,
    epsilon: float,
    particles_diameter: torch.Tensor,
    scaling: float,
    threshold: float,
    max_iter: int,
    convergence: str = "all",
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """ε-annealed symmetric Sinkhorn from ε₀ = diameter² down to ``epsilon``,
    then one differentiable softmin round at the target ε from the loop's
    detached potentials.  Returns (a_y, b_x, iterations) with iterations the
    loop count plus 2, as the JAX package reports it.

    Only (a_y, b_x) are live: the self-transport potentials of the symmetric
    loop never feed them, the stopping test or the plan.

    ``log_alpha``/``log_beta`` are (B, N); the costs are this rank's rows of
    the particle axis, (B, N/P, N) (all of them on one rank).  The
    potentials returned are over all N on every rank.
    """
    if convergence not in ("all", "any"):
        raise ValueError(f"convergence must be 'all' or 'any', got {convergence!r}")
    batch = log_alpha.shape[0]
    dev = cost_xy.device
    eps_target = torch.full((batch,), epsilon, dtype=cost_xy.dtype, device=dev)
    scaling_factor = scaling**2
    agg = torch.all if convergence == "all" else torch.any

    with torch.no_grad():
        eps_run = particles_diameter**2
        a_y, b_x = _softmin_pair(eps_run, cost_xy, cost_yx, log_alpha, log_beta, mesh)
        running = torch.ones(batch, dtype=torch.bool, device=dev)
        i = 0
        # continue while i < max_iter-1 and every ('all') / some ('any') row
        # is still running
        while i < max_iter - 1:
            DENSE_LOOP["host_syncs"] += 1
            if not agree(agg(running), mesh, DATA_AXIS, convergence):
                break
            eps_col = eps_run[:, None]
            run = running[:, None]
            at_y, bt_x = _softmin_pair(eps_run, cost_xy, cost_yx, log_alpha + b_x / eps_col,
                                       log_beta + a_y / eps_col, mesh)
            at_y = torch.where(run, at_y, a_y)
            bt_x = torch.where(run, bt_x, b_x)
            a_y_new, b_x_new = (a_y + at_y) / 2, (b_x + bt_x) / 2
            a_diff = torch.amax(torch.abs(a_y_new - a_y), dim=1)
            b_diff = torch.amax(torch.abs(b_x_new - b_x), dim=1)
            local = (a_diff > threshold) | (b_diff > threshold)
            new_eps = torch.maximum(eps_run * scaling_factor, eps_target)
            running = (new_eps < eps_run) | local
            a_y, b_x, eps_run = a_y_new, b_x_new, new_eps
            i += 1
    DENSE_LOOP["calls"] += 1
    DENSE_LOOP["iters"] += i + 2

    eps_col = eps_target[:, None]
    final_a_y, final_b_x = _softmin_pair(eps_target, cost_xy, cost_yx,
                                         log_alpha + b_x / eps_col, log_beta + a_y / eps_col,
                                         mesh)
    return final_a_y, final_b_x, i + 2


def sinkhorn_potentials(log_alpha, x, log_beta, y, epsilon: float, scaling: float,
                        threshold: float, max_iter: int, convergence: str = "all", mesh=None):
    """Cost matrices (each detaching its second operand; this rank's rows of
    the particle axis) and the annealed loop, with the detached ``max_min``
    scale of the whole clouds as the diameter."""
    cost_xy = cost(local_slice(x, mesh, PARTICLE_AXIS, 1), y.detach())
    cost_yx = cost(local_slice(y, mesh, PARTICLE_AXIS, 1), x.detach())
    scale = max_min(x, y).detach()
    return sinkhorn_loop(log_alpha, log_beta, cost_xy, cost_yx, epsilon, scale,
                         scaling, threshold, max_iter, convergence, mesh)


def transport_from_potentials(x: torch.Tensor, f: torch.Tensor, g: torch.Tensor,
                              eps: float, logw: torch.Tensor, n: int,
                              mesh=None) -> torch.Tensor:
    """Column-normalised transport matrix T_ij = n·w_j·softmax_i((f_i + g_j −
    C_ij)/ε): each column j sums to n·w_j, so ``T @ x`` with uniform output
    weights keeps the weighted empirical measure.

    Under a particle axis (``x``, ``f``, ``g``, ``logw`` over all N) this
    rank's rows i, (B, N/P, N): the softmax over i takes each rank's column
    logsumexp, all-gathered (differentiable) and reduced over the ranks."""
    fg = local_slice(f, mesh, PARTICLE_AXIS, 1)[:, :, None] + g[:, None, :]
    temp = (fg - cost(local_slice(x, mesh, PARTICLE_AXIS, 1), x)) / eps
    colnorm = torch.logsumexp(temp, dim=1, keepdim=True)
    if axis_size(mesh, PARTICLE_AXIS) > 1:
        colnorm = torch.logsumexp(all_gather(colnorm, mesh, PARTICLE_AXIS, 1), dim=1,
                                  keepdim=True)
    temp = temp - colnorm + math.log(n)
    return torch.exp(temp + logw[:, None, :])


def sinkhorn_transport(x: torch.Tensor, logw: torch.Tensor, eps: float, scaling: float,
                       threshold: float, max_iter: int, convergence: str = "all",
                       mesh=None) -> torch.Tensor:
    """The transport matrix (this rank's rows of it under a particle axis;
    ``x``/``logw`` are the whole cloud): centre, scale by the detached
    diameter·√d, run the Sinkhorn against the uniform measure on the same
    support, assemble T."""
    n, d = x.shape[1], x.shape[-1]
    uniform_logw = torch.full_like(logw, -math.log(n))
    centered = x - torch.mean(x, dim=1, keepdim=True).detach()
    scale = (diameter(x, x)[:, None, None] * math.sqrt(d)).detach()
    scaled_x = centered / scale
    alpha, beta, _ = sinkhorn_potentials(logw, scaled_x, uniform_logw, scaled_x, eps,
                                         scaling, threshold, max_iter, convergence, mesh)
    return transport_from_potentials(scaled_x, alpha, beta, eps, logw, n, mesh)


def ot_resample(
    particles: torch.Tensor,
    probs: torch.Tensor,
    eps: float = 0.1,
    scaling: float = 0.75,
    threshold: float = 1e-3,
    max_iter: int = 100,
    transport_grad: bool = False,
    convergence: str = "all",
    mesh=None,
):
    """Entropy-regularised OT resampling over a materialised plan.

    particles: (B, N, d); probs: (B, N) linear weights.  Returns
    (T @ particles, uniform probs, identity ancestor indices): OT has no
    discrete ancestors.  ``transport_grad=False`` detaches T (the gradient
    reaches the particles through the product only); True keeps the final
    Sinkhorn round on the tape.  On a ``mesh`` both come as this rank's
    block, (B/D, N/P, ...), and so do the results, with the indices global.
    """
    batch, block, _ = particles.shape
    # the whole cloud on every rank of the particle group
    x_all = all_gather(particles, mesh, PARTICLE_AXIS, 1)
    logw = all_gather(torch.log(probs), mesh, PARTICLE_AXIS, 1)
    n = x_all.shape[1]
    if transport_grad:
        t = sinkhorn_transport(x_all, logw, eps, scaling, threshold, max_iter,
                               convergence, mesh)
    else:
        with torch.no_grad():
            t = sinkhorn_transport(x_all.detach(), logw.detach(), eps, scaling,
                                   threshold, max_iter, convergence, mesh)
    transported = torch.einsum("bij,bjd->bid", t, x_all)
    uniform = torch.full_like(probs, 1.0 / n)
    lo = axis_index(mesh, PARTICLE_AXIS) * block
    idx = (lo + torch.arange(block, dtype=torch.int32, device=particles.device)).expand(
        batch, block)
    return transported, uniform, idx
