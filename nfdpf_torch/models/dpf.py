"""The differentiable particle filter engine.

Counterpart of ``nfdpf_tpu/models/dpf.py`` for the bootstrap DPF and the
CNF-DPF (``nf_dyn`` RealNVP dynamics, ``nf_cond`` RealNVP proposal, each
alone or together), with the cos, NN, gaussian, CRNVP or CGLOW measurement
and soft or OT resampling.  As in the JAX package:

* the encoder and decoder are ``encoder_width`` wide: ``glow_ctx_features``
  (192) under CGLOW, ``hidden_size`` otherwise; the proposal flow's
  context is that width plus the particle mean‖std;

* the engine owns both flow chains whatever the switches say; an unused
  chain takes no part in the filter and gets no gradient;
* with ``pallas_coupling`` (and state dim 2) each used chain is packed once
  before the time loop and runs through the fused coupling kernels
  (``ops/cuda/coupling_cuda.py``); otherwise through its ``FlowChain``
  module;
* the conv encoder runs ONCE over all B·T frames before the time loop (BN
  statistics over all of them), or, with ``encode_per_step`` in training,
  inside it on each step's B frames (``filter_encoding_per_step``);
* encoder and decoder compute in ``compute_dtype`` (float32 or bfloat16,
  parameters float32); ``torch_init`` gives the nets the JAX package passes
  it to torch's default initialisation;
* with ``remat_scan_step`` each time step from the resample through the new
  weights is recomputed in the backward (``torch.utils.checkpoint``); the
  gate and the step's draws are taken outside that region;
* resampling is gated by the scalar batch-mean ESS — here a Python ``if``
  on the gate, so only the taken branch runs.  Reading the gate costs one
  device sync per time step;
* OT resampling runs on the streaming-Sinkhorn kernels under ``use_pallas``
  (``ops/cuda/sinkhorn_cuda.py``) and otherwise, or whenever
  ``ot_transport_grad`` is set, over materialised costs (``ops/sinkhorn.py``);
* with ``sinkhorn_warm_start`` (streaming path only) the potentials of the
  last firing ride the time loop, from zeros marked not valid; a step whose
  gate does not fire passes them on untouched;
* on a ``mesh`` (``parallel/mesh.py``) each rank holds B/D sequences and N/P
  particles: the weight normalisation, the ESS gate, the measurement's row
  maximum, the flows' contexts and ``obs_likelihood`` are reduced over the
  mesh; when P > 1 the streaming OT runs on the particle-sharded Sinkhorn
  (``ot_resample_streaming_sharded``, K6), OT over materialised costs on
  its row blocks (``ops/sinkhorn.py``) and the soft resampler on the
  gathered weights (``ops/resampling.py``), each with global ancestor
  indices; the Sinkhorn stop tests run over the data group.

Random draws come in through ``noise`` (a dict of tensors) or from a
``torch.Generator``; on a mesh both are the GLOBAL draws (every rank draws
all of them from the same generator) and each rank takes its block, so a
sharded run replays the unsharded one:

* ``"init"``: the initial particles, (B, N, 2);
* ``"motion"``: standard-normal motion draws, (T, B, N, 2), scaled by
  ``pos_noise`` inside ``motion_update``;
* ``"resample"``: the soft resampler's systematic offsets, (T, B, 1), each
  in [0, 1/N).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from nfdpf_torch.config import DPFConfig
from nfdpf_torch.models.dynamics import motion_update, nf_dynamic_model, proposal_likelihood
from nfdpf_torch.models.measurement import build_measurement_model
from nfdpf_torch.models.nets import (
    COMPUTE_DTYPES,
    ObservationDecoder,
    ObservationEncoder,
    flax_init_,
)
from nfdpf_torch.ops.cuda.coupling_cuda import chain_refusal, pack_chain_params
from nfdpf_torch.ops.cuda.sinkhorn_cuda import (
    ot_resample_streaming,
    ot_resample_streaming_sharded,
)
from nfdpf_torch.ops.density import (
    batch_mean,
    effective_sample_size,
    normalize_log_weights,
    uniform_log_weights,
)
from nfdpf_torch.ops.flows import realnvp_chain
from nfdpf_torch.ops.resampling import soft_systematic_resample
from nfdpf_torch.ops.sinkhorn import ot_resample
from nfdpf_torch.parallel.mesh import (
    DATA_AXIS,
    PARTICLE_AXIS,
    axis_index,
    axis_size,
    local_slice,
    psum,
)
from nfdpf_torch.utils.profiling import bracket_backward, span


class FilterOutput(NamedTuple):
    """Stacked per-step filter histories, time axis second."""

    particles: torch.Tensor         # (B, T, N, d)
    weights: torch.Tensor           # (B, T, N) normalised linear (+1e-12)
    noise: torch.Tensor             # (B, T, N, d) motion noise
    likelihoods: torch.Tensor       # (B, T, N) measurement log-lik
    indices: torch.Tensor           # (B, T, N) ancestor indices (int32)
    jacobians: torch.Tensor         # (B, T, N) dynamics-flow jac (zeros without nf_dyn)
    priors: torch.Tensor            # (B, T, N) prior log terms
    init_weights_log: torch.Tensor  # (B, N)
    obs_likelihood: torch.Tensor    # scalar: Σ_t mean(log w̃_t)
    resampled: torch.Tensor         # (T,) bool: ESS gate fired at step t
    sinkhorn_iters: torch.Tensor    # (T,) int32: Sinkhorn loop iterations at step t


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; with no GPU and no explicit
    device this raises rather than run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port "
                           "on the CPU (its kernels then use their plain versions)")
    return torch.device("cuda")


def check_supported(cfg: DPFConfig) -> None:
    """Raise ``ValueError`` for values no package runs."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, "
                         f"got {cfg.compute_dtype!r}")
    if cfg.resampler_type not in ("ot", "soft"):
        raise ValueError(f"unknown resampler {cfg.resampler_type!r}")
    if cfg.sinkhorn_warm_start and not streaming_ot(cfg):
        raise ValueError("sinkhorn_warm_start requires the streaming OT path "
                         "(resampler_type='ot', use_pallas=True, ot_transport_grad=False)")
    if cfg.train_type not in ("DPF", "SDPF"):
        raise ValueError("trainType must be DPF (supervised) or SDPF (semi-supervised)")


def encoder_width(cfg: DPFConfig) -> int:
    """The observation encoding's width: the CGLOW condition's
    ``glow_ctx_features`` under that measurement, else ``hidden_size``."""
    return cfg.glow_ctx_features if cfg.measurement == "CGLOW" else cfg.hidden_size


def streaming_ot(cfg: DPFConfig) -> bool:
    """True when OT resampling runs on the streaming-Sinkhorn kernels."""
    return cfg.resampler_type == "ot" and cfg.use_pallas and not cfg.ot_transport_grad


def check_coupling_kernels(cfg: DPFConfig) -> None:
    """On CUDA the packed chains run on the coupling kernels: the narrow pair
    K4/K5 where it takes a chain, the wide pair every other one, with any
    number of blocks and any context (``coupling_cuda``).  Raise
    ``NotImplementedError`` for a chain neither takes (``chain_refusal``: a
    hidden width above ``WIDE_MAX_HIDDEN``), with the limit the wrapper
    applies at launch."""
    if not (cfg.pallas_coupling and cfg.state_dim == 2):
        return
    why = chain_refusal(cfg.flow_hidden_dim)
    for name, used in (("dynamics", cfg.nf_dyn), ("proposal", cfg.nf_cond)):
        if used and why is not None:
            raise NotImplementedError(
                f"the {name} flow's packed chain does not run on the CUDA coupling kernels: {why}")


def particle_initialization(
    start_state: torch.Tensor,
    width: float,
    num_particles: int,
    state_dim: int = 2,
    init_with_true_state: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """True state + N(0, 1), or uniform over ±width/2.  Returns
    (particles (B, N, 2), log-weights (B, N))."""
    batch = start_state.shape[0]
    dev = start_state.device
    if init_with_true_state:
        noise = torch.randn((batch, num_particles, state_dim), generator=generator,
                            device=dev)
        particles = start_state[:, None, :state_dim] + noise
    else:
        u = torch.rand((batch, num_particles, 2), generator=generator, device=dev)
        particles = u * width - width / 2.0
    return particles, uniform_log_weights(batch, num_particles, dev)


class DPF(nn.Module):
    """Filter engine and model container: ``encoder``, ``decoder``,
    ``measurement`` and the two RealNVP chains ``nf_dyn`` (context: particle
    mean‖std) and ``cond_model`` (context: encoding‖mean‖std).  BatchNorm
    follows the module's train/eval mode.  Runs on ``cuda`` unless ``device``
    says otherwise; on this rank's block of ``mesh`` when one is given (the
    filter then takes this rank's B/D sequences, as ``shard_batch`` cuts
    them)."""

    def __init__(self, config: DPFConfig, device=None, mesh=None):
        super().__init__()
        check_supported(config)
        shards = axis_size(mesh, PARTICLE_AXIS)
        if config.num_particles % shards:
            raise ValueError(f"particle count {config.num_particles} not divisible by "
                             f"particle-axis size {shards}")
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            check_coupling_kernels(config)
        width = encoder_width(config)
        dtype = COMPUTE_DTYPES[config.compute_dtype]
        self.encoder = ObservationEncoder(width, dtype, config.torch_init, mesh)
        self.decoder = ObservationDecoder(width, dtype, config.torch_init, mesh)
        self.measurement = build_measurement_model(config, mesh)
        # registered last: the other modules' initial draws do not depend on
        # the flows being there
        stats = 2 * config.state_dim
        self.nf_dyn = realnvp_chain(config.n_sequence, config.state_dim,
                                    config.flow_hidden_dim, 0.01, ctx_dim=stats)
        self.cond_model = realnvp_chain(config.n_sequence, config.state_dim,
                                        config.flow_hidden_dim, 0.01,
                                        ctx_dim=stats + width)
        self.init(config.seed)
        self.to(self.device)

    def init(self, seed: int) -> None:
        """Re-initialise every parameter and BN statistic from ``seed``
        (flax's default initialisers, N(0, 0.01²) for the flows' conditioners;
        drawn on the CPU)."""
        flax_init_(self, torch.Generator().manual_seed(seed))

    def _resample(self, particles, probs, offset, potentials):
        """One firing of the configured resampler.  Returns (particles',
        probs', ancestor indices, Sinkhorn iterations, potentials): the
        iterations are the streaming loop's (0 on the other paths, as in
        the JAX package), the potentials the warm start's carry (None
        without it)."""
        cfg = self.config
        if cfg.resampler_type == "soft":
            return (*soft_systematic_resample(particles, probs, cfg.alpha, offset,
                                              mesh=self.mesh), 0, None)
        kw = dict(eps=cfg.epsilon, scaling=cfg.scaling, threshold=cfg.threshold,
                  max_iter=cfg.max_iter, convergence=cfg.sinkhorn_convergence)
        if not streaming_ot(cfg):
            return (*ot_resample(particles, probs, transport_grad=cfg.ot_transport_grad,
                                 mesh=self.mesh, **kw), 0, None)
        if axis_size(self.mesh, PARTICLE_AXIS) > 1:
            resample = functools.partial(ot_resample_streaming_sharded, mesh=self.mesh)
        else:
            resample = functools.partial(ot_resample_streaming, mesh=self.mesh)
        if not cfg.sinkhorn_warm_start:
            return (*resample(particles, probs, **kw), None)
        # the first firing finds the zeros the carry starts from, not valid
        return resample(particles, probs, warm_start=potentials,
                        warm_eps_factor=cfg.sinkhorn_warm_eps_factor, return_potentials=True,
                        **kw)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(..., H, W, 3) → (..., h); updates BN running stats in train mode."""
        return bracket_backward("nets.encoder", self.encoder, images)

    def decode(self, encodings: torch.Tensor) -> torch.Tensor:
        return bracket_backward("nets.decoder", self.decoder, encodings)

    def _step(self, gate: bool, particles, probs, vel, enc_t, normal, offset, warm,
              fused_dyn, fused_cond):
        """One time step, from the resample through the new weights: the
        region ``remat_scan_step`` recomputes in the backward, as
        ``jax.checkpoint(step)`` does.  Draws nothing: ``gate`` was read, and
        the motion draw ``normal`` and the soft resampler's ``offset`` were
        taken, before it, so a recomputation takes the same branch (and the
        same Sinkhorn iterations) on the same noise.  Returns (particles',
        probs', mean log-weight, noise, log-lik, ancestor indices (None
        without a firing), jacobian, prior, Sinkhorn iterations, warm-start
        potentials)."""
        cfg = self.config
        mesh = self.mesh
        if gate:
            particles, probs, idx, sk_iters, pots = bracket_backward(
                "resample", self._resample, particles, probs, offset, warm)
        else:
            idx, sk_iters, pots = None, 0, None
        log_probs_r = torch.log(probs)
        particles_phys, noise_t = motion_update(particles, vel, cfg.pos_noise, normal)
        particles_dyn, jac = nf_dynamic_model(
            self.nf_dyn, particles_phys, use_nf=cfg.nf_dyn, fused=fused_dyn, mesh=mesh)
        propose, lki_log, prior_log, propose_log = proposal_likelihood(
            self.cond_model, self.nf_dyn, self.measurement,
            particles_dyn, particles_phys, enc_t, noise_t, jac,
            cfg.nf_dyn, cfg.nf_cond, cfg.pos_noise, cfg.vel_noise,
            fused_dyn=fused_dyn, fused_cond=fused_cond, mesh=mesh)
        log_w = log_probs_r + lki_log + prior_log - propose_log
        new_probs = normalize_log_weights(log_w, mesh=mesh) + 1e-12
        mean_log_w = psum(batch_mean(log_w, mesh), mesh, PARTICLE_AXIS) / axis_size(
            mesh, PARTICLE_AXIS)
        return (propose, new_probs, mean_log_w, noise_t, lki_log, idx, jac, prior_log,
                sk_iters, pots)

    def _filter(self, encode_step, start_state, vel_seq, noise, generator) -> FilterOutput:
        """The T-step filter loop; ``encode_step(t)`` gives step t's (B, h)
        encoding."""
        cfg = self.config
        mesh = self.mesh
        batch, seq_len = vel_seq.shape[:2]
        n = cfg.num_particles // axis_size(mesh, PARTICLE_AXIS)         # this rank's
        global_batch = batch * axis_size(mesh, DATA_AXIS)
        dev = vel_seq.device
        noise = noise or {}

        def local(x, data_dim, particle_dim=None):
            """This rank's block of a global draw."""
            x = local_slice(x, mesh, DATA_AXIS, data_dim)
            return x if particle_dim is None else local_slice(x, mesh, PARTICLE_AXIS,
                                                              particle_dim)

        init_w_log = uniform_log_weights(batch, cfg.num_particles, dev)[:, :n]
        if "init" in noise:
            particles = local(noise["init"], 0, 1)
        else:
            # on a mesh the global draw around 0, then this block's start states
            start = start_state[:, :2] if mesh is None else torch.zeros((global_batch, 2),
                                                                       device=dev)
            particles, _ = particle_initialization(
                start, cfg.width, cfg.num_particles, cfg.state_dim,
                cfg.init_with_true_state, generator)
            particles = local(particles, 0, 1)
            if mesh is not None and cfg.init_with_true_state:
                particles = particles + start_state[:, None, :cfg.state_dim]
        probs = normalize_log_weights(init_w_log, mesh=mesh)
        vel = start_state[:, 2:]
        motion = noise.get("motion")
        offsets = noise.get("resample")
        warm = (torch.zeros((batch, 2, n), device=dev), False) if cfg.sinkhorn_warm_start \
            else None
        lo = axis_index(mesh, PARTICLE_AXIS) * n
        idx0 = (lo + torch.arange(n, dtype=torch.int32, device=dev)).expand(batch, n)
        obs_lik = torch.zeros((), device=dev)
        remat = cfg.remat_scan_step and torch.is_grad_enabled()

        # the fused coupling path: pack each used chain once, outside the
        # loop (gradients flow back through the pack)
        fused_dyn = fused_cond = None
        if cfg.pallas_coupling and cfg.state_dim == 2:
            if cfg.nf_dyn:
                fused_dyn = pack_chain_params(self.nf_dyn)
            if cfg.nf_cond:
                fused_cond = pack_chain_params(self.cond_model)

        hist = {k: [] for k in ("particles", "weights", "noise", "likelihoods",
                                "indices", "jacobians", "priors")}
        gates, iters = [], []
        for t in range(seq_len):
            with span("filter.step", t):
                enc_t = encode_step(t)
                with span("filter.gate"):
                    ess = effective_sample_size(probs, mesh)
                    # one device sync; on a mesh the ESS is all-reduced, so every
                    # rank reads the same gate
                    gate = bool(ess < cfg.ess_threshold * cfg.num_particles)
                # the draws, in the order the resampler and the motion take them
                offset = None
                if gate and cfg.resampler_type == "soft":
                    offset = local(offsets[t] if offsets is not None else torch.rand(
                        (global_batch, 1), generator=generator, device=dev)
                        * (1.0 / cfg.num_particles), 0)
                normal = local(motion[t] if motion is not None else torch.randn(
                    (global_batch, cfg.num_particles, particles.shape[-1]), generator=generator,
                    device=dev), 0, 1)
                args = (gate, particles, probs, vel, enc_t, normal, offset, warm, fused_dyn,
                        fused_cond)
                if remat:
                    # the step draws nothing, so no RNG state is stashed for it
                    step = checkpoint(self._step, *args, use_reentrant=False,
                                      preserve_rng_state=False)
                else:
                    step = self._step(*args)
                propose, new_probs, mean_log_w, noise_t, lki_log, idx, jac, prior_log, sk_iters, \
                    pots = step
                if gate and warm is not None:
                    warm = (pots, True)
                obs_lik = obs_lik + mean_log_w
                for k, v in zip(hist, (propose, new_probs, noise_t, lki_log,
                                       idx0 if idx is None else idx, jac, prior_log)):
                    hist[k].append(v)
                gates.append(gate)
                iters.append(sk_iters)
                particles, probs, vel = propose, new_probs, vel_seq[:, t]

        stacked = {k: torch.stack(v, dim=1) for k, v in hist.items()}
        return FilterOutput(
            **stacked,
            init_weights_log=init_w_log,
            obs_likelihood=obs_lik,
            resampled=torch.tensor(gates, dtype=torch.bool),
            sinkhorn_iters=torch.tensor(iters, dtype=torch.int32),
        )

    def filter_from_encodings(
        self,
        encodings: torch.Tensor,     # (B, T, h)
        start_state: torch.Tensor,   # (B, 4) pos + vel
        vel_seq: torch.Tensor,       # (B, T, 2) teacher-forced velocities
        noise: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
    ) -> FilterOutput:
        """Run the T-step filter loop on precomputed encodings."""
        return self._filter(lambda t: encodings[:, t], start_state, vel_seq, noise, generator)

    def filter_encoding_per_step(self, images, start_state, vel_seq, noise=None,
                                 generator=None):
        """The ``encode_per_step`` ablation (``nfdpf_tpu/models/dpf.py:366-383``):
        the encoder runs inside the time loop on step t's B frames, BN batch
        statistics over those frames and its running statistics updated step
        by step.  The encoder stays outside the region ``remat_scan_step``
        recomputes, so a recomputation never updates BN's buffers twice.
        Train mode only: in eval mode BN uses its running statistics, and
        ``filter``'s hoisted encode is the same function.

        images: (B, T, H, W, 3).  Returns (FilterOutput, encodings (B, T, h)).
        """
        if not self.training:
            raise ValueError("the per-step encode runs in train mode only; in eval mode "
                             "filter() encodes all frames at once, the same function")
        encodings = []

        def encode_step(t):
            encodings.append(self.encode(images[:, t]))
            return encodings[-1]

        out = self._filter(encode_step, start_state, vel_seq, noise, generator)
        return out, torch.stack(encodings, dim=1)

    def filter(self, images, start_state, vel_seq, noise=None, generator=None):
        """Encode all frames once, then run the filter; with
        ``encode_per_step`` in train mode, ``filter_encoding_per_step``.

        images: (B, T, H, W, 3).  Returns (FilterOutput, encodings (B, T, h)).
        """
        if self.config.encode_per_step and self.training:
            return self.filter_encoding_per_step(images, start_state, vel_seq, noise,
                                                 generator)
        b, t = images.shape[:2]
        encodings = self.encode(images.reshape((b * t,) + images.shape[2:]))
        encodings = encodings.reshape(b, t, -1)
        out = self.filter_from_encodings(encodings, start_state, vel_seq, noise,
                                         generator)
        return out, encodings
