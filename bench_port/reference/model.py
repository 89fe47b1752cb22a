"""The reference train step: encoder and decoder, the particle filter with
its OT resampler, the flows and the measurement, the losses and Adam.

Frozen copies of the port's plain versions (``nfdpf_torch/models/nets.py``,
``models/measurement.py``, ``models/dynamics.py``, ``ops/flows.py``,
``ops/density.py``, ``ops/sinkhorn.py``, ``losses.py``, ``train.py``),
without meshes, options this benchmark does not run, or kernels:

* the flows always run as ``FlowChain`` modules (the program may run them
  packed on its coupling kernels);
* OT resampling is the streaming driver's function on a cost matrix
  materialised once a firing, its logsumexps taken over row blocks, and
  the transport applied (and, in the backward, transposed) over row
  blocks that recompute the plan, so no (B, N, N) plan is kept for the
  backward;
* each time step after the resampler is recomputed in the backward
  (``torch.utils.checkpoint``), which changes no value: it bounds the
  memory of a reference that runs on the card after the program.

Module and parameter names are the program's, so one state dict loads
into both.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

ENC_CHANNELS = (3, 16, 32, 64, 128, 256)
# elements of one row block's temporaries in the OT loop (~1 GiB of float32)
BLOCK_ELEMENTS = 1 << 28


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------


class FlaxBatchNorm(nn.Module):
    """BatchNorm over dim 1 with flax's rule: biased variance E[x²] − E[x]²
    clipped at 0, momentum 0.1 on the running statistics, eps 1e-5."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.to(self.weight.dtype)
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            mean, mean2 = torch.mean(xf, dim=dims), torch.mean(xf * xf, dim=dims)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


class ObservationEncoder(nn.Module):
    """5x (Conv k4 s2 p1, ReLU, BN) 3->16->32->64->128->256, flatten NHWC,
    Linear.  (..., H, W, 3) -> (..., out)."""

    def __init__(self, out_features: int):
        super().__init__()
        pairs = list(zip(ENC_CHANNELS[:-1], ENC_CHANNELS[1:]))
        self.convs = nn.ModuleList(nn.Conv2d(ci, co, 4, stride=2, padding=1, bias=False)
                                   for ci, co in pairs)
        self.norms = nn.ModuleList(FlaxBatchNorm(co) for _, co in pairs)
        self.dense = nn.Linear(256 * 4 * 4, out_features)

    def forward(self, images):
        lead = images.shape[:-3]
        x = images.reshape((-1,) + images.shape[-3:]).permute(0, 3, 1, 2)
        for conv, norm in zip(self.convs, self.norms):
            x = norm(F.relu(F.conv2d(x, conv.weight, None, conv.stride, conv.padding)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense(x).reshape(lead + (-1,))


class ObservationDecoder(nn.Module):
    """Linear -> (4, 4, 256) -> 4x (ConvTranspose k4 s2, ReLU, BN) ->
    ConvTranspose to 3 channels -> BN -> sigmoid.  (..., in) -> (..., 128, 128, 3)."""

    def __init__(self, in_features: int):
        super().__init__()
        chans = ENC_CHANNELS[::-1]
        pairs = list(zip(chans[:-1], chans[1:]))
        self.dense = nn.Linear(in_features, 256 * 4 * 4)
        self.deconvs = nn.ModuleList(nn.ConvTranspose2d(ci, co, 4, stride=2, padding=1,
                                                        bias=False) for ci, co in pairs)
        self.norms = nn.ModuleList(FlaxBatchNorm(co) for _, co in pairs)

    def forward(self, z):
        lead = z.shape[:-1]
        x = self.dense(z.reshape(-1, z.shape[-1]))
        x = x.reshape(-1, 4, 4, 256).permute(0, 3, 1, 2)
        last = len(self.deconvs) - 1
        for k, (deconv, norm) in enumerate(zip(self.deconvs, self.norms)):
            x = F.conv_transpose2d(x, deconv.weight, None, deconv.stride, deconv.padding)
            x = norm(x if k == last else F.relu(x))
        x = torch.sigmoid(x).permute(0, 2, 3, 1)
        return x.reshape(lead + x.shape[1:])


class ParticleEncoder(nn.Module):
    """MLP state(d) -> 16 -> 32 -> out."""

    def __init__(self, out_features: int, state_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(state_dim, 16)
        self.fc2 = nn.Linear(16, 32)
        self.fc3 = nn.Linear(32, out_features)

    def forward(self, s):
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(s)))))


# ---------------------------------------------------------------------------
# flows
# ---------------------------------------------------------------------------


class FCNN(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.fc3 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x):
        return self.fc3(torch.tanh(self.fc2(torch.tanh(self.fc1(x)))))


class AffineCoupling(nn.Module):
    """RealNVP block: upper' = t1(lower‖ctx) + upper·exp(s1(lower‖ctx)),
    lower' = t2(upper'‖ctx) + lower·exp(s2(upper'‖ctx)); log-det Σs1 + Σs2."""

    def __init__(self, dim: int, hidden_dim: int, ctx_dim: int):
        super().__init__()
        self.dim = dim
        half = dim // 2
        self.t1 = FCNN(half + ctx_dim, dim - half, hidden_dim)
        self.s1 = FCNN(half + ctx_dim, dim - half, hidden_dim)
        self.t2 = FCNN(dim - half + ctx_dim, half, hidden_dim)
        self.s2 = FCNN(dim - half + ctx_dim, half, hidden_dim)

    def forward(self, x, ctx):
        half = self.dim // 2
        lower, upper = x[..., :half], x[..., half:]
        a = torch.cat([lower, ctx], dim=-1)
        t1, s1 = self.t1(a), self.s1(a)
        upper = t1 + upper * torch.exp(s1)
        b = torch.cat([upper, ctx], dim=-1)
        t2, s2 = self.t2(b), self.s2(b)
        lower = t2 + lower * torch.exp(s2)
        return torch.cat([lower, upper], dim=-1), torch.sum(s1, dim=-1) + torch.sum(s2, dim=-1)

    def inverse(self, z, ctx):
        half = self.dim // 2
        lower, upper = z[..., :half], z[..., half:]
        b = torch.cat([upper, ctx], dim=-1)
        t2, s2 = self.t2(b), self.s2(b)
        lower = (lower - t2) * torch.exp(-s2)
        a = torch.cat([lower, ctx], dim=-1)
        t1, s1 = self.t1(a), self.s1(a)
        upper = (upper - t1) * torch.exp(-s1)
        return torch.cat([lower, upper], dim=-1), -torch.sum(s1, dim=-1) - torch.sum(s2, dim=-1)


class FlowChain(nn.Module):
    """RealNVP blocks with an isotropic Gaussian prior N(0, prior_std²)."""

    def __init__(self, n_blocks: int, dim: int, hidden_dim: int, ctx_dim: int,
                 prior_std: float = 1.0):
        super().__init__()
        self.flows = nn.ModuleList(AffineCoupling(dim, hidden_dim, ctx_dim)
                                   for _ in range(n_blocks))
        self.prior_std = prior_std

    def forward(self, x, ctx):
        log_det = torch.zeros(x.shape[:-1], device=x.device, dtype=x.dtype)
        for flow in self.flows:
            x, ld = flow.forward(x, ctx)
            log_det = log_det + ld
        d = x.shape[-1]
        var = self.prior_std ** 2
        prior = (-0.5 * d * math.log(2 * math.pi) - 0.5 * d * math.log(var)
                 - 0.5 * torch.sum(x ** 2, dim=-1) / var)
        return x, prior, log_det

    def inverse(self, z, ctx):
        log_det = torch.zeros(z.shape[:-1], device=z.device, dtype=z.dtype)
        for flow in reversed(self.flows):
            z, ld = flow.inverse(z, ctx)
            log_det = log_det + ld
        return z, log_det


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def cosine_distance(a, b, eps: float = 1e-12):
    a = a / torch.clamp_min(torch.linalg.vector_norm(a, dim=-1, keepdim=True), eps)
    b = b / torch.clamp_min(torch.linalg.vector_norm(b, dim=-1, keepdim=True), eps)
    return 1.0 - torch.sum(a * b, dim=-1)


class CosineMeasurement(nn.Module):
    """log 1/(1e-7 + cos-distance(e_obs, e_state))."""

    def __init__(self, hidden_size: int, state_dim: int):
        super().__init__()
        self.particle_encoder = ParticleEncoder(hidden_size, state_dim)

    def forward(self, encodings, particles):
        e_state = self.particle_encoder(particles)
        return torch.log(1.0 / (1e-7 + cosine_distance(encodings[:, None, :], e_state)))


class CRNVPMeasurement(nn.Module):
    """Conditional-RealNVP density of e_obs given e_state, prior N(0, 2.5²),
    minus each row's maximum."""

    def __init__(self, hidden_size: int, n_sequence: int, flow_hidden_dim: int,
                 state_dim: int):
        super().__init__()
        self.particle_encoder = ParticleEncoder(hidden_size, state_dim)
        self.cnf = FlowChain(n_sequence, hidden_size, flow_hidden_dim, hidden_size,
                             prior_std=2.5)

    def forward(self, encodings, particles):
        e_state = self.particle_encoder(particles)
        e_obs = encodings[:, None, :].expand_as(e_state)
        _, log_prob_z, log_det = self.cnf(e_obs, e_state)
        lik = log_prob_z + log_det
        return lik - torch.amax(lik, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# densities
# ---------------------------------------------------------------------------


def normalize_log_weights(log_w):
    w = torch.exp(log_w - torch.amax(log_w, dim=-1, keepdim=True))
    return w / torch.sum(w, dim=-1, keepdim=True)


def log_normal_density(noise, std_pos: float, std_vel: float):
    d = noise.shape[-1]
    log_c = -0.5 * math.log(2.0 * math.pi)
    pos_term = -torch.sum(noise[..., :2] ** 2, dim=-1) / (2.0 * std_pos ** 2)
    vel_term = -torch.sum(noise[..., 2:] ** 2, dim=-1) / (2.0 * std_vel ** 2)
    const = d * log_c - 2.0 * math.log(std_pos) - (d - 2) * math.log(std_vel)
    return const + pos_term + vel_term


# ---------------------------------------------------------------------------
# OT resampling
# ---------------------------------------------------------------------------


def _pair_cost(x, y):
    """½‖x_i − y_j‖² from coordinate differences: (B, R, 2), (B, M, 2) -> (B, R, M)."""
    diff = x[:, :, None, :] - y[:, None, :, :]
    return 0.5 * torch.sum(diff * diff, dim=-1)


def _rows(b: int, g: int, n: int) -> int:
    return max(1, min(n, BLOCK_ELEMENTS // max(1, b * g * n)))


def diameter(x):
    res = torch.amax(torch.std(x, dim=1, correction=0), dim=-1)
    return torch.where(res == 0.0, torch.ones_like(res), res)


def max_min(x):
    max_max = torch.amax(x, dim=(1, 2))
    min_min = torch.minimum(torch.amin(torch.amax(x, dim=1), dim=-1), torch.amin(x, dim=(1, 2)))
    return max_max - min_min


class _Cost:
    """The (B, N, N) cost of one firing, and logsumexps over its rows."""

    def __init__(self, x):
        b, n, _ = x.shape
        rows = _rows(b, 2, n)
        self.rows = rows
        self.c = torch.empty((b, n, n), dtype=x.dtype, device=x.device)
        for r0 in range(0, n, rows):
            self.c[:, r0:r0 + rows] = _pair_cost(x[:, r0:r0 + rows], x)

    def lse(self, eps, fs):
        """out[b, g, i] = logsumexp_j(fs[b, g, j] − C_ij/ε_b): (B, G, N)."""
        b, g, n = fs.shape
        out = torch.empty_like(fs)
        rows = _rows(b, g, n)
        for r0 in range(0, n, rows):
            # z = fs − C/ε in one pass; the logsumexp is the row's maximum
            # plus −log_softmax at the maximum's entry, as accurate as
            # torch.logsumexp in about half the passes over z
            z = torch.addcdiv(fs[:, :, None, :], self.c[:, None, r0:r0 + rows],
                              eps[:, None, None, None], value=-1.0)
            top, at = z.max(dim=-1)
            out[:, :, r0:r0 + rows] = top - torch.log_softmax(z, dim=-1).gather(
                -1, at[..., None])[..., 0]
        return out


class _Apply(torch.autograd.Function):
    """T @ values with T_ij = exp(r_i + c_j − C_ij/ε), over row blocks that
    recompute T; differentiable in ``values`` only (the plan is a constant,
    as in the program's resampler)."""

    @staticmethod
    def forward(ctx, values, eps, x, r, c):
        ctx.save_for_backward(eps, x, r, c)
        b, n, _ = x.shape
        rows = _rows(b, 1, n)
        out = torch.empty((b, n, values.shape[-1]), dtype=values.dtype, device=values.device)
        for r0 in range(0, n, rows):
            t = torch.exp(r[:, r0:r0 + rows, None] + c[:, None, :]
                          - _pair_cost(x[:, r0:r0 + rows], x) / eps[:, None, None])
            out[:, r0:r0 + rows] = torch.einsum("bij,bjd->bid", t, values)
        return out

    @staticmethod
    def backward(ctx, g):
        eps, x, r, c = ctx.saved_tensors
        b, n, _ = x.shape
        rows = _rows(b, 1, n)
        grad = torch.zeros((b, n, g.shape[-1]), dtype=g.dtype, device=g.device)
        for r0 in range(0, n, rows):
            t = torch.exp(r[:, r0:r0 + rows, None] + c[:, None, :]
                          - _pair_cost(x[:, r0:r0 + rows], x) / eps[:, None, None])
            grad += torch.einsum("bij,bid->bjd", t, g[:, r0:r0 + rows])
        return grad, None, None, None, None


def ot_resample(particles, probs, eps: float, scaling: float, threshold: float,
                max_iter: int, convergence: str):
    """ε-annealed OT resampling (the program's streaming driver's function):
    returns (T @ particles, uniform weights, Sinkhorn iterations)."""
    b, n, d = particles.shape
    with torch.no_grad():
        x = particles.detach()
        logw = torch.log(probs.detach())
        centered = x - torch.mean(x, dim=1, keepdim=True)
        sx = centered / (diameter(x)[:, None, None] * math.sqrt(d))
        uniform = torch.full_like(logw, -math.log(n))
        eps_b = torch.full((b,), eps, dtype=torch.float32, device=x.device)
        scaling_factor = scaling ** 2
        cost = _Cost(sx)

        def sm2(e, fs):
            return -e[:, None, None] * cost.lse(e, fs)

        eps_run = max_min(sx) ** 2
        init = sm2(eps_run, torch.stack([logw, uniform], dim=1))
        a_y, b_x = init[:, 0], init[:, 1]
        running = torch.ones(b, dtype=torch.bool, device=x.device)
        agg = torch.all if convergence == "all" else torch.any
        i = 0
        while i < max_iter - 1:
            if not bool(agg(running)):
                break
            eps_col = eps_run[:, None]
            outs = sm2(eps_run, torch.stack([logw + b_x / eps_col, uniform + a_y / eps_col],
                                            dim=1))
            run = running[:, None]
            at_y = torch.where(run, outs[:, 0], a_y)
            bt_x = torch.where(run, outs[:, 1], b_x)
            a_y_new, b_x_new = (a_y + at_y) / 2, (b_x + bt_x) / 2
            a_diff = torch.amax(torch.abs(a_y_new - a_y), dim=1)
            b_diff = torch.amax(torch.abs(b_x_new - b_x), dim=1)
            local = (a_diff > threshold) | (b_diff > threshold)
            new_eps = torch.maximum(eps_run * scaling_factor, eps_b)
            running = (new_eps < eps_run) | local
            a_y, b_x, eps_run = a_y_new, b_x_new, new_eps
            i += 1
        finals = sm2(eps_b, torch.stack([logw + b_x / eps_b[:, None],
                                         uniform + a_y / eps_b[:, None]], dim=1))
        final_f, final_g = finals[:, 0], finals[:, 1]
        lse_col = cost.lse(eps_b, (final_f / eps_b[:, None])[:, None])[:, 0]
        del cost
        colnorm = final_g / eps_b[:, None] + lse_col
        r = final_f / eps_b[:, None]
        c = final_g / eps_b[:, None] - colnorm + math.log(n) + logw
    transported = _Apply.apply(particles, eps_b, sx, r, c)
    return transported, torch.full_like(probs, 1.0 / n), i


# ---------------------------------------------------------------------------
# the filter and the train step
# ---------------------------------------------------------------------------


class ReferenceDPF(nn.Module):
    """The model container, with the program's module names: ``encoder``,
    ``decoder``, ``measurement`` (cos or CRNVP) and the two RealNVP chains
    ``nf_dyn`` (context: particle mean‖std) and ``cond_model`` (context:
    encoding‖mean‖std)."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.measurement not in ("cos", "CRNVP") or cfg.train_type != "DPF" \
                or cfg.resampler_type != "ot" or cfg.encode_per_step or cfg.state_dim != 2:
            raise ValueError("the reference covers the DPF train type with the cos or CRNVP "
                             "measurement and OT resampling, state dim 2")
        self.cfg = cfg
        h = cfg.hidden_size
        self.encoder = ObservationEncoder(h)
        self.decoder = ObservationDecoder(h)
        if cfg.measurement == "cos":
            self.measurement = CosineMeasurement(h, cfg.state_dim)
        else:
            self.measurement = CRNVPMeasurement(h, cfg.n_sequence, cfg.flow_hidden_dim,
                                                cfg.state_dim)
        stats = 2 * cfg.state_dim
        self.nf_dyn = FlowChain(cfg.n_sequence, cfg.state_dim, cfg.flow_hidden_dim, stats)
        self.cond_model = FlowChain(cfg.n_sequence, cfg.state_dim, cfg.flow_hidden_dim,
                                    stats + h)

    @staticmethod
    def _context(particles, lead=None, mean=None, std=None):
        if mean is None:
            p = particles.detach()
            mean, std = torch.mean(p, dim=1, keepdim=True), torch.std(p, dim=1, keepdim=True)
        parts = [mean.detach(), std.detach()]
        if lead is not None:
            parts.insert(0, lead)
        ctx = torch.cat(parts, dim=-1)
        return ctx.expand(particles.shape[0], particles.shape[1], ctx.shape[-1])

    def _weights(self, particles, probs, vel, enc_t, normal):
        """One time step after the resampler: motion, flows, measurement,
        new weights.  Returns (proposed, new probs, mean log-weight)."""
        cfg = self.cfg
        log_probs = torch.log(probs)
        noise = cfg.pos_noise * normal
        phys = particles + vel[:, None, :] + noise
        if cfg.nf_dyn:
            dyn, ld = self.nf_dyn.inverse(phys, self._context(phys))
            jac = -ld
        else:
            dyn, jac = phys, torch.zeros(phys.shape[:2], device=phys.device)

        def density(x):
            return log_normal_density(x, cfg.pos_noise, cfg.vel_noise)

        if cfg.nf_cond:
            ctx = self._context(dyn, lead=enc_t.detach()[:, None, :])
            propose, ld = self.cond_model.inverse(dyn, ctx)
            jac_prop = -ld
            if cfg.nf_dyn:
                p = phys.detach()
                back, _, ld_back = self.nf_dyn.forward(
                    propose, self._context(propose, mean=torch.mean(p, dim=1, keepdim=True),
                                           std=torch.std(p, dim=1, keepdim=True)))
                prior = density(back - (phys - noise)) + ld_back
            else:
                prior = density(propose - (phys - noise))
            propose_log = density(noise) + jac + jac_prop
        else:
            propose = dyn
            prior = density(noise) + jac
            propose_log = prior
        lki = self.measurement(enc_t, propose)
        log_w = log_probs + lki + prior - propose_log
        return propose, normalize_log_weights(log_w) + 1e-12, torch.mean(log_w)

    def filter(self, encodings, start_state, vel_seq, draws):
        """The T-step filter.  Returns (particles (B, T, N, 2), weights
        (B, T, N), firings, Sinkhorn iterations)."""
        cfg = self.cfg
        b, t = vel_seq.shape[:2]
        n = cfg.num_particles
        particles = draws["init"]
        probs = normalize_log_weights(torch.full((b, n), -math.log(n), device=particles.device))
        vel = start_state[:, 2:]
        hist_p, hist_w, firings, iters = [], [], 0, 0
        for step in range(t):
            ess = torch.mean(1.0 / torch.sum(probs ** 2, dim=-1))
            if bool(ess < cfg.ess_threshold * n):
                particles, probs, k = ot_resample(
                    particles, probs, cfg.epsilon, cfg.scaling, cfg.threshold, cfg.max_iter,
                    cfg.sinkhorn_convergence)
                firings += 1
                iters += k
            particles, probs, _ = checkpoint(self._weights, particles, probs, vel,
                                             encodings[:, step], draws["motion"][step],
                                             use_reentrant=False, preserve_rng_state=False)
            hist_p.append(particles)
            hist_w.append(probs)
            vel = vel_seq[:, step]
        return torch.stack(hist_p, dim=1), torch.stack(hist_w, dim=1), firings, iters

    def loss(self, batch, draws):
        """The DPF train type's loss: supervised RMSE of the weighted mean
        plus twice the AE's MSE.  Returns (loss, firings, iterations, (the
        supervised loss, the AE loss))."""
        self.train(True)
        images = batch["image"]
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) / 255.0
        state, start_state = batch["state"], batch["start_state"]
        b, t = images.shape[:2]
        vel = state[..., 2:] + 4.0 * draws["vel"]
        frames = images.reshape((b * t,) + images.shape[2:])
        encodings = self.encoder(frames).reshape(b, t, -1)
        particles, weights, firings, iters = self.filter(encodings, start_state, vel, draws)
        prediction = torch.sum(particles * weights[..., None], dim=-2)
        err2 = (prediction - state[..., :2]) ** 2
        mask = draws["mask"][..., None]
        loss_sup = torch.sqrt(torch.mean(mask * err2) / self.cfg.labeled_ratio)
        recon = self.decoder(encodings.reshape(b * t, -1))
        loss_ae = torch.mean((recon - frames) ** 2)
        return 1.0 * loss_sup + 2.0 * loss_ae, firings, iters, (loss_sup, loss_ae)


class Adam:
    """torch's Adam at its defaults (β 0.9, 0.999; ε 1e-8; no decay), one
    tensor at a time; a parameter without a gradient is left as it is."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.state = {}

    @torch.no_grad()
    def step(self):
        b1, b2 = self.betas
        for p in self.params:
            if p.grad is None:
                continue
            st = self.state.setdefault(p, {"step": 0, "m": torch.zeros_like(p),
                                           "v": torch.zeros_like(p)})
            st["step"] += 1
            st["m"].lerp_(p.grad, 1 - b1)
            st["v"].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
            bc1 = 1 - b1 ** st["step"]
            bc2 = 1 - b2 ** st["step"]
            denom = (st["v"].sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(st["m"], denom, value=-self.lr / bc1)


def follow(cfg, state: dict, steps, device) -> dict:
    """Run the reference's train steps from the state dict ``state``:
    ``steps`` is a list of (batch, draws).  Returns the loss of each step,
    each leaf's gradient at the first step, the parameters after the last,
    and the firings and Sinkhorn iterations of each step.  Computes in
    float32 with TF32 off, and puts the switches back after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = ReferenceDPF(cfg).to(device)
        model.load_state_dict(state)
        opt = Adam(model.parameters(), cfg.lr)
        out = {"loss": [], "loss_sup": [], "loss_ae": [], "firings": [], "iters": [],
               "grad": None, "params": None}
        for k, (batch, draws) in enumerate(steps):
            for p in model.parameters():
                p.grad = None
            loss, firings, iters, (loss_sup, loss_ae) = model.loss(batch, draws)
            out["loss_sup"].append(float(loss_sup.detach()))
            out["loss_ae"].append(float(loss_ae.detach()))
            loss.backward()
            if k == 0:
                out["grad"] = {name: p.grad.detach().clone()
                               for name, p in model.named_parameters() if p.grad is not None}
            opt.step()
            out["loss"].append(float(loss.detach()))
            out["firings"].append(firings)
            out["iters"].append(iters)
        out["params"] = {name: p.detach().clone() for name, p in model.named_parameters()}
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
