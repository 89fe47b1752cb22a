"""Training harness: loss assembly, train and eval steps.

Counterpart of ``nfdpf_tpu/train.py:54-217``: total = 1·sup + 2·AE for the
DPF train type, plus 0.01·pseudo-likelihood for SDPF (the NF-prior variant
when ``nf_dyn`` is on, else the Gaussian one), with the
AE loss reusing the filter's encodings; the teacher-forced velocity gets
N(0, 4²) noise; Adam at a constant rate (torch's Adam defaults equal
optax's).  The parameters live in ``trainer.engine``, the optimizer state in
``trainer.optimizer``.

``noise`` (optional, for tests that replay another implementation's
randomness) is the filter's noise dict plus ``"vel"``, the (B, T, 2)
standard-normal velocity draw, and ``"mask"``, the (B, T) semi-supervised
mask of a train step.  What it leaves out is drawn from ``generator`` (on
the trainer's device).
"""

from __future__ import annotations

from typing import Optional

import torch

from nfdpf_torch import losses as L
from nfdpf_torch.config import DPFConfig
from nfdpf_torch.models.dpf import DPF

METRIC_KEYS = ("loss", "loss_sup", "loss_ae", "loss_pseudolik", "obs_likelihood",
               "resample_count", "sinkhorn_iters")


class Trainer:
    def __init__(self, config: DPFConfig, device=None):
        self.config = config
        self.engine = DPF(config, device)
        self.device = self.engine.device
        self.init_state(config.seed)

    def init_state(self, seed: int) -> None:
        """Re-initialise the parameters from ``seed`` and start a fresh Adam."""
        self.engine.init(seed)
        self.optimizer = torch.optim.Adam(self.engine.parameters(), lr=self.config.lr)

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the trainer's device, for the random draws of a step."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def _batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def _loss(self, batch: dict, train: bool, noise: Optional[dict] = None,
              generator: Optional[torch.Generator] = None):
        """Forward pass and losses.  BN follows ``train``.  Returns (total, aux)."""
        cfg = self.config
        engine = self.engine
        engine.train(train)
        batch = self._batch(batch)
        noise = noise or {}

        images = batch["image"]                       # (B, T, H, W, 3)
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) / 255.0
        state = batch["state"]                        # (B, T, 4)
        start_state = batch["start_state"]            # (B, 4)
        b, t = images.shape[:2]

        vel_normal = noise.get("vel")
        if vel_normal is None:
            vel_normal = torch.randn(state[..., 2:].shape, generator=generator,
                                     device=self.device)
        vel = state[..., 2:] + 4.0 * vel_normal

        out, encodings = engine.filter(images, start_state, vel, noise, generator)

        if train and "mask" in noise:
            mask = noise["mask"]
        elif train:
            mask = L.semi_supervised_mask(b, t, cfg.labeled_ratio, generator,
                                          self.device)
        else:
            mask = 1.0
        loss_sup, predictions = L.supervised_loss(
            out.particles, out.weights, state, mask, train, cfg.labeled_ratio)

        recon = engine.decode(encodings.reshape(b * t, -1))
        loss_ae = L.autoencoder_loss(images.reshape((b * t,) + images.shape[2:]), recon)
        loss_pl = torch.zeros((), device=self.device)
        if cfg.train_type == "SDPF":
            if cfg.nf_dyn:
                loss_pl = L.pseudolikelihood_loss_nf(
                    out.weights, out.noise, out.likelihoods, out.indices, out.jacobians,
                    out.priors, cfg.block_length)
            else:
                loss_pl = L.pseudolikelihood_loss(
                    out.weights, out.noise, out.likelihoods, out.indices, cfg.block_length,
                    cfg.pos_noise, cfg.vel_noise)
            total = 1.0 * loss_sup + 0.01 * loss_pl + 2.0 * loss_ae
        else:
            total = 1.0 * loss_sup + 2.0 * loss_ae

        aux = {
            "loss_sup": loss_sup,
            "loss_ae": loss_ae,
            "loss_pseudolik": loss_pl,
            "obs_likelihood": out.obs_likelihood,
            "resample_count": out.resampled.sum().item(),
            "sinkhorn_iters": out.sinkhorn_iters.sum().item(),
            "predictions": predictions,
            "filter_out": out,
        }
        return total, aux

    @staticmethod
    def _metrics(loss, aux) -> dict:
        metrics = {"loss": loss, **{k: aux[k] for k in METRIC_KEYS[1:]}}
        return {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}

    def train_step(self, batch: dict, noise: Optional[dict] = None,
                   generator: Optional[torch.Generator] = None) -> dict:
        """One optimizer step: forward, backward, Adam.  Returns the metrics."""
        loss, aux = self._loss(batch, True, noise, generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return self._metrics(loss, aux)

    @torch.no_grad()
    def eval_step(self, batch: dict, noise: Optional[dict] = None,
                  generator: Optional[torch.Generator] = None):
        """Forward in eval mode (BN running statistics).  Returns (metrics, aux)."""
        loss, aux = self._loss(batch, False, noise, generator)
        return self._metrics(loss, aux), aux
