"""Training harness: loss assembly, train, eval and AE steps, the epoch
loops, testing and checkpoints.

Counterpart of ``nfdpf_tpu/train.py``: total = 1·sup + 2·AE for the
DPF train type, plus 0.01·pseudo-likelihood for SDPF (the NF-prior variant
when ``nf_dyn`` is on, else the Gaussian one), with the
AE loss reusing the filter's encodings (under ``encode_per_step`` in
training, a second full-frame encode's); the teacher-forced velocity gets
N(0, 4²) noise; Adam at a constant rate (torch's Adam defaults equal
optax's).  The parameters live in ``trainer.engine``, the optimizer state in
``trainer.optimizer``, the count of finished epochs in ``trainer.epoch``.

``noise`` (optional, for tests that replay another implementation's
randomness) is the filter's noise dict plus ``"vel"``, the (B, T, 2)
standard-normal velocity draw, and ``"mask"``, the (B, T) semi-supervised
mask of a train step.  What it leaves out is drawn from ``generator`` (on
the trainer's device).  The loops (``fit``, ``fit_fused``, ``test``) draw
from one generator seeded with their ``seed``, or take ``noise``: an
iterable giving the noise dict of each step in the order the loop runs
them (per epoch its train steps, then its eval steps).

Artifacts keep the JAX package's names and keys: ``data/eval_loss_epoch.npy``,
``data/eval_result_best.npz``, ``models/best`` (a checkpoint directory),
``data/test_loss_epoch.npy``, ``data/test_result.npz`` and the plots.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import numpy as np
import torch

from nfdpf_torch import losses as L
from nfdpf_torch.config import DPFConfig
from nfdpf_torch.models.dpf import DPF
from nfdpf_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from nfdpf_torch.utils.metrics import MetricsLogger

METRIC_KEYS = ("loss", "loss_sup", "loss_ae", "loss_pseudolik", "obs_likelihood",
               "resample_count", "sinkhorn_iters")
BATCH_KEYS = ("image", "state", "start_state")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _floats(values) -> np.ndarray:
    """Per-step scalar tensors as one float32 host array (one copy)."""
    return torch.stack(values).cpu().numpy() if values else np.zeros(0, np.float32)


class Trainer:
    def __init__(self, config: DPFConfig, device=None):
        self.config = config
        self.engine = DPF(config, device)
        self.device = self.engine.device
        self.init_state(config.seed)

    def init_state(self, seed: int) -> None:
        """Re-initialise the parameters from ``seed``, start a fresh Adam and
        the epoch count at 0."""
        self.engine.init(seed)
        self.optimizer = torch.optim.Adam(self.engine.parameters(), lr=self.config.lr)
        self.epoch = 0

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the trainer's device, for the random draws of a step."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def _batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(batch[k], device=self.device) for k in BATCH_KEYS}

    def _frames(self, images) -> torch.Tensor:
        """(B, T, H, W, 3) frames, uint8 or float, as (B·T, H, W, 3) float32
        on the trainer's device."""
        images = torch.as_tensor(images, device=self.device)
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) / 255.0
        return images.reshape((-1,) + images.shape[2:])

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

        frames = images.reshape((b * t,) + images.shape[2:])
        if cfg.encode_per_step and train:
            # the ablation's AE path, as the reference computes it: a second
            # full-frame encode (BN statistics over all B·T frames, its running
            # update on top of the filter's T per-step ones) feeds the decoder
            ae_enc = engine.encode(frames)
        else:
            ae_enc = encodings.reshape(b * t, -1)
        recon = engine.decode(ae_enc)
        loss_ae = L.autoencoder_loss(frames, recon)
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

    def ae_step(self, images) -> torch.Tensor:
        """One AE-pretraining step: MSE(decode(encode(x)), x) over the frames
        ``images`` ((B, T, H, W, 3)), BN in train mode, then Adam over the
        whole model, as the JAX step applies optax to every parameter: a
        parameter the AE does not reach gets a zero gradient, so its moments
        and its step count advance as optax's do.  Returns the loss."""
        engine = self.engine
        engine.train(True)
        frames = self._frames(images)
        loss = L.autoencoder_loss(frames, engine.decode(engine.encode(frames)))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in engine.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def ae_eval(self, images):
        """(MSE, reconstructions) of the AE in eval mode (BN running
        statistics) over the frames ``images`` ((B, T, H, W, 3))."""
        self.engine.eval()
        frames = self._frames(images)
        recon = self.engine.decode(self.engine.encode(frames))
        return L.autoencoder_loss(frames, recon), recon

    # ------------------------------------------------------------------
    # epoch loops
    # ------------------------------------------------------------------

    def _draws(self, seed: int, noise):
        """The keyword arguments of each step of a loop: the next noise dict
        of ``noise`` (if given) and one generator seeded with ``seed``."""
        generator = self.generator(seed)
        it = None if noise is None else iter(noise)
        return lambda: {"noise": None if it is None else next(it), "generator": generator}

    def _validate(self, batches, draw):
        """Eval steps over ``batches``: (float32 losses, (aux, batch) of the last)."""
        losses, last = [], None
        for batch in batches:
            m, aux = self.eval_step(batch, **draw())
            losses.append(m["loss_sup"])
            last = (aux, batch)
        return _floats(losses), last

    def fit(self, train_batches, valid_batches, run_dir: str,
            num_epochs: Optional[int] = None, logger: Optional[MetricsLogger] = None,
            seed: int = 0, noise=None) -> None:
        """Train from ``self.epoch`` to ``num_epochs``: each epoch the train
        steps over ``train_batches(epoch)``, then the eval steps over
        ``valid_batches()``; the eval histories and ``models/best`` of the
        best eval epoch of this call."""
        num_epochs = num_epochs or self.config.num_epochs
        for sub in ("models", "data"):
            os.makedirs(os.path.join(run_dir, sub), exist_ok=True)
        if logger is None:
            with contextlib.closing(MetricsLogger(os.path.join(run_dir, "logger"))) as own:
                return self.fit(train_batches, valid_batches, run_dir, num_epochs, own, seed,
                                noise)
        draw = self._draws(seed, noise)
        best_eval, eval_loss_epoch = float("inf"), []
        for epoch in range(self.epoch, num_epochs):
            sups = [self.train_step(batch, **draw())["loss_sup"]
                    for batch in train_batches(epoch)]
            mean_sup = float(np.mean(_floats(sups)))
            logger.scalar("Sup_loss/loss", mean_sup, epoch)
            eval_losses, last = self._validate(valid_batches(), draw)
            mean_eval = float(np.mean(eval_losses))
            logger.scalar("Sup_loss_eval/loss", mean_eval, epoch)
            eval_loss_epoch.append(mean_eval)
            np.save(os.path.join(run_dir, "data", "eval_loss_epoch.npy"),
                    np.asarray(eval_loss_epoch))
            print(f"epoch {epoch}: train_sup={mean_sup:.4f} eval_sup={mean_eval:.4f}")
            self.epoch = epoch + 1
            if mean_eval < best_eval and last is not None:
                best_eval = mean_eval
                aux, batch = last
                out = aux["filter_out"]
                np.savez(
                    os.path.join(run_dir, "data", "eval_result_best.npz"),
                    particle_list=_host(out.particles),
                    particle_weight_list=_host(out.weights),
                    likelihood_list=_host(out.likelihoods),
                    pred=_host(aux["predictions"]),
                    state=_host(batch["state"]),
                    loss=eval_losses,
                )
                self.save(os.path.join(run_dir, "models", "best"))

    def fit_fused(self, train_ds, val_ds, run_dir: str, num_epochs: Optional[int] = None,
                  logger: Optional[MetricsLogger] = None, seed: int = 0, noise=None) -> None:
        """``fit`` with the datasets staged on the device once (uint8 frames,
        normalised on the device) and each step's batch gathered there, in
        the JAX package's order: each epoch a permutation from one
        ``np.random.default_rng(seed)``, whole batches only; eval batches of
        min(50, n_val) in order."""
        bs = self.config.batch_size
        train_dev, val_dev = ({k: torch.as_tensor(ds.data[k]).to(self.device)
                               for k in BATCH_KEYS} for ds in (train_ds, val_ds))
        n_train = train_dev["image"].shape[0]
        n_val = val_dev["image"].shape[0]
        steps = n_train // bs
        if steps < 1:
            raise ValueError(
                f"dataset ({n_train} sequences) smaller than the batch size "
                f"({bs}); the fused epoch would run zero steps")
        eval_bs = min(50, n_val)
        rng = np.random.default_rng(seed)

        def train_batches(epoch):
            order = rng.permutation(n_train)[: steps * bs]      # drawn once per epoch
            idx = torch.as_tensor(order.reshape(steps, bs), device=self.device)
            return ({k: v[ids] for k, v in train_dev.items()} for ids in idx)

        def valid_batches():
            return ({k: v[lo:lo + eval_bs] for k, v in val_dev.items()}
                    for lo in range(0, n_val - eval_bs + 1, eval_bs))

        self.fit(train_batches, valid_batches, run_dir, num_epochs, logger, seed, noise)

    def pretrain_ae(self, train_batches, num_epochs: int = 300, valid_batches=None,
                    ckpt_path: Optional[str] = None, logger: Optional[MetricsLogger] = None,
                    run_dir: Optional[str] = None, plots: bool = True) -> None:
        """AE-only pretraining: per epoch the AE steps over
        ``train_batches(epoch)`` and the eval MSE over ``valid_batches()``;
        the best epoch's parameters and BN statistics are saved to
        ``ckpt_path`` and loaded back at the end (the optimizer state stays
        the last epoch's, as in the JAX package).  With ``run_dir`` and
        ``plots``, a reconstruction grid of the first val batch each epoch
        (``data/ae_recon_epoch<NNN>.png``; raises without matplotlib)."""
        best_val, best = float("inf"), None
        for epoch in range(num_epochs):
            train_mean = float(np.mean(_floats(
                [self.ae_step(b["image"]) for b in train_batches(epoch)])))
            val_mean = train_mean
            if valid_batches is not None:
                val_mean = float(np.mean(_floats(
                    [self.ae_eval(b["image"])[0] for b in valid_batches()])))
                if logger is not None:
                    logger.scalar("PretrainAE_loss_eval/loss", val_mean, epoch)
                if run_dir is not None and plots:
                    from nfdpf_torch.viz import plot_obs

                    first = next(iter(valid_batches()))
                    _, recon = self.ae_eval(first["image"])
                    lead = tuple(first["image"].shape[:2])
                    os.makedirs(os.path.join(run_dir, "data"), exist_ok=True)
                    plot_obs(_host(self._frames(first["image"])).reshape(lead + recon.shape[1:]),
                             _host(recon).reshape(lead + recon.shape[1:]),
                             os.path.join(run_dir, "data", f"ae_recon_epoch{epoch:03d}.png"))
            print(f"AE pretrain epoch {epoch}: train {train_mean:.5f} val {val_mean:.5f}")
            if val_mean < best_val:
                best_val = val_mean
                best = {k: v.detach().clone() for k, v in self.engine.state_dict().items()}
                if ckpt_path is not None:
                    save_checkpoint(ckpt_path, {"model": best})
        if best is not None:
            self.engine.load_state_dict(best)

    def test(self, test_batches, run_dir: str, seed: int = 0, noise=None,
             plots: bool = True) -> float:
        """One eval pass over ``test_batches()``: the losses, the last
        batch's histories and, with ``plots``, the trajectory, ESS and
        tracking plots of its first sequence (raises without matplotlib).
        Returns the mean loss."""
        draw = self._draws(seed, noise)
        losses, last = self._validate(test_batches(), draw)
        data_dir = os.path.join(run_dir, "data")
        os.makedirs(data_dir, exist_ok=True)
        np.save(os.path.join(data_dir, "test_loss_epoch.npy"), losses)
        if last is not None:
            aux, batch = last
            out = aux["filter_out"]
            np.savez(
                os.path.join(data_dir, "test_result.npz"),
                particle_list=_host(out.particles),
                particle_weight_list=_host(out.weights),
                likelihood_list=_host(out.likelihoods),
                state=_host(batch["state"]),
                pred=_host(aux["predictions"]),
                images=_host(batch["image"]),
                noise=_host(out.noise),
            )
            if plots:
                self._test_plots(aux, batch, data_dir)
        mean_loss = float(np.mean(losses))
        print(f"test loss: {mean_loss:.4f}")
        return mean_loss

    def _test_plots(self, aux, batch, data_dir: str) -> None:
        from nfdpf_torch import viz

        out = aux["filter_out"]
        images = _host(batch["image"][0])
        if images.dtype == np.uint8:
            images = images.astype(np.float32) / 255.0
        true_state = _host(batch["state"][0])               # (T, 4)
        pred = _host(aux["predictions"][0])                 # (T, 2)
        width = self.config.width
        viz.plot_state_tracking(true_state, pred, os.path.join(data_dir, "test_trajectory.png"),
                                width=width)
        viz.plot_ess_tracking(_host(out.weights), os.path.join(data_dir, "test_ess.png"))
        viz.plot_obs_tracking(images, _host(out.particles[0])[..., :2], _host(out.weights[0]),
                              true_state, pred, os.path.join(data_dir, "tracking"), width=width)

    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint the parameters and BN statistics, the optimizer state
        and the epoch count into the directory ``path``."""
        save_checkpoint(path, {"model": self.engine.state_dict(),
                               "optimizer": self.optimizer.state_dict(),
                               "epoch": self.epoch})

    def load(self, path: str) -> None:
        """Restore what ``save`` wrote: training goes on from its epoch with
        its Adam state."""
        tree = restore_checkpoint(path, map_location=self.device)
        self.engine.load_state_dict(tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        self.epoch = int(tree["epoch"])

    def load_model(self, path: str) -> None:
        """Load the parameters and BN statistics of a checkpoint (``save``'s
        or ``pretrain_ae``'s) and nothing else."""
        self.engine.load_state_dict(restore_checkpoint(path, map_location=self.device)["model"])
