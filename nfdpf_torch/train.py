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

On a ``mesh`` (``parallel/mesh.py``) every rank runs the same calls with the
same GLOBAL batches and noise; each takes its block (``shard_batch``, the
filter's own slicing of the draws), computes the global losses, and
``train_step`` averages the parameter gradients over the mesh before Adam,
so parameters and optimizer state stay replicated.  ``fit_fused`` stages
each data rank's share of the (trimmed) datasets only.  Artifacts, prints
and checkpoints come from the primary rank, the artifacts gathered from
every rank.
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
from nfdpf_torch.parallel.distributed import is_primary, say
from nfdpf_torch.parallel.mesh import (
    DATA_AXIS,
    PARTICLE_AXIS,
    all_gather,
    average_gradients,
    axis_index,
    axis_size,
    local_slice,
    replicate,
    shard_batch,
)
from nfdpf_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from nfdpf_torch.utils.metrics import MetricsLogger
from nfdpf_torch.utils.profiling import span

METRIC_KEYS = ("loss", "loss_sup", "loss_ae", "loss_pseudolik", "obs_likelihood",
               "resample_count", "sinkhorn_iters")
BATCH_KEYS = ("image", "state", "start_state")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _floats(values) -> np.ndarray:
    """Per-step scalar tensors as one float32 host array (one copy)."""
    return torch.stack(values).cpu().numpy() if values else np.zeros(0, np.float32)


class Trainer:
    def __init__(self, config: DPFConfig, device=None, mesh=None):
        self.config = config
        self.mesh = mesh
        self.engine = DPF(config, device, mesh)
        self.device = self.engine.device
        self.init_state(config.seed)

    def init_state(self, seed: int) -> None:
        """Re-initialise the parameters from ``seed`` (then broadcast from
        the mesh's first rank), start a fresh Adam and the epoch and step
        counts at 0."""
        self.engine.init(seed)
        replicate(self.engine, self.mesh)
        self.optimizer = torch.optim.Adam(self.engine.parameters(), lr=self.config.lr)
        self.epoch = 0
        self.steps = 0

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the trainer's device, for the random draws of a step."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def _local(self, x, dim: int = 0) -> torch.Tensor:
        """This data rank's block of a global batch-major array or tensor, on
        the trainer's device (sliced before it is moved)."""
        return local_slice(torch.as_tensor(x), self.mesh, DATA_AXIS, dim).to(self.device)

    def _batch(self, batch: dict) -> dict:
        local = shard_batch({k: torch.as_tensor(batch[k]) for k in BATCH_KEYS}, self.mesh)
        return {k: v.to(self.device) for k, v in local.items()}

    def _frames(self, images) -> torch.Tensor:
        """(B, T, H, W, 3) frames of a global batch, uint8 or float, as this
        data rank's (B·T, H, W, 3) float32 on the trainer's device."""
        images = self._local(images)
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) / 255.0
        return images.reshape((-1,) + images.shape[2:])

    def _loss(self, batch: dict, train: bool, noise: Optional[dict] = None,
              generator: Optional[torch.Generator] = None):
        """Forward pass and losses.  BN follows ``train``.  Returns (total, aux)."""
        cfg = self.config
        engine = self.engine
        mesh = self.mesh
        engine.train(train)
        batch = self._batch(batch)
        noise = noise or {}
        shards = axis_size(mesh, DATA_AXIS)

        images = batch["image"]                       # (B, T, H, W, 3)
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) / 255.0
        state = batch["state"]                        # (B, T, 4)
        start_state = batch["start_state"]            # (B, 4)
        b, t = images.shape[:2]

        vel_normal = noise.get("vel")
        if vel_normal is None:
            vel_normal = torch.randn((b * shards, t, 2), generator=generator,
                                     device=self.device)
        vel = state[..., 2:] + 4.0 * self._local(vel_normal)

        out, encodings = engine.filter(images, start_state, vel, noise, generator)
        with span("losses"):
            if train and "mask" in noise:
                mask = self._local(noise["mask"])
            elif train:
                mask = self._local(L.semi_supervised_mask(b * shards, t, cfg.labeled_ratio,
                                                          generator, self.device))
            else:
                mask = 1.0
            loss_sup, predictions = L.supervised_loss(
                out.particles, out.weights, state, mask, train, cfg.labeled_ratio, mesh)

            frames = images.reshape((b * t,) + images.shape[2:])
            if cfg.encode_per_step and train:
                # the ablation's AE path, as the reference computes it: a second
                # full-frame encode (BN statistics over all B·T frames, its running
                # update on top of the filter's T per-step ones) feeds the decoder
                ae_enc = engine.encode(frames)
            else:
                ae_enc = encodings.reshape(b * t, -1)
            recon = engine.decode(ae_enc)
            loss_ae = L.autoencoder_loss(frames, recon, mesh)
            loss_pl = torch.zeros((), device=self.device)
            if cfg.train_type == "SDPF":
                if cfg.nf_dyn:
                    loss_pl = L.pseudolikelihood_loss_nf(
                        out.weights, out.noise, out.likelihoods, out.indices, out.jacobians,
                        out.priors, cfg.block_length, mesh)
                else:
                    loss_pl = L.pseudolikelihood_loss(
                        out.weights, out.noise, out.likelihoods, out.indices, cfg.block_length,
                        cfg.pos_noise, cfg.vel_noise, mesh)
                total = 1.0 * loss_sup + 0.01 * loss_pl + 2.0 * loss_ae
            else:
                total = 1.0 * loss_sup + 2.0 * loss_ae

        aux = {
            "loss_sup": loss_sup,
            "loss_ae": loss_ae,
            "loss_pseudolik": loss_pl,
            "obs_likelihood": out.obs_likelihood,
            # CPU tensors made from host lists: no device sync
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
        """One optimizer step: forward, backward, the gradients averaged over
        the mesh, Adam.  Returns the metrics."""
        self.steps += 1
        with span("train_step", self.steps):
            with span("loss"):
                loss, aux = self._loss(batch, True, noise, generator)
            self.optimizer.zero_grad(set_to_none=True)
            with span("backward"):
                loss.backward()
            with span("optimizer"):
                average_gradients(self.engine.parameters(), self.mesh)
                self.optimizer.step()
            return self._metrics(loss, aux)

    @torch.no_grad()
    def eval_step(self, batch: dict, noise: Optional[dict] = None,
                  generator: Optional[torch.Generator] = None):
        """Forward in eval mode (BN running statistics).  Returns (metrics, aux)."""
        with span("eval_step"):
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
        loss = L.autoencoder_loss(frames, engine.decode(engine.encode(frames)), self.mesh)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in engine.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        average_gradients(engine.parameters(), self.mesh)
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def ae_eval(self, images):
        """(MSE, reconstructions) of the AE in eval mode (BN running
        statistics) over the frames ``images`` ((B, T, H, W, 3))."""
        self.engine.eval()
        frames = self._frames(images)
        recon = self.engine.decode(self.engine.encode(frames))
        return L.autoencoder_loss(frames, recon, self.mesh), recon

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

    @torch.no_grad()
    def _gathered(self, aux) -> dict:
        """The eval histories of every rank, whole, on the host: particles,
        weights, likelihoods and noise (B, T, N, ...), predictions (B, T, 2)."""
        def whole(x, particle_dim=None):
            if particle_dim is not None:
                x = all_gather(x, self.mesh, PARTICLE_AXIS, particle_dim)
            return _host(all_gather(x, self.mesh, DATA_AXIS, 0))

        out = aux["filter_out"]
        return {"particles": whole(out.particles, 2), "weights": whole(out.weights, 2),
                "likelihoods": whole(out.likelihoods, 2), "noise": whole(out.noise, 2),
                "pred": whole(aux["predictions"])}

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
            if is_primary():
                np.save(os.path.join(run_dir, "data", "eval_loss_epoch.npy"),
                        np.asarray(eval_loss_epoch))
            say(f"epoch {epoch}: train_sup={mean_sup:.4f} eval_sup={mean_eval:.4f}")
            self.epoch = epoch + 1
            if mean_eval < best_eval and last is not None:
                best_eval = mean_eval
                aux, batch = last
                hist = self._gathered(aux)
                if is_primary():
                    np.savez(
                        os.path.join(run_dir, "data", "eval_result_best.npz"),
                        particle_list=hist["particles"],
                        particle_weight_list=hist["weights"],
                        likelihood_list=hist["likelihoods"],
                        pred=hist["pred"],
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
        min(50, n_val) in order.

        On a mesh with D data ranks the datasets are trimmed to a multiple of
        D and each data rank stages its contiguous 1/D of them; a step's
        global batch is put together on every data rank from the rows each
        holds with one all-reduce over the data group (the others add
        zeros), and each rank then keeps its 1/D of it.  Each rank so
        receives D times the rows it uses, where JAX's sharded gather moves
        each device only its own rows."""
        bs = self.config.batch_size
        shards = axis_size(self.mesh, DATA_AXIS)
        staged = [self._stage(ds) for ds in (train_ds, val_ds)]
        (train_dev, n_train), (val_dev, n_val) = staged
        steps = n_train // bs
        if steps < 1:
            raise ValueError(
                f"dataset ({n_train} sequences) smaller than the batch size "
                f"({bs}); the fused epoch would run zero steps")
        if n_val < 1:
            raise ValueError(f"validation set ({val_ds.data['image'].shape[0]} sequences) "
                             f"smaller than the data axis ({shards})")
        eval_bs = min(50, n_val) // shards * shards
        rng = np.random.default_rng(seed)

        def train_batches(epoch):
            order = rng.permutation(n_train)[: steps * bs]      # drawn once per epoch
            idx = torch.as_tensor(order.reshape(steps, bs), device=self.device)
            return (self._rows(train_dev, n_train, ids) for ids in idx)

        def valid_batches():
            return (self._rows(val_dev, n_val, torch.arange(lo, lo + eval_bs,
                                                            device=self.device))
                    for lo in range(0, n_val - eval_bs + 1, eval_bs))

        self.fit(train_batches, valid_batches, run_dir, num_epochs, logger, seed, noise)

    def _stage(self, ds):
        """This data rank's block of ``ds``'s sequences (all of them trimmed
        to a multiple of the data axis) on the device, and the trimmed count."""
        shards = axis_size(self.mesh, DATA_AXIS)
        n = ds.data["image"].shape[0] // shards * shards
        block = n // shards
        lo = axis_index(self.mesh, DATA_AXIS) * block
        return {k: torch.as_tensor(ds.data[k][lo:lo + block]).to(self.device)
                for k in BATCH_KEYS}, n

    def _rows(self, staged: dict, n: int, ids: torch.Tensor) -> dict:
        """The global batch of the rows ``ids`` (of ``n`` staged over the data
        ranks) on every rank: each rank fills in the rows it holds, zeros
        elsewhere, and the data group sums them."""
        if axis_size(self.mesh, DATA_AXIS) == 1:
            return {k: v[ids] for k, v in staged.items()}
        block = n // axis_size(self.mesh, DATA_AXIS)
        lo = axis_index(self.mesh, DATA_AXIS) * block
        mine = (ids >= lo) & (ids < lo + block)
        local = torch.where(mine, ids - lo, 0)
        out = {}
        for k, v in staged.items():
            rows = v[local] * mine.reshape((-1,) + (1,) * (v.dim() - 1)).to(v.dtype)
            torch.distributed.all_reduce(rows, group=self.mesh.data_group)
            out[k] = rows
        return out

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
                if run_dir is not None and plots and is_primary():
                    from nfdpf_torch.viz import plot_obs

                    first = next(iter(valid_batches()))
                    _, recon = self.ae_eval(first["image"])
                    lead = tuple(first["image"].shape[:2])
                    os.makedirs(os.path.join(run_dir, "data"), exist_ok=True)
                    plot_obs(_host(self._frames(first["image"])).reshape(lead + recon.shape[1:]),
                             _host(recon).reshape(lead + recon.shape[1:]),
                             os.path.join(run_dir, "data", f"ae_recon_epoch{epoch:03d}.png"))
            say(f"AE pretrain epoch {epoch}: train {train_mean:.5f} val {val_mean:.5f}")
            if val_mean < best_val:
                best_val = val_mean
                best = {k: v.detach().clone() for k, v in self.engine.state_dict().items()}
                if ckpt_path is not None:
                    save_checkpoint(ckpt_path, {"model": best}, self._group())
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
        hist = None if last is None else self._gathered(last[0])
        mean_loss = float(np.mean(losses))
        if not is_primary():
            return mean_loss
        os.makedirs(data_dir, exist_ok=True)
        np.save(os.path.join(data_dir, "test_loss_epoch.npy"), losses)
        if last is not None:
            batch = last[1]
            np.savez(
                os.path.join(data_dir, "test_result.npz"),
                particle_list=hist["particles"],
                particle_weight_list=hist["weights"],
                likelihood_list=hist["likelihoods"],
                state=_host(batch["state"]),
                pred=hist["pred"],
                images=_host(batch["image"]),
                noise=hist["noise"],
            )
            if plots:
                self._test_plots(hist, batch, data_dir)
        print(f"test loss: {mean_loss:.4f}")
        return mean_loss

    def _test_plots(self, hist: dict, batch, data_dir: str) -> None:
        from nfdpf_torch import viz

        images = _host(batch["image"][0])
        if images.dtype == np.uint8:
            images = images.astype(np.float32) / 255.0
        true_state = _host(batch["state"][0])               # (T, 4)
        pred = hist["pred"][0]                              # (T, 2)
        width = self.config.width
        viz.plot_state_tracking(true_state, pred, os.path.join(data_dir, "test_trajectory.png"),
                                width=width)
        viz.plot_ess_tracking(hist["weights"], os.path.join(data_dir, "test_ess.png"))
        viz.plot_obs_tracking(images, hist["particles"][0][..., :2], hist["weights"][0],
                              true_state, pred, os.path.join(data_dir, "tracking"), width=width)

    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint the parameters and BN statistics, the optimizer state
        and the epoch count into the directory ``path`` (the primary rank
        writes; the mesh's ranks wait for it)."""
        save_checkpoint(path, {"model": self.engine.state_dict(),
                               "optimizer": self.optimizer.state_dict(),
                               "epoch": self.epoch}, self._group())

    def _group(self):
        return None if self.mesh is None else self.mesh.group

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
