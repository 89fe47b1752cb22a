"""CLI entry: generate the data if missing, train, validate, test.

Counterpart of ``nfdpf_tpu/main.py``: the same flags (``nfdpf_torch/config.py``),
run id, ``logs/<run_id>/{models,data,logger}`` layout and flow.  The data
comes from the port's simulator, on the card, when the dataset directory
holds none.  Runs on ``cuda`` and raises without a GPU; ``main(argv,
device="cpu")`` runs it on the CPU (the kernels' plain versions), for tests.

    python -m nfdpf_torch.main --NF-dyn --NF-cond --pallas-coupling --use-pallas

A device mesh (``--mesh-data D --mesh-particle P``) runs one process per
rank, D·P of them, each on its card (``cuda:LOCAL_RANK``), over NCCL; with
more ranks than cards they share them over gloo:

    torchrun --nproc-per-node D·P -m nfdpf_torch.main --mesh-data D --mesh-particle P ...

The primary rank makes the data, writes the artifacts, checkpoints and
logs; every rank loads.  The staging budget is per data rank, which holds
1/D of the data.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from nfdpf_torch import viz
from nfdpf_torch.config import DPFConfig, parse_args
from nfdpf_torch.data.dataset import DiskDataset, iterate_batches
from nfdpf_torch.data.simulator import generate_dataset
from nfdpf_torch.models.dpf import check_supported, resolve_device
from nfdpf_torch.parallel.distributed import (
    initialize,
    is_primary,
    local_device,
    say,
    shutdown,
)
from nfdpf_torch.parallel.mesh import make_mesh
from nfdpf_torch.train import Trainer
from nfdpf_torch.utils.metrics import MetricsLogger

# the uint8 frames and states of train + val are staged on the card
# (Trainer.fit_fused) when they take less than this many bytes (the JAX
# package's budget), else each step gets a batch from the host; staged
# epochs ran faster in paired runs (tools/batch_source_ab.py)
STAGED_BYTES_LIMIT = 8e9


def get_run_id(cfg: DPFConfig) -> str:
    """The reference's run-id hyperparameter string."""
    return "{}_NF^{}_{}_{}_{}_{}_{}_resample^{}_{}".format(
        cfg.seed, cfg.nf_dyn, cfg.train_type, cfg.pos_noise, cfg.vel_noise,
        cfg.nf_lr, cfg.lr, cfg.resampler_type, cfg.measurement,
    )


def ensure_dataset(cfg: DPFConfig, num_examples: int | None = None, device=None) -> str:
    """The dataset's filename prefix (set by --true-pos-noise); generates the
    dataset on ``device`` when its first train shard is missing, with
    ``num_examples`` (default --num-examples) train sequences."""
    num_examples = num_examples if num_examples is not None else cfg.num_examples
    filename = f"toy_pn={cfg.true_pos_noise}_d=25_const"
    probe = os.path.join(cfg.data_path, f"{filename}0_train.npz")
    if not os.path.exists(probe):
        print(f"dataset not found at {probe}; generating "
              f"{num_examples} sequences with the port's simulator ...")
        generate_dataset(
            cfg.data_path, num_examples=num_examples,
            file_size=max(num_examples, 10),
            num_distractors=25, pos_noise=cfg.true_pos_noise,
            sequence_length=cfg.sequence_length, im_size=cfg.width,
            seed=cfg.seed, device=device,
        )
    return filename


def main(argv=None, device=None) -> None:
    cfg = parse_args(argv)
    check_supported(cfg)          # refused before any data is made
    sharded = cfg.mesh_data * cfg.mesh_particle > 1
    joined = False
    if sharded:
        on_cpu = device is not None and torch.device(device).type == "cpu"
        joined = initialize("gloo" if on_cpu else None)
    try:
        # D·P must be the world size: without torchrun a mesh is refused here
        mesh = make_mesh(cfg.mesh_data, cfg.mesh_particle) if sharded else None
        _run(cfg, device, mesh)
    finally:
        if joined:
            shutdown()


def _run(cfg: DPFConfig, device, mesh) -> None:
    device = resolve_device(device)
    if mesh is not None and device.type == "cuda":
        # each rank on its card (NCCL takes the current device)
        device = local_device() if device.index is None else device
        torch.cuda.set_device(device)
    np.random.seed(cfg.seed)
    run_id = get_run_id(cfg)
    run_dir = os.path.join("logs", run_id)
    os.makedirs(os.path.join(run_dir, "models"), exist_ok=True)
    os.makedirs(os.path.join(run_dir, "data"), exist_ok=True)
    say(cfg)
    if mesh is not None:
        say(f"mesh: {mesh.shape} over {mesh.size} ranks")
    plots = viz.available()
    say("plots: on (matplotlib found)" if plots else
         "plots: off (matplotlib not installed); the data artifacts are written all the same")

    if is_primary():
        ensure_dataset(cfg, device=device)
    if mesh is not None:
        torch.distributed.barrier(group=mesh.group)
    filename = ensure_dataset(cfg, device=device)
    train_ds = DiskDataset(cfg.data_path, filename, "train_data")
    val_ds = DiskDataset(cfg.data_path, filename, "val_data")
    test_ds = DiskDataset(cfg.data_path, filename, "test_data")
    # eval batches of up to 50 sequences, whole batches only, each a
    # multiple of the data axis so that it splits over the data ranks
    val_bs, test_bs = (min(50, len(ds)) // cfg.mesh_data * cfg.mesh_data
                       for ds in (val_ds, test_ds))
    if not (val_bs and test_bs):
        raise ValueError(f"the val and test sets ({len(val_ds)}, {len(test_ds)} sequences) "
                         f"must hold at least one sequence per data rank ({cfg.mesh_data})")

    trainer = Trainer(cfg, device, mesh)
    ckpt_best = os.path.join(run_dir, "models", "best")
    if cfg.resume and os.path.isdir(ckpt_best):
        say("resuming from", ckpt_best)
        trainer.load(ckpt_best)

    def train_iter(epoch):
        return iterate_batches(train_ds, cfg.batch_size, shuffle=True, drop_last=True,
                               seed=cfg.seed + epoch)

    def val_iter():
        return iterate_batches(val_ds, val_bs, shuffle=False, drop_last=True)

    def test_iter():
        return iterate_batches(test_ds, test_bs, shuffle=False, drop_last=True)

    # each data rank stages its 1/D of train + val
    staged_bytes = sum(ds.data["image"].nbytes + ds.data["state"].nbytes
                       for ds in (train_ds, val_ds)) // cfg.mesh_data
    staged = staged_bytes < STAGED_BYTES_LIMIT

    if not cfg.testing:
        if cfg.pretrain_ae:
            say("pretraining autoencoder ...")
            trainer.pretrain_ae(
                train_iter, num_epochs=cfg.pretrain_epochs, valid_batches=val_iter,
                ckpt_path=os.path.join(run_dir, "models", "ae_pretrain"),
                run_dir=run_dir, plots=plots,
            )
        if cfg.load_pretrain_model:
            ae_ckpt = os.path.join(run_dir, "models", "ae_pretrain")
            if not os.path.isdir(ae_ckpt):
                ae_ckpt = os.path.join(cfg.model_path, "ae_pretrain")
            if os.path.isdir(ae_ckpt):
                say("loading pretrained AE weights from", ae_ckpt)
                trainer.load_model(ae_ckpt)
            else:
                say(f"no AE-pretrain checkpoint found at {ae_ckpt}; "
                     "continuing with fresh weights")
        if cfg.e2e_train:
            say("end-to-end training ...")
            with contextlib.closing(MetricsLogger(os.path.join(run_dir, "logger"))) as logger:
                if staged:
                    say(f"data staged on the device ({staged_bytes / 1e9:.2f} GB a data rank)")
                    trainer.fit_fused(train_ds, val_ds, run_dir, num_epochs=cfg.num_epochs,
                                      logger=logger, seed=cfg.seed)
                else:
                    trainer.fit(train_iter, val_iter, run_dir, num_epochs=cfg.num_epochs,
                                logger=logger, seed=cfg.seed)
        trainer.save(os.path.join(run_dir, "models", "final"))
    else:
        ckpt = os.path.join(cfg.model_path, "best")
        if os.path.isdir(ckpt):
            say("loading trained model from", ckpt)
            trainer.load(ckpt)

    trainer.test(test_iter, run_dir, seed=cfg.seed, plots=plots)


if __name__ == "__main__":
    main()
