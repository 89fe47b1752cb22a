"""Configuration for the PyTorch/CUDA port of the NF-DPF framework.

The port's own copy of ``nfdpf_tpu/config.py``: the same fields, defaults
and CLI flags, so one flag set drives either package.  Fields that name TPU
machinery keep their names (``use_pallas`` selects the streaming-Sinkhorn
kernels, here the CUDA ones; ``mesh_*`` the device mesh).  Values no
package runs are rejected by ``nfdpf_torch.models.dpf.check_supported``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DPFConfig:
    # --- training type (arguments.py:10-20) ---
    train_type: str = "DPF"            # DPF | SDPF | UDPF
    pretrain_ae: bool = False
    pretrain_epochs: int = 300         # AE-pretrain epoch count (`DPFs.py:410`)
    pretrain_nfcond: bool = False
    e2e_train: bool = True
    load_pretrain_model: bool = False
    resume: bool = False
    testing: bool = False
    model_path: str = "./model"

    # --- model structure (arguments.py:22-24, 37-43) ---
    nf_dyn: bool = False               # --NF-dyn
    nf_cond: bool = False              # --NF-cond
    measurement: str = "cos"           # CRNVP | cos | NN | CGLOW | gaussian
    nf_lr: float = 2.5                 # unused by reference optimizer; kept for parity
    dyn_nn: bool = False
    obs_feature: bool = True
    hidden_size: int = 32
    state_dim: int = 2                 # DPFs.py:31
    n_sequence: int = 2                # flow blocks per composer (DPFs.py:46)
    flow_hidden_dim: int = 8           # conditioner MLP width (nf/flows.py:123)

    # --- resampling (arguments.py:27-32) ---
    resampler_type: str = "ot"         # ot | soft
    epsilon: float = 0.1
    scaling: float = 0.75
    alpha: float = 0.5
    threshold: float = 1e-3
    max_iter: int = 100
    ess_threshold: float = 0.5         # resample when ESS < ess_threshold * N (DPFs.py:165)
    # Gradient topology of the OT resampler.  The reference computes the
    # gradient of the transport matrix w.r.t. particles/weights and then
    # DISCARDS it (resamplers.py:234-245); only the grad through
    # ``matmul(T, particles)``'s particle argument survives.  Set True for the
    # "true OT-DPF" behaviour where the final Sinkhorn round stays on the tape.
    ot_transport_grad: bool = False
    # Reference stops the Sinkhorn loop once ANY batch row converges
    # ("all rows still running" continue-condition, resamplers.py:126-129).
    sinkhorn_convergence: str = "all"  # all | any
    # Carry Sinkhorn potentials across ESS-gate firings in the filter scan
    # and start the next firing's loop from them at the target ε instead of
    # re-annealing from diameter² every call (resamplers.py:117-118).  The
    # annealing loop is fully detached, so this changes iteration count
    # only, not gradient topology.  Streaming OT path only (``use_pallas``:
    # the streaming-Sinkhorn kernels); default off for reference schedule
    # parity.
    sinkhorn_warm_start: bool = False
    # warm firings re-anneal from this multiple of the target ε (not from
    # diameter²); 1.0 = no annealing tail
    sinkhorn_warm_eps_factor: float = 16.0
    # Reference-parity ablation: run the conv encoder INSIDE the time loop
    # (BN batch statistics over the B frames of each step, running stats
    # updated per step — `DPFs.py:177`) and re-encode all frames for the AE
    # loss (`losses.py:5-16`) instead of the hoisted single conv pass whose
    # BN statistics span all B·T frames.  Used to attribute the
    # repo-vs-reference gap on the resampling-active anchors to BN
    # statistics granularity.
    encode_per_step: bool = False

    # --- optimisation (arguments.py:42-50) ---
    batch_size: int = 32
    lr: float = 1e-4
    optim: str = "Adam"
    num_epochs: int = 500
    num_particles: int = 100

    # --- data / semi-supervision (arguments.py:52-64) ---
    split_ratio: float = 0.9
    labeled_ratio: float = 1.0
    init_with_true_state: bool = False
    dropout_keep_ratio: float = 0.3
    particle_std: float = 0.2
    seed: int = 2
    sequence_length: int = 50
    width: int = 128

    # --- process noise (arguments.py:66-78) ---
    pos_noise: float = 20.0
    vel_noise: float = 20.0
    true_pos_noise: float = 2.0
    true_vel_noise: float = 2.0

    # --- pseudo-likelihood (arguments.py:80-81) ---
    block_length: int = 10

    # --- CGLOW (arguments.py:88-99) ---
    x_size: Tuple[int, int, int] = (3, 8, 8)   # condition, CHW as in reference
    y_size: Tuple[int, int, int] = (3, 8, 8)
    x_hidden_channels: int = 8
    x_hidden_size: int = 16
    y_hidden_channels: int = 8
    flow_depth: int = 1                # -K
    num_levels: int = 1                # -L
    learn_top: bool = False
    x_bins: float = 256.0
    y_bins: float = 256.0

    # --- data location ---
    data_path: str = "./data/disk/TwentyfiveDistractors/"
    num_examples: int = 1000           # auto-generated train sequences
                                       # (reference generator default,
                                       # `create_dataset.py:283-326`)

    # --- accelerator-specific (no reference analog; names kept from the
    # JAX package so one flag set drives either package) ---
    mesh_data: int = 1                 # mesh size along the batch ('data') axis
    mesh_particle: int = 1             # mesh size along the 'particle' axis
    compute_dtype: str = "float32"     # float32 | bfloat16 for conv/matmul compute
    use_pallas: bool = False           # OT resampling on the streaming-Sinkhorn
                                       # CUDA kernels (K1/K2), which never
                                       # hold the N×N cost matrix
    pallas_coupling: bool = False      # the RealNVP coupling chains on the
                                       # fused CUDA kernels (K4/K5) instead
                                       # of the FlowChain modules
    remat_scan_step: bool = False      # recompute each filter step in the backward
    torch_init: bool = False           # torch-default U(±1/√fan_in) init for the
                                       # encoder/decoder/particle-enc Dense+Conv
                                       # layers (head-to-head init parity)
    fused_epoch: bool = True           # no effect; parsed for CLI parity with
                                       # the JAX package: main stages the
                                       # data on the card (Trainer.fit_fused)
                                       # whenever it fits main's budget,
                                       # else feeds host batches

    @property
    def glow_ctx_features(self) -> int:
        """Flattened size of the CGLOW condition tensor (3*8*8=192, model/models.py:55)."""
        c, h, w = self.x_size
        return c * h * w

    def replace(self, **kw) -> "DPFConfig":
        return dataclasses.replace(self, **kw)


def parse_args(argv=None) -> DPFConfig:
    """CLI mirroring the reference flags (the original's ``arguments.py``)."""
    p = argparse.ArgumentParser("nfdpf_torch")
    p.add_argument("--trainType", dest="train_type", type=str, default="DPF",
                   choices=["DPF", "SDPF", "UDPF"])
    p.add_argument("--pretrain_ae", action="store_true")
    p.add_argument("--pretrain-epochs", dest="pretrain_epochs", type=int,
                   default=300,
                   help="AE-pretrain epochs (the reference hardcodes 300, "
                        "`DPFs.py:410-412`)")
    p.add_argument("--pretrain-NFcond", dest="pretrain_nfcond", action="store_true",
                   help="accepted for reference CLI parity; no effect (dead in the reference too)")
    p.add_argument("--e2e-train", dest="e2e_train", action="store_false")
    p.add_argument("--load-pretrainModel", dest="load_pretrain_model", action="store_true")
    p.add_argument("--NF-dyn", dest="nf_dyn", action="store_true")
    p.add_argument("--NF-cond", dest="nf_cond", action="store_true")
    p.add_argument("--measurement", type=str, default="cos")
    p.add_argument("--NF-lr", dest="nf_lr", type=float, default=2.5,
                   help="accepted for reference CLI parity; no effect (dead in the reference too)")
    p.add_argument("--epsilon", type=float, default=0.1)
    p.add_argument("--scaling", type=float, default=0.75)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--threshold", type=float, default=1e-3)
    p.add_argument("--max_iter", type=int, default=100)
    p.add_argument("--resampler_type", type=str, default="ot")
    p.add_argument("--ot-transport-grad", dest="ot_transport_grad", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--Dyn_nn", dest="dyn_nn", action="store_true",
                   help="accepted for reference CLI parity; no effect (dead in the reference too)")
    p.add_argument("--Obs_feature", dest="obs_feature", action="store_false",
                   help="accepted for reference CLI parity; no effect (dead in the reference too)")
    p.add_argument("--batchsize", dest="batch_size", type=int, default=32)
    p.add_argument("--hiddensize", dest="hidden_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--optim", type=str, default="Adam")
    p.add_argument("--num-epochs", dest="num_epochs", type=int, default=500)
    p.add_argument("--num-particles", dest="num_particles", type=int, default=100)
    p.add_argument("--split-ratio", dest="split_ratio", type=float, default=0.9)
    p.add_argument("--labeledRatio", dest="labeled_ratio", type=float, default=1.0)
    p.add_argument("--init-with-true-state", dest="init_with_true_state", action="store_true")
    p.add_argument("--dropout-keep-ratio", dest="dropout_keep_ratio", type=float, default=0.3,
                   help="accepted for reference CLI parity; no effect (dead in the reference too)")
    p.add_argument("--particle_std", type=float, default=0.2,
                   help="accepted for reference CLI parity; no effect (dead in the reference too)")
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--sequence-length", dest="sequence_length", type=int, default=50)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--pos-noise", dest="pos_noise", type=float, default=20.0)
    p.add_argument("--vel-noise", dest="vel_noise", type=float, default=20.0)
    p.add_argument("--true-pos-noise", dest="true_pos_noise", type=float, default=2.0)
    p.add_argument("--true-vel-noise", dest="true_vel_noise", type=float, default=2.0)
    p.add_argument("--block-length", dest="block_length", type=int, default=10)
    p.add_argument("--testing", action="store_true")
    p.add_argument("--model-path", dest="model_path", type=str, default="./model")
    p.add_argument("--x_hidden_channels", type=int, default=8)
    p.add_argument("--x_hidden_size", type=int, default=16)
    p.add_argument("--y_hidden_channels", type=int, default=8)
    p.add_argument("-K", "--flow_depth", type=int, default=1)
    p.add_argument("-L", "--num_levels", type=int, default=1)
    p.add_argument("--learn_top", action="store_true")
    p.add_argument("--x_bins", type=float, default=256.0)
    p.add_argument("--y_bins", type=float, default=256.0)
    p.add_argument("--data-path", dest="data_path", type=str,
                   default="./data/disk/TwentyfiveDistractors/")
    p.add_argument("--num-examples", dest="num_examples", type=int,
                   default=1000,
                   help="train sequences to auto-generate when the dataset "
                        "is missing (reference default: 1000)")
    p.add_argument("--mesh-data", dest="mesh_data", type=int, default=1)
    p.add_argument("--mesh-particle", dest="mesh_particle", type=int, default=1)
    p.add_argument("--compute-dtype", dest="compute_dtype", type=str, default="float32")
    p.add_argument("--use-pallas", dest="use_pallas", action="store_true")
    p.add_argument("--pallas-coupling", dest="pallas_coupling",
                   action="store_true")
    p.add_argument("--torch-init", dest="torch_init", action="store_true")
    p.add_argument("--remat", dest="remat_scan_step", action="store_true")
    p.add_argument("--warm-start", dest="sinkhorn_warm_start",
                   action="store_true",
                   help="carry Sinkhorn potentials across ESS-gate firings "
                        "(streaming OT path, --use-pallas)")
    p.add_argument("--encode-per-step", dest="encode_per_step",
                   action="store_true",
                   help="reference-parity BN ablation: encoder inside the "
                        "time loop + separate AE-loss encode")
    p.add_argument("--no-fused-epoch", dest="fused_epoch", action="store_false",
                   help="no effect (kept for CLI parity): the data is "
                        "staged on the card whenever it fits")
    ns = p.parse_args(argv)
    return DPFConfig(**{f.name: getattr(ns, f.name)
                        for f in dataclasses.fields(DPFConfig)
                        if hasattr(ns, f.name)})
