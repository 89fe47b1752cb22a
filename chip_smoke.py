#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nfdpf_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, one line of output each, then the device line last:

1. setup: the card's name and power limit (nvidia-smi), the kernels' build
   (one nvcc process per source, started together);
2. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the main path's shapes and a ragged large one, with its time, the
   plain version's time, the time of one PyTorch library call where one
   computes the same function, and the least time the card could take
   (bound) and the device time of an empty kernel launched the same way
   (``launch_floor_ms``).  The streaming-Sinkhorn kernels at (B=32,
   N=M=100), (B=10, N=M=100) (``main_cli``'s eval and test batches),
   (B=4, N=M=4097) and (B=4, N=M=10240), each launched twice for
   equal bits; the coupling-chain kernels (forward K4, backward K5) in both
   directions at (B=32, N=100) and (B=10, N=100) with the dynamics flow's
   context (4 wide) and the proposal flow's (36 wide), each one row per batch element
   broadcast over the particles as the filter passes it, and at (B=4,
   N=4097) with a dense 36-wide context and with none, each launched again
   for equal bits, and since the context's share of layer 0 left them, at
   (B=32, N=100) and (B=10, N=100) with the CGLOW proposal's 196-wide
   context; the context kernels (the share, the context-weight gradient,
   its first kernel alone, and the context-input gradient) alone against
   their plain versions at each case with a context and at edge cases
   (ragged rows, C = 1, 63-65 and 197, 4K·H = 256 and 192, a broadcast
   over 5 particles, a strided dense view), all of which are then launched
   back to back for equal bits; beside them the time of the same call
   through the ``FlowChain`` module; at the filter's heaviest call, the
   registers and shared memory per block of the timed launches as their
   library notes them (``launch_record``), the shared memory held
   against the wrapper's mirrors of the kernels' layouts (K4, K5, the share,
   both kernels of the weight gradient and the input gradient); all of it
   again at hidden width 16, the narrow pair's widest build; then the wide
   pair (``chain_kernels_wide``: the chains the narrow pair does not take,
   hidden 12 at four blocks, 17, 32 at four and nine blocks, 64 at twelve
   and 256, at (B=32, N=100) with contexts 4, 36 and 196 wide broadcast
   over the particles, 512 and 1,024 at two blocks there with the 36-wide
   one, and a dense 36-wide context and none at (B=4,
   N=4097)) through the wrapper against the plain version, bit-equal
   repeats, each case timed beside its bound, the plain version and the
   module route, its launches' registers and shared memory held to the
   wrapper's mirrors and to ptxas, and at hidden 8 against the narrow
   pair's launchers; then the coupling kernels' and the update kernels'
   registers and spills as ptxas reports them, the input gradient's and
   the update's noted launches held to them;
   then K3, the streaming resampler's driver: its update kernel against
   the plain version bit for bit (some rows stopped, every row running, a
   NaN in K1's output; all and any), timed stopping and with every row
   running, and K3 at (32, 100), (10, 100) and
   (4, 10240), cold and warm, replaying ``LOOP_CHUNK`` iterations a CUDA
   graph against chunks of one iteration (the same iterations and bits)
   and against its plain version on the card, with ms a call, host syncs
   and the chunk sizes' times;
3. slices, each at full width (B=32, N=100, T=50, 128×128×3 frames, every
   step resampled): 3 train steps and 1 eval step, the launch counts of
   each kernel over them (set to 0 just before, read just after), step
   time, transitions/s, peak memory, device syncs per step.  The bootstrap
   DPF and the CNF-DPF (RealNVP dynamics and proposal on the fused coupling
   kernels) with OT on the streaming-Sinkhorn kernels; ``dense``, bench.py's
   own configuration (OT over materialised costs, no kernel: every counter
   must read 0), with its Sinkhorn iterations per firing and host syncs;
   ``soft``, the soft resampler (no kernel either); ``nfdpf``, the paper's
   NF-DPF (both flows on the coupling kernels, the CRNVP measurement, OT on
   the streaming kernels: all four kernels); ``cglow``, BASELINE config 5:
   the conditional-GLOW measurement over B·N = 3,200 images of 8×8×3 per
   time step, the NF dynamics on the coupling kernels (the inverse
   direction only) and SDPF semi-supervised training (labeled ratio 0.5,
   blocks of 10 steps), with its pseudo-likelihood; the single-card
   settings of the JAX CLI: ``cglow_nfcond`` (config 5 with the proposal
   flow, whose context is the 196-wide CGLOW encoding); ``cnf_bf16`` (the
   CNF-DPF with its encoder and
   decoder computing in bfloat16), ``cnf_h16`` (the CNF-DPF with 16-wide
   conditioners on K4/K5), ``cglow_remat`` (config 5 with each time step
   recomputed in the backward: its firings, Sinkhorn iterations and
   first-step loss must equal ``cglow``'s, its peak memory and step times
   beside them), ``per_step`` (the bootstrap DPF with the per-step
   encode and torch's default initialisation) and ``cnf_wide`` (the
   CNF-DPF with four 32-wide coupling blocks: both flows on the wide
   pair; ``wide_step`` beside it: the wide pair's device ms a step from
   its launches and the kernel phase's times).  A counter a slice does not
   name must read 0;
4. the warm start: the bootstrap slice's eval filter at full width, cold
   and with ``sinkhorn_warm_start``: the first firing takes the same
   Sinkhorn iterations both ways, the later ones together at most 1.1× the
   cold ones;
5. parity, for every slice and for the dense path with the transport's
   gradient, the NN and the gaussian measurement and the bootstrap SDPF:
   one loss + gradient on the card (cuda) and on the plain versions (cpu)
   from the same parameters, noise and semi-supervised mask (config 5 with
   and without the proposal flow); bf16 against
   bfloat16's own effect on the CPU (``BF16_*``, a float32 run beside),
   remat on the CNF-DPF with the warm start, and the CNF-DPF on the wide
   pair at the flows' init scale (its card run must launch the wide pair);
6. linalg: the CGLOW's batched log|det| and inverse (plain PyTorch ops, no
   kernel of ours) and their analytic gradients on the card at (3,200, 12,
   12), on the weights the 1×1 convolution makes, against float64
   ``torch.linalg`` on the CPU, with their times and ``torch.linalg``'s on
   the card;
6b. flow_library: the flows no configuration builds (MAF, ActNorm, the LU
   linear map, planar, radial, both neural-spline flows), ``TransitionMLP``
   and a mixed ``FlowChain`` of five of them, at the state width and the
   defaults, on the card at B·N = 3,200 and 40,960 rows, forward and
   inverse: outputs, log-dets and the gradients of the input and every
   parameter against float64 on the CPU, with the eager ms of the forward
   and of forward + backward and the forward's device ms (plain PyTorch, as
   the JAX package's plain jnp: no kernel of ours may launch);
7. simulator: disk-tracking sequences (T=50, 25 distractors, 128 px) made
   on the card, timed (sequences/s, to host arrays as the dataset writer
   takes them and on the card alone), and the same draws through the CPU:
   frames and visible counts equal, states within 1e-4;
8. main_cli: ``nfdpf_torch.main.main`` as a user runs it, in a temporary
   directory, with ``--NF-dyn --NF-cond --pallas-coupling --use-pallas`` at
   B=32, N=100, T=50, 128 px and the default ESS gate (0.5): run 1 makes
   the data on the card (80 train sequences, 2 steps an epoch) and trains 1
   epoch on the data staged on the card (``fit_fused``, as ``main`` runs
   whenever the data fits), run 2 resumes to epoch 2 on host batches
   (``--resume``, with ``main``'s staging budget set to 0), run 3 tests
   (``--testing --model-path``).  Per run the launch counts (set to 0 just
   before, read just after), the gate's firings, step times, peak memory
   and seconds; every artifact, the epoch after each run and finite losses
   are checked, K4 and K5 must have launched, and ``checkpoint_metadata``
   of the final checkpoint must give the restored tree's shapes, dtypes
   and other leaves with no tensor's data;
9. kernels_rows_ne_cols: K1 (G = 1, 2) and K2 (both directions) on N rows
   against M columns, as K6 runs them, at (B, N, M) = (32, 50, 100),
   (10, 50, 100), (4, 5120, 10240) and the ragged (3, 1037, 2053), with the
   tolerances, second-launch bits and times of phase 2;
10. mesh: one group of 4 ranks spawned on this card, joined over gloo (which
   stages CUDA tensors through the host: these are correctness runs, and
   their times say nothing of NCCL): K6 on 2 ranks at (4, 10240) against K3
   unsharded and against its plain version (particles rtol 1e-4 / atol
   1e-5, value gradient 1e-3, equal iterations, global indices), K6 and its
   plain version timed in turns, with K3's per-call time; K6's collectives
   a call (one all-gather an iteration and no all-reduce; its plain version
   one of each an iteration), host reads and launches; one train step
   at full width (B=32, N=100, T=10, 128 px, every step resampled) on a
   1×2 mesh (the CNF-DPF), a 2×1 mesh (the bootstrap DPF), a 2×2 mesh
   (the NF-DPF) and two more 1×2 meshes: the CNF-DPF with OT over
   materialised costs (bench.py's) and config 5 with the soft resampler
   (CGLOW with its parameters drawn, NF dynamics, SDPF), each against the
   unsharded card run of the same weights and draws: loss rel ≤ 1e-4, each
   gradient group ‖Δ‖/‖g‖ ≤ 1e-3 (the decoder 1e-2), equal firings and
   streaming and dense Sinkhorn iterations, the launches of K1, K2, K4, K5
   and K6's calls where the path runs them on every rank (set to 0 just
   before, read just after), with each rank's collectives, coupling
   launches, seconds and peak memory logged.
   The meshes with a data axis also run their step in float64 on the CPU
   (2 and 4 ranks) against the unsharded float64 step: loss and every
   gradient group within 1e-9, the proof that the mesh computes the
   unsharded step's function, since in float32 the split BatchNorm sums
   alone move the encoder's gradient by ~1e-3 (how far each card run sits
   from float64 is logged);
11. main_cli_mesh: ``python -m nfdpf_torch.main`` as torchrun starts it,
   2 ranks on this card (gloo), with ``--mesh-data 2`` and main_cli's
   flags, then with ``--mesh-particle 2`` at the CLI's default OT (over
   materialised costs): one epoch on the 80 sequences the first run makes,
   then ``--testing``; every rank exits 0, only rank 0 prints, the eval
   and test losses are finite;
12. the ``kernels`` JSON line, with K1/K2 at rows ≠ columns, K3 and K6,
   and the wide pair with its launches in ``slice_cnf_wide``'s train steps.

Every comparison runs with TF32 off.  Any failed check raises, so the
script exits non-zero without printing the last line; so does any rank
that fails, in phases 10 and 11.  The port has no CPU
fallback: with no CUDA device the script stops before any phase.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12    # fp32 outside the tensor cores, H100 SXM data sheet

# the slice: bench.py's workload with the streaming-Sinkhorn kernels on.
# ess_threshold 1.01 resamples on every step: at the seed's random weights on
# bench-style frames the batch-mean ESS only falls from 100 to ~67 in 50
# steps, so the default 0.5 would never run the resampler.
SLICE = dict(num_particles=100, sequence_length=50, batch_size=32, width=128,
             resampler_type="ot", measurement="cos", train_type="DPF",
             use_pallas=True, compute_dtype="float32", ess_threshold=1.01)
# the CNF-DPF slice: the same with both RealNVP flows on the fused coupling
# kernels.  Per time step: dynamics chain inverse, proposal chain inverse,
# dynamics chain forward; the particles now depend on the flows' parameters,
# so the backward runs the coupling backward kernel three times per step and
# the transport's backward (Tᵀg) once.
CNF_SLICE = dict(SLICE, nf_dyn=True, nf_cond=True, pallas_coupling=True)
# bench.py's own configuration (bench.py:92-99: use_pallas left off, so OT
# over materialised costs), resampling every step as above
DENSE_SLICE = dict(SLICE, use_pallas=False)
# the soft resampler (alpha 0.5)
SOFT_SLICE = dict(SLICE, resampler_type="soft")
# the paper's NF-DPF: the CNF-DPF with the conditional-RealNVP measurement
NFDPF_SLICE = dict(CNF_SLICE, measurement="CRNVP")
# BASELINE config 5 (BASELINE.json configs[4]) on one card: the
# conditional-GLOW measurement, the NF dynamics on the packed chain, SDPF
# semi-supervised training (block_length 10, the default)
CGLOW_SLICE = dict(SLICE, measurement="CGLOW", nf_dyn=True, pallas_coupling=True,
                   train_type="SDPF", labeled_ratio=0.5)
# the single-card settings of the JAX CLI (bench.py's headline runs bf16):
# the CNF-DPF computing its encoder and decoder in bfloat16; the CNF-DPF with
# 16-wide conditioners on K4/K5 (the narrow pair's widest build); config 5 with
# each time step recomputed in the backward; the bootstrap DPF with the
# reference's per-step encode and torch's default initialisation
BF16_SLICE = dict(CNF_SLICE, compute_dtype="bfloat16")
H16_SLICE = dict(CNF_SLICE, flow_hidden_dim=16)
CGLOW_REMAT_SLICE = dict(CGLOW_SLICE, remat_scan_step=True)
# config 5 with the proposal flow (--measurement CGLOW --NF-cond, the CLI's
# case): the proposal chain's context is the 192-wide CGLOW encoding + 4,
# which K4/K5 take since the context's share of layer 0 left them
CGLOW_NFCOND_SLICE = dict(CGLOW_SLICE, nf_cond=True)
PER_STEP_SLICE = dict(SLICE, encode_per_step=True, torch_init=True)
# the CNF-DPF with four 32-wide coupling blocks: both flows on the wide pair
# (the narrow pair takes hidden <= 16)
CNF_WIDE_SLICE = dict(CNF_SLICE, flow_hidden_dim=32, n_sequence=4)
H16 = 16   # the narrow pair's widest build (widths 9-15 run padded to it)
# the kernels → source and the TPU kernel each replaces
SINKHORN_CU = "nfdpf_torch/ops/cuda/csrc/sinkhorn.cu"
COUPLING_CU = "nfdpf_torch/ops/cuda/csrc/coupling.cu"
KERNELS = {
    "sinkhorn_lse": (SINKHORN_CU, "nfdpf_tpu/ops/pallas/sinkhorn_pallas.py:78"),
    "transport_apply": (SINKHORN_CU, "nfdpf_tpu/ops/pallas/sinkhorn_pallas.py:180"),
    # the rest of the while_loop body of ot_resample_pallas (K3) after the softmin
    "sinkhorn_update": (SINKHORN_CU, "nfdpf_tpu/ops/pallas/sinkhorn_pallas.py:405"),
    "coupling_chain": (COUPLING_CU, "nfdpf_tpu/ops/pallas/coupling_pallas.py:100"),
    "coupling_chain_bwd": (COUPLING_CU, "nfdpf_tpu/ops/pallas/coupling_pallas.py:262"),
    # layer 0's context share and its gradients, inside those two TPU kernels
    "coupling_ctx_share": (COUPLING_CU, "nfdpf_tpu/ops/pallas/coupling_pallas.py:100"),
    "coupling_ctx_grad_rows": (COUPLING_CU, "nfdpf_tpu/ops/pallas/coupling_pallas.py:262"),
    "coupling_ctx_weight_grad": (COUPLING_CU, "nfdpf_tpu/ops/pallas/coupling_pallas.py:262"),
    "coupling_ctx_input_grad": (COUPLING_CU, "nfdpf_tpu/ops/pallas/coupling_pallas.py:262"),
    # the same two TPU kernels for the chains the narrow pair does not take
    "coupling_chain_wide": (COUPLING_CU, "nfdpf_tpu/ops/pallas/coupling_pallas.py:100"),
    "coupling_chain_bwd_wide": (COUPLING_CU, "nfdpf_tpu/ops/pallas/coupling_pallas.py:262"),
}
# each kernel's case in the kernels line: the shape and direction the CNF-DPF
# slice runs it most heavily; the context kernels at the CGLOW proposal's
# 196-wide context (slice_cglow_nfcond)
AT = {"sinkhorn_lse": "B32_N100", "transport_apply": "B32_N100", "sinkhorn_update": "B32_N100",
      "coupling_chain": "B32_N100_C36_inverse", "coupling_chain_bwd": "B32_N100_C36_inverse",
      "coupling_ctx_share": "B32_N100_C196", "coupling_ctx_grad_rows": "B32_N100_C196",
      "coupling_ctx_weight_grad": "B32_N100_C196",
      "coupling_ctx_input_grad": "B32_N100_C196",
      # the wide pair at slice_cnf_wide's proposal chain
      "coupling_chain_wide": "H32_K4_B32_N100_C36_inverse",
      "coupling_chain_bwd_wide": "H32_K4_B32_N100_C36_inverse"}
# the kernels whose launches in the kernels line are those of slice_cnf_wide
# (every other kernel's: slice_nfdpf's)
WIDE_LINE = ("coupling_chain_wide", "coupling_chain_bwd_wide")
# launch counters that must be non-zero after a slice's train steps / eval step.
# The bootstrap DPF's particles carry no gradient (noise and teacher-forced
# velocities), so autograd never asks for the transport's backward there.
# K3's calls and its update kernel run wherever K1 does; the context share
# wherever K4 does, and the context-weight gradient wherever K5 does (every
# chain of the filter has a context); the context-input gradient never (the
# filter detaches its contexts)
BOOTSTRAP_TRAIN = BOOTSTRAP_EVAL = ("sinkhorn_lse", "sinkhorn_update", "transport_apply",
                                    "streaming_resample")
CNF_EVAL = BOOTSTRAP_EVAL + ("coupling_chain", "coupling_chain_inverse", "coupling_ctx_share")
CNF_TRAIN = CNF_EVAL + ("transport_apply_bwd", "coupling_chain_bwd", "coupling_ctx_grad_rows",
                        "coupling_ctx_weight_grad")
# without the proposal flow the dynamics chain runs inverse only: the forward
# direction is the consistency pass of a proposal
CGLOW_EVAL = BOOTSTRAP_EVAL + ("coupling_chain_inverse", "coupling_ctx_share")
CGLOW_TRAIN = CGLOW_EVAL + ("transport_apply_bwd", "coupling_chain_bwd",
                            "coupling_ctx_grad_rows", "coupling_ctx_weight_grad")
# the CNF-DPF on the wide pair
CNF_WIDE_EVAL = BOOTSTRAP_EVAL + ("coupling_chain_wide", "coupling_chain_wide_inverse",
                                  "coupling_ctx_share")
CNF_WIDE_TRAIN = CNF_WIDE_EVAL + ("transport_apply_bwd", "coupling_chain_bwd_wide",
                                  "coupling_ctx_grad_rows", "coupling_ctx_weight_grad")
# the slices: (settings, kernels launched in the 3 train steps, in the eval
# step; every other counter must read 0); none at all on the dense and soft
# paths
SLICES = {
    "slice": (SLICE, BOOTSTRAP_TRAIN, BOOTSTRAP_EVAL),
    "slice_cnf": (CNF_SLICE, CNF_TRAIN, CNF_EVAL),
    "slice_dense": (DENSE_SLICE, (), ()),
    "slice_soft": (SOFT_SLICE, (), ()),
    "slice_nfdpf": (NFDPF_SLICE, CNF_TRAIN, CNF_EVAL),
    "slice_cglow": (CGLOW_SLICE, CGLOW_TRAIN, CGLOW_EVAL),
    "slice_cnf_bf16": (BF16_SLICE, CNF_TRAIN, CNF_EVAL),
    "slice_cnf_h16": (H16_SLICE, CNF_TRAIN, CNF_EVAL),
    "slice_cglow_remat": (CGLOW_REMAT_SLICE, CGLOW_TRAIN, CGLOW_EVAL),
    "slice_per_step": (PER_STEP_SLICE, BOOTSTRAP_TRAIN, BOOTSTRAP_EVAL),
    "slice_cglow_nfcond": (CGLOW_NFCOND_SLICE, CNF_TRAIN, CNF_EVAL),
    "slice_cnf_wide": (CNF_WIDE_SLICE, CNF_WIDE_TRAIN, CNF_WIDE_EVAL),
}
LSE_TOL = 1e-5     # K1: |err| <= tol + tol·|ref|
APPLY_TOL = 1e-4   # K2: |err| <= tol·|ref| + tol·max|ref|
CHAIN_TOL = 1e-5   # K4: |err| <= tol + tol·|ref| (outputs of magnitude ~1-10)
# (B, N = M) of the streaming-Sinkhorn kernels' checks, with timing iterations:
# the main path's train steps, main_cli's eval and test steps (the 10 val or
# test sequences of its data), a ragged large one, and the largest particle
# count trained
SINKHORN_SHAPES = (((32, 100), 200), ((10, 100), 200), ((4, 4097), 20), ((4, 10240), 10))
CHAIN_GRAD_TOL = 1e-4   # K5: |err| <= tol·|ref| + tol·max|ref| per gradient; the weight
                        # gradients sum over all rows in another order than autograd
# card against CPU in bfloat16 compute: the convolutions round differently on
# cuDNN and on the CPU, two perturbations each the size of bfloat16's own
# effect, and that can move the Sinkhorn loop's stopping test.  The loss and
# each group's gradient are held to BF16_FACTOR times bfloat16's effect on
# the CPU (a float32 run against the bfloat16 one), at least the floors
# (phase_parity)
BF16_FACTOR, BF16_LOSS_FLOOR, BF16_GRAD_FLOOR = 3.0, 1e-4, 1e-2


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def _events_ms(run, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time in ms of ``iters`` back-to-back eager calls of ``fn``,
    host-side wrapper included (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run, iters)


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time in ms of one call of ``fn``: ``iters`` calls captured
    in a CUDA graph and replayed, so no host work sits between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    ms = _events_ms(graph.replay, iters)
    del graph
    return ms


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_setup(hiddens):
    from nfdpf_torch.ops.cuda import build    # fails first when the port is absent
    from nfdpf_torch.ops.cuda.coupling_cuda import build_defines

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build_all([("sinkhorn", ())] + [("coupling", build_defines(h)) for h in hiddens])
    builds = {label: {"nvcc_s": info["seconds"],
                      "ptxas": [ln.strip()[:120] for ln in info["ptxas"].splitlines()
                                if "registers" in ln or "spill" in ln
                                or "Compiling entry function" in ln]}
              for label, info in build.build_log.items()}
    log({"phase": "setup", "card": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0, "builds": builds})
    return smi


def ptxas_counts(text: str, pattern: str) -> dict:
    """Registers, spilled bytes and static shared memory per thread / block
    of each kernel whose mangled name matches ``pattern`` in a ``-Xptxas -v``
    report, named ``kernel<template arguments>`` (a bool as ``forward`` or
    ``inverse``)."""
    out, name = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            # e.g. _ZN12_GLOBAL__N_116chain_fwd_kernelILi8ELi8ELb1EEEv...: <H, U, inverse>;
            # ...27chain_ctx_input_grad_kernelILi16ELi4ELi4EEEv...: <TY, TM, NJ>
            hit = re.search(rf"({pattern})(?:I((?:L[ib]\d+E)+)E)?", ln)
            name = None
            if hit is not None:
                args = [("forward", "inverse")[int(v)] if k == "b" else v
                        for k, v in re.findall(r"L([ib])(\d+)E", hit.group(2) or "")]
                name = hit.group(1) + (f"<{', '.join(args)}>" if args else "")
                out[name] = {}
        elif name is not None and "spill stores" in ln:
            words = ln.replace(",", "").split()
            out[name]["spill_bytes"] = int(words[words.index("spill") - 2]) + int(
                words[words.index("loads") - 3])
        elif name is not None and "Used" in ln and "registers" in ln:
            words = ln.replace(",", "").split()
            out[name]["registers"] = int(words[words.index("registers") - 1])
            out[name]["smem_bytes"] = (int(words[words.index("smem") - 2])
                                       if "smem" in words else 0)
            name = None
    return out


def update_resources() -> dict:
    """ptxas's counts of K3's update kernels (``ptxas_counts``) in the
    sinkhorn library this run loaded."""
    from nfdpf_torch.ops.cuda import build

    out = ptxas_counts(build.build_log["sinkhorn"]["ptxas"],
                       r"sinkhorn_update(?:_batch)?_kernel")
    for kernel in ["sinkhorn_update_kernel"] + [f"sinkhorn_update_batch_kernel<{k}>"
                                                for k in (1, 2, 4, 8)]:
        if "registers" not in out.get(kernel, {}):
            raise AssertionError(f"the sinkhorn library's ptxas report names no {kernel} "
                                 f"with its registers: {out}")
    return out


def chain_resources(hidden: int) -> dict:
    """Registers, spilled bytes and static shared memory of each coupling
    kernel (``-Xptxas -v`` of the library this run loaded), by kernel and
    instantiation.  Raises where the report names no forward and backward
    kernel in both directions, or a context kernel, with its registers."""
    from nfdpf_torch.ops.cuda import build
    from nfdpf_torch.ops.cuda import coupling_cuda as cc

    text = build.build_log[" ".join(("coupling",) + cc.build_defines(hidden))]["ptxas"]
    out = ptxas_counts(text, r"chain_(?:fwd|bwd|ctx_share|ctx_grad_rows|ctx_weight_grad|"
                             r"ctx_input_grad)_kernel")
    for kernel in ("chain_fwd_kernel", "chain_bwd_kernel"):
        for direction in ("forward", "inverse"):
            if not any(k.startswith(kernel) and k.endswith(f"{direction}>") and "registers" in r
                       for k, r in out.items()):
                raise AssertionError(f"the coupling library's ptxas report names no {kernel} "
                                     f"({direction}) with its registers: {out}")
    tiles = ["chain_ctx_input_grad_kernel<{}, {}, {}>".format(*tile) for tile in cc.CTX_IN_TILES]
    for kernel in ["chain_ctx_share_kernel<1>", "chain_ctx_share_kernel<16>",
                   "chain_ctx_grad_rows_kernel", "chain_ctx_weight_grad_kernel"] + tiles:
        if "registers" not in out.get(kernel, {}):
            raise AssertionError(f"the coupling library's ptxas report names no {kernel} with "
                                 f"its registers: {out}")
    return out


def wide_resources() -> dict:
    """ptxas's counts (``ptxas_counts``) of the wide library's kernels: the
    wide pair's instantiations and its context kernels.  Raises where the
    report names a wide kernel of some tile shape or direction without
    its registers."""
    from nfdpf_torch.ops.cuda import build
    from nfdpf_torch.ops.cuda import coupling_cuda as cc

    text = build.build_log[" ".join(("coupling",) + cc.build_defines(cc.WIDE_BUILD))]["ptxas"]
    out = ptxas_counts(text, r"chain_(?:fwd_wide|bwd_wide|ctx_share|ctx_grad_rows|"
                             r"ctx_weight_grad|ctx_input_grad)_kernel")
    for kernel, tiles in (("chain_fwd_wide_kernel", cc.WIDE_FWD_TILES),
                          ("chain_bwd_wide_kernel", cc.WIDE_BWD_TILES)):
        for tm, tn in sorted({t[1:3] for t in tiles}):
            for direction in ("forward", "inverse"):
                name = f"{kernel}<{tm}, {tn}, {direction}>"
                if "registers" not in out.get(name, {}):
                    raise AssertionError(f"the wide library's ptxas report names no {name} with "
                                         f"its registers: {out}")
    return out


def launch_record(fn, note) -> dict:
    """Registers per thread, shared memory per block (static and dynamic),
    grid and block of the one launch of a kernel that ``fn`` makes, as the
    kernel's library noted the launch (``note``: its ``launch_note``
    reader): the registers and static shared memory of the launched
    kernel as the runtime loaded it (cudaFuncGetAttributes), the rest from
    the launch's own arguments.  No profiler: torch.profiler's sessions
    have come back without kernel events, on a process's first session, on
    every session after another library's kernels were traced, and six
    sessions running in a whole run.  Raises unless the library noted
    exactly one launch of the kernel during ``fn``."""
    before = note()["launches"]
    fn()
    torch.cuda.synchronize()
    rec = note()
    if rec["launches"] - before != 1:
        raise AssertionError(f"{rec['kernel'] or 'the kernel'}: the library noted "
                             f"{rec['launches'] - before} launches during one call, not 1")
    return {"kernel": rec["kernel"], "registers": rec["registers"],
            "smem_bytes_per_block": rec["smem_static_bytes"] + rec["smem_dynamic_bytes"],
            "grid": rec["grid"], "block": rec["block"]}


def kernel_cases(b: int, n: int, seed: int):
    """Inputs shaped like the resampler's at (B, N): scaled coordinates,
    per-row ε between the target 0.1 and an annealing start, log-weights,
    potentials and raw particle values."""
    from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    raw = torch.rand(b, n, 2, generator=gen) * 128 - 64
    centered = raw - raw.mean(1, keepdim=True)
    x = (centered / (centered.std(1, correction=0).amax(-1)[:, None, None]
                     * math.sqrt(2))).to(dev)
    eps = torch.linspace(0.1, 2.0, b).to(dev)
    f1 = torch.log_softmax(torch.randn(b, 1, n, generator=gen), -1).to(dev)
    f2 = torch.log_softmax(torch.randn(b, 2, n, generator=gen), -1).to(dev)
    r = (torch.randn(b, n, generator=gen) * 0.1).to(dev)
    c = (torch.randn(b, n, generator=gen) * 0.1 - math.log(n)).to(dev)
    v = raw.to(dev)
    g = torch.randn(b, n, 2, generator=gen).to(dev)

    def t_mat(rows, cols, rr, cc):
        return torch.exp(rr[:, :, None] + cc[:, None, :]
                         - sc._pair_cost(rows, cols) / eps[:, None, None])

    t_fwd, t_bwd = t_mat(x, x, r, c), t_mat(x, x, c, r)
    # the (B, G, N, M) matrices K1 reduces, built here like T: the library
    # calls below time the reduction (K1) or the product (K2) alone
    neg_cost = -sc._pair_cost(x, x) / eps[:, None, None]
    s1, s2 = (f[:, :, None, :] + neg_cost[:, None] for f in (f1, f2))
    del neg_cost
    f4 = 4.0
    lse_bytes = lambda g_: f4 * (b + 4 * b * n + b * g_ * n + b * g_ * n)  # noqa: E731
    apply_bytes = f4 * (b + 4 * b * n + 2 * b * n + 2 * b * n + 2 * b * n)
    pairs = b * n * n
    return {
        "sinkhorn_lse_g1": dict(
            kernel=lambda: sc.streaming_lse_multi(eps, x, x, f1),
            plain=lambda: sc.lse_multi_plain(eps, x, x, f1),
            library=lambda: torch.logsumexp(s1, dim=-1), tol=("lse", LSE_TOL),
            nbytes=lse_bytes(1), ops=pairs * (7 + 4 * 1)),
        "sinkhorn_lse": dict(
            kernel=lambda: sc.streaming_lse_multi(eps, x, x, f2),
            plain=lambda: sc.lse_multi_plain(eps, x, x, f2),
            library=lambda: torch.logsumexp(s2, dim=-1), tol=("lse", LSE_TOL),
            nbytes=lse_bytes(2), ops=pairs * (7 + 4 * 2)),
        "transport_apply": dict(
            kernel=lambda: sc._apply(eps, x, x, v, r, c, "transport_apply"),
            plain=lambda: sc.transport_apply_plain(v, eps, x, x, r, c),
            library=lambda: torch.bmm(t_fwd, v), tol=("apply", APPLY_TOL),
            nbytes=apply_bytes, ops=pairs * 14),
        "transport_apply_bwd": dict(
            kernel=lambda: sc._apply(eps, x, x, g, c, r, "transport_apply_bwd"),
            plain=lambda: sc.transport_apply_plain(g, eps, x, x, c, r),
            library=lambda: torch.bmm(t_bwd, g), tol=("apply", APPLY_TOL),
            nbytes=apply_bytes, ops=pairs * 14),
        "_autograd": dict(v=v, g=g, eps=eps, x=x, r=r, c=c),
    }


def check(name, got, ref, tol):
    kind, t = tol
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    allowed = (t + t * ref.abs()) if kind == "lse" else (t * ref.abs() + t * scale)
    max_abs = float(err.max())
    if not bool((err <= allowed).all()) or not math.isfinite(max_abs):
        raise AssertionError(f"{name}: max abs err {max_abs:.3e} exceeds {kind} tolerance {t}")
    return max_abs, max_abs / max(scale, 1e-30)


def phase_kernels():
    """Every streaming-Sinkhorn kernel against its plain version at the
    shapes of ``SINKHORN_SHAPES``, with its times; the empty kernel's time."""
    from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc

    # the same floor under every launch; the second grid is the size of the
    # kernels' own at (B=32, N=100)
    floor = device_ms(sc.empty_launch, 200)
    floor_grid = device_ms(lambda: sc.empty_launch(416, 128), 200)
    results = {}
    for (b, n), iters in SINKHORN_SHAPES:
        cases = kernel_cases(b, n, seed=b + n)
        ag = cases.pop("_autograd")
        shape = f"B{b}_N{n}"
        for name, cs in cases.items():
            got, ref = cs["kernel"](), cs["plain"]()
            torch.cuda.synchronize()
            max_abs, rel = check(f"{name}@{shape}", got, ref, cs["tol"])
            if not torch.equal(cs["kernel"](), got):
                raise AssertionError(f"{name}@{shape}: a second launch gave other bits")
            del got, ref
            bound, by = bound_ms(cs["nbytes"], cs["ops"])
            results.setdefault(name, {})[shape] = {
                "max_abs_err": max_abs, "max_rel_err": rel, "tol": cs["tol"][1],
                "ms": device_ms(cs["kernel"], iters), "launch_floor_ms": floor,
                "call_ms": call_ms(cs["kernel"], iters),
                "plain_ms": device_ms(cs["plain"], iters),
                "library_ms": device_ms(cs["library"], iters) if cs["library"] else None,
                "bound_ms": bound, "bound_by": by}
        # K2's backward through autograd: the Function vs plain autograd
        v = ag["v"].clone().requires_grad_()
        out = sc.transport_apply_rc(v, ag["eps"], ag["x"], ag["x"], ag["r"], ag["c"])
        (g_k,) = torch.autograd.grad(out, [v], ag["g"])
        v2 = ag["v"].clone().requires_grad_()
        ref = sc.transport_apply_plain(v2, ag["eps"], ag["x"], ag["x"], ag["r"], ag["c"])
        (g_p,) = torch.autograd.grad(ref, [v2], ag["g"])
        max_abs, rel = check(f"autograd_bwd@{shape}", g_k, g_p, ("apply", APPLY_TOL))
        results["transport_apply_bwd"][shape]["autograd_max_abs_err"] = max_abs
        del cases, ag
        torch.cuda.empty_cache()
    log({"phase": "kernels", "results": results, "launch_floor_ms": floor,
         "launch_floor_416x128_ms": floor_grid,
         "note": "no single PyTorch call computes K1 or K2 from the coordinates: library_ms "
                 "is torch.logsumexp (K1) or torch.bmm (K2) on a (B, G, N, M) matrix or a T "
                 "that was built outside the timed call, the reduction or the product alone; "
                 "launch_floor_ms is an empty kernel on 1 block of 32 threads"})
    return results


# K3 (the streaming resampler's driver) at the main path's train and eval
# batches and config 5's N, with its calls timed per shape; the filter's
# loop constants; chunk sizes timed beside LOOP_CHUNK
K3_SHAPES = (((32, 100), 20), ((10, 100), 20), ((4, 10240), 3))
K3_KW = dict(eps=0.1, scaling=0.75, threshold=1e-3, max_iter=100)
K3_AT = "B32_N100"
# chunk sizes timed at each shape (calls a timing), in turns, SWEEP_ROUNDS times
CHUNK_SWEEP = (1, 2, 4, 8, 16)
SWEEP_SHAPES = (((32, 100), 20), ((10, 100), 20), ((4, 4097), 5), ((4, 10240), 3))
SWEEP_ROUNDS = 3


def k3_bound_ms(b: int, n: int, iters: int):
    """The least time one K3 call could take on this run's data: the K1
    work (G = 2) of the cold start, each iteration and the final round, the
    column normaliser (G = 1) and K2, with the update's ~9 floats per
    particle and iteration and the inputs read once."""
    pairs = b * n * n
    ops = pairs * ((iters + 2) * (7 + 4 * 2) + (7 + 4) + 14)
    nbytes = 4.0 * (3 * b * n + iters * 9 * b * n + 2 * b * n + 2 * b * n)
    return bound_ms(nbytes, ops)


# the update kernel's checks: some rows stopped (every third flag down, ε
# from 0.05 to 3), every row running and annealing (the filter's usual
# state), and that with a NaN in one row's K1 output
UPDATE_STATES = ("stopped", "running", "nan")


def update_case(sc, b, n, convergence, state, gen, threshold=1e-3):
    """A K3 loop at (b, n) loaded as a firing would be, in ``state``, with
    K1 run on its input: the loop and the update's inputs (K1's output,
    potentials, flags, ε, target ε, log-weights)."""
    dev = torch.device("cuda")
    loop = sc._Loop(b, n, dev, (threshold, 0.75**2, 100, convergence))
    scaled = (torch.randn(b, n, 2, generator=gen) * 0.5).to(dev)
    logw = torch.log_softmax(torch.randn(b, n, generator=gen), -1).to(dev)
    eps_b = torch.full((b,), 0.1, device=dev)
    eps_run = torch.linspace(0.05 if state == "stopped" else 0.2, 3.0, b).to(dev)
    a_y, b_x = ((torch.randn(b, n, generator=gen) * 0.1).to(dev) for _ in range(2))
    loop.load(scaled, logw, eps_b, eps_run, a_y, b_x)
    if state == "stopped":
        loop.running[::3] = False
    sc._launch_lse(loop.eps_run, loop.x, loop.x, loop.fs, loop.lse)
    if state == "nan":
        loop.lse[min(1, b - 1), 0, n // 2] = float("nan")
    return loop, (loop.lse.clone(), a_y, b_x, loop.running.clone(), eps_run, eps_b, logw)


def check_update(sc, loop, inputs, where: str) -> None:
    """One launch of the update kernel against its plain version: the
    potentials, flags, ε and next K1 input bit for bit (NaN where the plain
    version has one), the loop counter, the batch's all or any, the done
    flag, and the arrival count and per-row maxima back at 0."""
    lse, a_y, b_x, running, eps_run, eps_b, logw = inputs
    threshold, scaling, max_iter, convergence = loop.params
    loop.update(freeze=True)
    torch.cuda.synchronize()
    ref = sc.sinkhorn_update_plain(lse, a_y, b_x, running, eps_run, eps_b, logw, loop.uniform,
                                   threshold, scaling)
    for what, got, want in zip(("a_y", "b_x", "running", "eps_run", "fs"),
                               (loop.a_y, loop.b_x, loop.running, loop.eps_run, loop.fs), ref):
        if got.is_floating_point():
            same = torch.equal(got.isnan(), want.isnan()) and torch.equal(
                torch.nan_to_num(got), torch.nan_to_num(want))
        else:
            same = torch.equal(got, want)
        if not same:
            raise AssertionError(f"sinkhorn_update@{where}: {what} differs from the plain "
                                 "version's bits")
    agg = int(bool(ref[2].all() if convergence == "all" else ref[2].any()))
    want_state = [int(not (1 < max_iter - 1 and agg)), 1, agg, 0]
    if loop.state.tolist() != want_state or bool(loop.row_max.any()):
        raise AssertionError(f"sinkhorn_update@{where}: state {loop.state.tolist()} (expected "
                             f"{want_state}), row maxima left {loop.row_max.count_nonzero()}")


def update_launch() -> dict:
    """Registers and shared memory of the update kernel's launch at the
    kernels line's case, every row running (``launch_record``); raises
    unless the launched kernel is the one the wrapper's plan names."""
    from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc

    b, n = (int(v) for v in AT["sinkhorn_update"][1:].split("_N"))
    loop, _ = update_case(sc, b, n, "all", "running", torch.Generator().manual_seed(3),
                          threshold=-1.0)
    loop.update(freeze=False)
    rec = launch_record(lambda: loop.update(freeze=False), sc.update_launch_note)
    planned = ("sinkhorn_update_batch_kernel<{}>".format(loop.plan["cols_per_lane"])
               if loop.plan["batch"] else "sinkhorn_update_kernel")
    if rec["kernel"] != planned:
        raise AssertionError(f"sinkhorn_update@{AT['sinkhorn_update']}: the launch ran "
                             f"{rec['kernel']}, the plan names {planned}")
    return rec


def phase_k3():
    """K3 and its update kernel on the card.  The update kernel against its
    plain version (torch's ops on the card) on one iteration's K1 output,
    in each of ``UPDATE_STATES`` with all and any (``check_update``):
    potentials, flags, ε and the next K1 input bit for bit; its device ms
    on repeated launches from the "stopped" state (rows stop as the
    potentials settle) and with every row running at every launch, and its
    plan (its launch's registers and shared memory: ``update_launch``).
    K3 at ``K3_SHAPES``, cold and warm (from the cold call's potentials): at
    ``loop_chunk(N)`` iterations a graph replay against chunks of one (the
    chunk forced to ``LOOP_CHUNK`` at every N here), the
    same iterations and bits; against the driver's plain version on the card
    (the eager loop on plain K1/K2/update), the same iterations and the
    particles within K2's tolerance; each call's ms (CUDA events around
    calls that read the host), host syncs and the bound; and ms a call for
    each chunk size of ``CHUNK_SWEEP`` at ``SWEEP_SHAPES``, the sizes in
    turns, median of ``SWEEP_ROUNDS``."""
    from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc

    chunk, max_n = sc.LOOP_CHUNK, sc.LOOP_CHUNK_MAX_N
    dev = torch.device("cuda")
    update, k3, sweep = {}, {}, {}

    def cloud(b, n):
        gen = torch.Generator().manual_seed(41 + b + n)
        x = (torch.rand(b, n, 2, generator=gen) * 128 - 64).to(dev)
        return x, torch.softmax(torch.randn(b, n, generator=gen), -1).to(dev), gen

    try:
        for (b, n), calls in K3_SHAPES:
            shape = f"B{b}_N{n}"
            x, probs, gen = cloud(b, n)
            chosen = sc.loop_chunk(n)

            # the update kernel on one iteration of a loop at this shape, in
            # each state and with all and any: the plain version's bits
            for convergence in ("all", "any"):
                for state in UPDATE_STATES:
                    check_update(sc, *update_case(sc, b, n, convergence, state, gen),
                                 f"{shape}_{state}_{convergence}")
            loop, inputs = update_case(sc, b, n, "all", "stopped", gen)
            check_update(sc, loop, inputs, f"{shape}_stopped_all")
            lse_plain, a_y, b_x, running, eps_run, eps_b, logw = inputs
            bound, by = bound_ms(4.0 * (b * n * (2 + 2 + 1 + 2 + 2) + 4 * b), 14.0 * b * n)
            reps = 200 if n <= 4097 else 50
            # every row running at every launch (the filter's usual state): a
            # negative threshold keeps each row's flag up
            busy, _ = update_case(sc, b, n, "all", "running", gen, threshold=-1.0)
            busy.update(freeze=False)
            update[shape] = {
                "max_abs_err": 0.0, "bits": "equal to the plain version's",
                "checked": [f"{st}_{cv}" for cv in ("all", "any") for st in UPDATE_STATES],
                "plan": loop.plan,
                "ms": device_ms(lambda: loop.update(freeze=False), reps),
                "ms_all_running": device_ms(lambda: busy.update(freeze=False), reps),
                "plain_ms": device_ms(lambda: sc.sinkhorn_update_plain(
                    lse_plain, a_y, b_x, running, eps_run, eps_b, logw, loop.uniform, 1e-3,
                    0.75**2), reps),
                "library_ms": None, "bound_ms": bound, "bound_by": by}
            if not bool(busy.running.all()):
                raise AssertionError(f"sinkhorn_update@{shape}: a row stopped in the "
                                     "every-row-running timing")
            del loop, busy

            # K3 itself
            pots = None
            for warm in (False, True):
                kw = dict(K3_KW, return_potentials=True)
                if warm:
                    kw["warm_start"] = (pots, True)
                case = f"{shape}_{'warm' if warm else 'cold'}"
                runs = {}
                sc.LOOP_CHUNK_MAX_N = 1 << 30          # the chunk as set, at any N
                for k in sorted({1, chunk}):
                    sc.LOOP_CHUNK = k
                    sc.ot_resample_streaming(x, probs, **kw)     # the first call captures
                    sc.reset_streaming_loop()
                    out, syncs = count_syncs(lambda: sc.ot_resample_streaming(x, probs, **kw))
                    loop_counts = dict(sc.STREAMING_LOOP)
                    with torch.no_grad():
                        ms = call_ms(lambda: sc.ot_resample_streaming(x, probs, **kw), calls, 1)
                    runs[k] = (out, syncs, loop_counts, ms)
                sc.LOOP_CHUNK, sc.LOOP_CHUNK_MAX_N = chunk, max_n
                (one, syncs1, loop1, ms1), (graph, syncs_k, loop_k, ms_k) = runs[1], runs[chunk]
                if not (graph[3] == one[3] and torch.equal(graph[4], one[4])
                        and torch.equal(graph[0], one[0])):
                    raise AssertionError(f"k3@{case}: chunks of {chunk} gave {graph[3]} "
                                         f"iterations, chunks of 1 {one[3]}, or other bits")
                # the call as the filter makes it, at the chunk the rule picks for N
                with torch.no_grad():
                    ms_rule = call_ms(lambda: sc.ot_resample_streaming(x, probs, **kw), calls, 1)
                sc.reset_streaming_loop()
                plain = sc.ot_resample_streaming_plain(x, probs, **kw)
                plain_loop = dict(sc.STREAMING_LOOP)
                if plain[3] != graph[3]:
                    raise AssertionError(f"k3@{case}: {graph[3]} iterations, the plain "
                                         f"driver's {plain[3]}")
                max_abs, _ = check(f"k3@{case}", graph[0], plain[0], ("apply", APPLY_TOL))
                with torch.no_grad():
                    plain_ms = call_ms(lambda: sc.ot_resample_streaming_plain(x, probs, **kw),
                                       max(calls // 4, 1), 1)
                bound, by = k3_bound_ms(b, n, graph[3])
                k3[case] = {"iters": graph[3], "chunk": chosen, "max_abs_err": max_abs,
                            "ms": ms_rule, f"ms_chunk_{chunk}": ms_k, "ms_chunk_1": ms1,
                            "plain_ms": plain_ms,
                            "syncs": syncs_k if chosen == chunk else syncs1,
                            f"syncs_chunk_{chunk}": syncs_k, "syncs_chunk_1": syncs1,
                            f"host_reads_chunk_{chunk}": loop_k["host_reads"],
                            "host_reads_chunk_1": loop1["host_reads"],
                            "host_reads_plain": plain_loop["host_reads"],
                            "library_ms": None, "bound_ms": bound, "bound_by": by}
                pots = graph[4]
                torch.cuda.empty_cache()
        sc.LOOP_CHUNK_MAX_N = 1 << 30
        for (b, n), calls in SWEEP_SHAPES:
            x, probs, _ = cloud(b, n)
            times = {k: [] for k in CHUNK_SWEEP}
            for _ in range(SWEEP_ROUNDS):
                for k in CHUNK_SWEEP:
                    sc.LOOP_CHUNK = k
                    sc.ot_resample_streaming(x, probs, **K3_KW)
                    with torch.no_grad():
                        times[k].append(call_ms(
                            lambda: sc.ot_resample_streaming(x, probs, **K3_KW), calls, 1))
            sweep[f"B{b}_N{n}"] = {k: statistics.median(v) for k, v in times.items()}
    finally:
        sc.LOOP_CHUNK, sc.LOOP_CHUNK_MAX_N = chunk, max_n
    log({"phase": "k3", "chunk": chunk, "chunk_max_n": max_n, "update": update, "k3": k3,
         "chunk_sweep_ms": sweep,
         "note": "K3's ms are CUDA events around back-to-back calls, host reads included; "
                 "plain_ms the driver's plain version (eager loop on plain K1/K2/update, "
                 "materialised costs) on the card; the update kernel's by CUDA-graph "
                 "replay, its plain version torch's ops on the card; no single PyTorch "
                 "call computes either: library_ms null"})
    return update, k3


def chain_ops(rows: int, n_blocks: int, hidden: int) -> float:
    """fp32 operations one pass of K4 needs: per row and MLP the products of
    layers 0 (the half's column), 1 and 2 (multiply and add counted apart),
    the bias adds (layer 0's is P, the context's share) and 2·H tanh (one
    each); per row and block four MLPs, two exp and six more for the affine
    updates.  The context's share of layer 0 is the context-share kernel's
    work (``share_ops``)."""
    h = hidden
    mlp_row = 2 * h + 2 * h * h + 2 * h + 2 * h + 1 + 2 * h
    return float(rows) * n_blocks * (4 * mlp_row + 8)


def share_ops(ctx_rows: int, n_blocks: int, ctx_dim: int, hidden: int) -> float:
    """fp32 operations of the context share: per distinct context row and
    each of the 4K·H entries of P, C multiply-adds and the bias."""
    return float(ctx_rows) * 4 * n_blocks * hidden * (2 * ctx_dim + 1)


def phase_chain_kernels(n_blocks: int, hidden: int, phase: str = "chain_kernels",
                        record: bool = True):
    """K4 (forward kernel) and K5 (backward kernel) of the coupling chain,
    through the wrapper the filter calls, against the plain version and its
    autograd, both directions; each launched again for equal bits.  At the
    kernels line's case, each timed launch's registers and shared memory
    (``launch_record``); the shared memory must be what the wrapper's
    mirror of the kernel's layout says (the limits it refuses by).  Without
    ``record`` no launch is recorded (ptxas gives the registers).  With
    a context, the context kernels alone against their plain versions
    (the share to ``CHAIN_TOL``, the gradients, from K5's g1, to
    ``CHAIN_GRAD_TOL``), equal bits on a second launch, with their times and
    one library call's each; with ``record`` also the context kernels' edge
    cases (``CTX_EDGES``) and their launches back to back, and the share's,
    the weight gradients' and the input gradient's shared memory at the
    kernels line's case against the wrapper's mirror."""
    from nfdpf_torch.models.nets import flax_init_
    from nfdpf_torch.ops.cuda import coupling_cuda as cc
    from nfdpf_torch.ops.flows import realnvp_chain

    dev = torch.device("cuda")
    results = {}
    # (B, N, C, context broadcast over the particles as the filter passes it,
    # timing iterations): the dynamics flow's context (4), the CNF-DPF
    # proposal's (36) and the CGLOW proposal's (196), each at the train and
    # the eval batch; a dense context and none at a ragged large N
    for b, n, c, broadcast, iters in ((32, 100, 4, True, 200), (32, 100, 36, True, 200),
                                      (32, 100, 196, True, 200),
                                      (10, 100, 4, True, 200), (10, 100, 36, True, 200),
                                      (10, 100, 196, True, 200),
                                      (4, 4097, 36, False, 20), (4, 4097, 0, False, 20)):
        gen = torch.Generator().manual_seed(1000 * b + n + c)
        chain = realnvp_chain(n_blocks, 2, hidden, 0.3, ctx_dim=c)
        flax_init_(chain, gen)                      # weights N(0, 0.3²): a flow far from identity
        for name, p in chain.named_parameters():
            if name.endswith("bias"):
                p.data.normal_(0.0, 0.1, generator=gen)
        chain.to(dev)
        x = torch.randn(b, n, 2, generator=gen).to(dev)
        ctx_base = ctx = None
        if c:
            ctx_base = torch.randn(b, 1 if broadcast else n, c, generator=gen).to(dev)
            ctx = ctx_base.expand(b, n, c)
        gy = torch.randn(b, n, 2, generator=gen).to(dev)
        gld = torch.randn(b, n, generator=gen).to(dev)
        # the same cotangent as a strided view: the wrapper must take it as it comes
        gy_wide = torch.zeros(b, n, 4, device=dev)
        gy_wide[..., ::2] = gy
        gy_strided = gy_wide[..., ::2]
        with torch.no_grad():
            w, bias = (t.contiguous() for t in cc.pack_chain_params(chain))
            p_rows, mode = cc._launch_ctx_share(cc._chain_library(n_blocks, hidden), ctx, w, bias)
        rows, f4 = b * n, 4.0
        ctx_rows = b if broadcast else rows
        ps = 4 * n_blocks * hidden
        params_bytes = f4 * (w.numel() + bias.numel())
        p_bytes = f4 * p_rows.numel()
        ops_fwd = chain_ops(rows, n_blocks, hidden)

        for inverse in (False, True):
            case = f"B{b}_N{n}_C{c}_{'inverse' if inverse else 'forward'}"

            def module_fwd():
                return chain.inverse(x, ctx) if inverse else chain(x, ctx)[::2]

            def fwd_bwd(fn, want_ctx, cot_y=gy, with_ld=True):
                """(y, log_det, gradients of x, w, bias[, ctx]) through ``fn``
                and ordinary autograd, for the cotangents (cot_y, gld) or,
                without ``with_ld``, for y alone (log_det unused)."""
                leaves = [t.detach().clone().requires_grad_() for t in (x, w, bias)]
                # the context keeps its layout (a broadcast stays a view): the
                # kernels read it once per distinct context row
                c_leaf = ctx_base.detach().clone().requires_grad_() if want_ctx else None
                c_in = c_leaf.expand(b, n, c) if want_ctx else ctx
                y, ld = fn(leaves[0], c_in, leaves[1], leaves[2], inverse)
                wanted = leaves + ([c_leaf] if want_ctx else [])
                if with_ld:
                    grads = torch.autograd.grad([y, ld], wanted, [cot_y, gld])
                else:
                    grads = torch.autograd.grad(y, wanted, cot_y)
                return y.detach(), ld.detach(), grads

            def module_fwd_bwd():
                y, ld = module_fwd()
                return torch.autograd.grad([y, ld], list(chain.parameters()), [gy, gld])

            def k4():
                return cc._launch_forward(x, p_rows, mode, w, bias, inverse)

            def k5():
                return cc._launch_backward(x, p_rows, mode, w, bias, gy, gld, inverse, c > 0)

            # ---- K4 and K5 through fused_coupling_chain and its autograd
            # Function: every gradient, the context's too, from a strided
            # cotangent; then as the filter calls it (a detached context asks
            # for no gradient); then with log_det unused (its cotangent
            # arrives as zeros)
            want_ctx = ctx is not None
            cc.reset_launches()
            y, ld, grads = fwd_bwd(cc.fused_coupling_chain, want_ctx, gy_strided)
            _, _, grads_no_ctx = fwd_bwd(cc.fused_coupling_chain, False)
            _, _, grads_y_only = fwd_bwd(cc.fused_coupling_chain, want_ctx, with_ld=False)
            torch.cuda.synchronize()
            counts = dict(cc.LAUNCHES)
            fwd_name = "coupling_chain_inverse" if inverse else "coupling_chain"
            want = {fwd_name: 3, "coupling_chain_bwd": 3, "coupling_ctx_share": 3,
                    "coupling_ctx_grad_rows": 3 if c else 0,
                    "coupling_ctx_weight_grad": 3 if c else 0,
                    "coupling_ctx_input_grad": 2 if c else 0}
            if {k: v for k, v in counts.items() if v} != {k: v for k, v in want.items() if v}:
                raise AssertionError(f"chain@{case}: the wrapper launched {counts}, expected "
                                     f"{want}")
            y_ref, ld_ref, refs = fwd_bwd(cc.chain_apply_packed_plain, want_ctx)
            _, _, refs_y_only = fwd_bwd(cc.chain_apply_packed_plain, want_ctx, with_ld=False)
            with torch.no_grad():
                y_mod, ld_mod = module_fwd()
            torch.cuda.synchronize()
            errs = [check(f"chain_fwd.{k}@{case}", got, ref, ("lse", CHAIN_TOL))
                    for k, got, ref in (("y", y, y_ref), ("ld", ld, ld_ref),
                                        ("y_module", y, y_mod), ("ld_module", ld, ld_mod))]
            # the eval route (no autograd) launches the same kernels: the same bits
            with torch.no_grad():
                y_again, ld_again = cc.fused_coupling_chain(x, ctx, w, bias, inverse)
            if not (torch.equal(y_again, y) and torch.equal(ld_again, ld)):
                raise AssertionError(f"chain_fwd@{case}: a second launch gave other bits")
            bound, by = bound_ms(f4 * rows * (2 + 2 + 1) + p_bytes + params_bytes, ops_fwd)
            with torch.no_grad():
                results.setdefault("coupling_chain", {})[case] = {
                    "max_abs_err": max(e[0] for e in errs), "tol": CHAIN_TOL,
                    "ms": device_ms(k4, iters), "call_ms": call_ms(k4, iters),
                    "plain_ms": device_ms(
                        lambda: cc.chain_apply_packed_plain(x, ctx, w, bias, inverse), iters),
                    "module_ms": device_ms(module_fwd, iters),
                    "library_ms": None, "bound_ms": bound, "bound_by": by}
                if record and case == AT["coupling_chain"]:
                    rec = launch_record(k4, lambda: cc.launch_note(w.shape[-1],
                                                                   "coupling_chain"))
                    rows_b = cc.FWD_ROWS_PER_BLOCK
                    segments = 1 if not c else min(rows_b, (rows_b - 1) // n + 2) if broadcast \
                        else rows_b
                    rec["mirror_smem_bytes"] = cc.fwd_smem_bytes(n_blocks, hidden, segments)
                    results["coupling_chain"][case].update(rec)

            names = ["gx", "gw", "gb"] + (["gctx"] if want_ctx else [])
            errs = {k: check(f"chain_bwd.{k}@{case}", got, ref, ("apply", CHAIN_GRAD_TOL))
                    for k, got, ref in zip(names, grads, refs)}
            errs_y_only = [check(f"chain_bwd.{k}(log_det unused)@{case}", got, ref,
                                 ("apply", CHAIN_GRAD_TOL))
                           for k, got, ref in zip(names, grads_y_only, refs_y_only)]
            if not all(torch.equal(a, g) for a, g in zip(grads_no_ctx, grads)):
                raise AssertionError(f"chain_bwd@{case}: a second launch gave other bits")
            g1_bytes = f4 * rows * ps if c else 0.0
            bound, by = bound_ms(f4 * rows * (2 + 2 + 1 + 2) + p_bytes + g1_bytes
                                 + 2 * params_bytes, 3 * ops_fwd)
            results.setdefault("coupling_chain_bwd", {})[case] = {
                "max_abs_err": max(e[0] for e in list(errs.values()) + errs_y_only),
                "max_rel_err": {k: e[1] for k, e in errs.items()}, "tol": CHAIN_GRAD_TOL,
                "ms": device_ms(k5, iters), "call_ms": call_ms(k5, iters),
                # the plain version's forward and autograd backward, eager calls
                "plain_ms": call_ms(lambda: fwd_bwd(cc.chain_apply_packed_plain, False),
                                    max(iters // 4, 3)),
                "kernels_fwd_bwd_ms": call_ms(lambda: fwd_bwd(cc.fused_coupling_chain, False),
                                              max(iters // 4, 3)),
                "module_fwd_bwd_ms": call_ms(module_fwd_bwd, max(iters // 4, 3)),
                "library_ms": None, "bound_ms": bound, "bound_by": by}
            if record and case == AT["coupling_chain_bwd"]:
                rec = launch_record(k5, lambda: cc.launch_note(w.shape[-1],
                                                               "coupling_chain_bwd"))
                rec["mirror_smem_bytes"] = cc.bwd_smem_bytes(n_blocks, hidden,
                                                             int(rec["block"][0]))
                results["coupling_chain_bwd"][case].update(rec)
            if c and inverse:
                results.update({name: {**results.get(name, {}), **row} for name, row in
                                context_kernel_rows(cc, ctx, w, bias, k5()[1], ctx_rows,
                                                    f"B{b}_N{n}_C{c}", iters, record).items()})
        del chain, x, ctx, ctx_base, gy, gld, gy_wide, gy_strided, w, bias, p_rows
        torch.cuda.empty_cache()
    if record:
        for name, rows in context_kernel_edges(cc).items():
            results[name].update(rows)
    for name in ("coupling_chain", "coupling_chain_bwd", "coupling_ctx_share",
                 "coupling_ctx_grad_rows", "coupling_ctx_weight_grad",
                 "coupling_ctx_input_grad") if record else ():
        rec = results[name][AT[name]]
        if rec["smem_bytes_per_block"] != rec["mirror_smem_bytes"]:
            raise AssertionError(f"{name}@{AT[name]}: the launch took {rec['smem_bytes_per_block']} "
                                 f"bytes of shared memory, the wrapper's mirror says "
                                 f"{rec['mirror_smem_bytes']}")
    log({"phase": phase, "hidden": hidden, "results": results,
         "note": "checked through fused_coupling_chain and its autograd Function; no single "
                 "PyTorch call computes a coupling chain: library_ms null; module_ms is the "
                 "same call through the FlowChain module; plain_ms, kernels_fwd_bwd_ms and "
                 "module_fwd_bwd_ms of the backward are eager forward + autograd calls (CUDA "
                 "events), the other times CUDA-graph replays of the kernel's launcher; "
                 "registers and smem_bytes_per_block (static + dynamic) of one launch as "
                 "its library noted it, mirror_smem_bytes the wrapper's; the "
                 "context kernels' library_ms is one torch.addmm / torch.mm on operands laid "
                 "out outside the timed call; their edge cases (CTX_EDGES) are timed over "
                 f"{CTX_EDGE_ITERS} replays on random g1, plan is the wrapper's launch plan"})
    return results


# the context kernels whose launch is recorded at the kernels line's case,
# with the name ptxas gives their kernel
CTX_RECORDED = {"coupling_ctx_share": "chain_ctx_share_kernel",
              "coupling_ctx_grad_rows": "chain_ctx_grad_rows_kernel",
              "coupling_ctx_weight_grad": "chain_ctx_weight_grad_kernel",
              "coupling_ctx_input_grad": "chain_ctx_input_grad_kernel"}


def context_plans(cc, ctx, w) -> dict:
    """The wrapper's launch plans of the redesigned context kernels for this
    context and packed chain, each with its shared memory per block as the
    wrapper's mirror gives it: the share, the weight gradient's two
    kernels (one plan) and the input gradient."""
    b, n, c = ctx.shape
    n_blocks, hidden = w.shape[0], w.shape[-1]
    mode, r = cc.context_layout(ctx)
    share = cc.ctx_share_plan(r, n_blocks, hidden, c)
    grad = cc.ctx_weight_grad_plan(b * n, n, mode, c, 4 * n_blocks * hidden)
    gctx = cc.ctx_input_grad_plan(b * n, c, 4 * n_blocks * hidden)
    return {"coupling_ctx_share": (share, share["smem_bytes"]),
            "coupling_ctx_grad_rows": (grad, grad["smem_bytes1"]),
            "coupling_ctx_weight_grad": (grad, grad["smem_bytes2"]),
            "coupling_ctx_input_grad": (gctx, gctx["smem_bytes"])}


def context_kernel_rows(cc, ctx, w, bias, g1, ctx_rows: int, case: str, iters: int,
                        record: bool = False) -> dict:
    """The context kernels alone at one case, from K5's g1 (the share, the
    weight gradient's first kernel and both together, the input gradient): each
    against its plain version, equal bits on a second launch, device ms
    (CUDA-graph replay), the plain version's, one library call's that
    computes the same function, and the bound; the two redesigned ones with
    their launch plan and, with ``record`` at the kernels line's case, their
    launch's registers and shared memory (``launch_record``) beside the
    wrapper's mirror."""
    b, n, c = ctx.shape
    n_blocks, hidden = w.shape[0], w.shape[-1]
    rows, ps, f4 = b * n, 4 * n_blocks * hidden, 4.0
    # the library calls' operands, laid out outside the timed calls
    w_ctx = w[:, :, 0, 1:1 + c].permute(2, 0, 1, 3).reshape(c, ps).contiguous()
    bias0 = bias[:, :, 0].reshape(1, ps).contiguous()
    ctx_rows_t = (ctx[:, 0] if ctx.stride(1) == 0 else ctx.reshape(rows, c)).contiguous()
    ctx_per_row = ctx.reshape(rows, c).contiguous()
    # the weight gradient's first kernel folds g1 into parts: one torch.sum
    # over the pieces of each context row, or one torch.bmm of each chunk's
    # context rows against its rows of g1 (operands padded outside the call)
    grad = cc.ctx_weight_grad_plan(rows, n, cc.context_layout(ctx)[0], c, ps)
    rpb, parts = grad["rows_per_block"], grad["parts"]
    if grad["segments"]:
        g_pad = torch.nn.functional.pad(g1.reshape(b, n, ps), (0, 0, 0, grad["pieces"] * rpb - n))
        g_pad = g_pad.reshape(parts, rpb, ps)

        def fold_library():
            return torch.sum(g_pad, 1)
    else:
        pad = parts * rpb - rows
        g_pad = torch.nn.functional.pad(g1, (0, 0, 0, pad)).reshape(parts, rpb, ps)
        c_pad = torch.nn.functional.pad(ctx_per_row, (0, 0, 0, pad)).reshape(parts, rpb, c)
        c_pad_t = c_pad.transpose(1, 2).contiguous()

        def fold_library():
            return torch.bmm(c_pad_t, g_pad)
    cases = {
        "coupling_ctx_share": dict(
            kernel=lambda: cc.ctx_share(ctx, w, bias),
            plain=lambda: cc.ctx_share_plain(ctx, w, bias),
            library=lambda: torch.addmm(bias0, ctx_rows_t, w_ctx), tol=("lse", CHAIN_TOL),
            nbytes=f4 * (ctx_rows * c + 4 * n_blocks * (c + 1) * hidden + ctx_rows * ps),
            ops=share_ops(ctx_rows, n_blocks, c, hidden)),
        "coupling_ctx_grad_rows": dict(
            kernel=lambda: cc.ctx_grad_rows(g1, ctx, w),
            plain=lambda: cc.ctx_grad_rows_plain(g1, ctx, w),
            library=fold_library, tol=("apply", CHAIN_GRAD_TOL),
            nbytes=f4 * (rows * ps + (0 if grad["segments"] else rows * c)
                         + grad["part_floats"]),
            ops=float(rows) * ps if grad["segments"] else 2.0 * rows * c * ps),
        "coupling_ctx_weight_grad": dict(
            kernel=lambda: cc.ctx_weight_grad(g1, ctx, w),
            plain=lambda: cc.ctx_weight_grad_plain(g1, ctx, w),
            library=lambda: torch.mm(ctx_per_row.t(), g1), tol=("apply", CHAIN_GRAD_TOL),
            nbytes=f4 * (rows * ps + ctx_rows * c + c * ps),
            ops=float(rows - ctx_rows) * ps + 2.0 * ctx_rows * c * ps),
        "coupling_ctx_input_grad": dict(
            kernel=lambda: cc.ctx_input_grad(g1, w, c),
            plain=lambda: cc.ctx_input_grad_plain(g1, w, c),
            library=lambda: torch.mm(g1, w_ctx.t()), tol=("apply", CHAIN_GRAD_TOL),
            nbytes=f4 * (rows * ps + c * ps + rows * c), ops=2.0 * rows * c * ps),
    }
    plans = context_plans(cc, ctx, w)
    out = {}
    for name, cs in cases.items():
        got, ref = cs["kernel"](), cs["plain"]()
        torch.cuda.synchronize()
        max_abs, rel = check(f"{name}@{case}", got, ref, cs["tol"])
        if not torch.equal(cs["kernel"](), got):
            raise AssertionError(f"{name}@{case}: a second launch gave other bits")
        bound, by = bound_ms(cs["nbytes"], cs["ops"])
        row = {"max_abs_err": max_abs, "max_rel_err": rel, "tol": cs["tol"][1],
               "ms": device_ms(cs["kernel"], iters), "plain_ms": device_ms(cs["plain"], iters),
               "library_ms": device_ms(cs["library"], iters), "bound_ms": bound, "bound_by": by}
        if name in plans:
            plan, mirror = plans[name]
            row["plan"] = plan
            if record and case == AT[name]:
                row.update(launch_record(cs["kernel"],
                                         lambda: cc.launch_note(hidden, name)))
                row["mirror_smem_bytes"] = mirror
        out[name] = {case: row}
    return out


# edge cases of the redesigned context kernels, as (B, N, C, context
# broadcast over the particles, chain blocks K, hidden H, the context a
# non-contiguous view): ragged row counts (dense and broadcast), C = 1 and
# 197 on both routes of the weight gradient, the widest rows of g1 (4K·H =
# 256 at K = 8, H = 8; 192 at K = 3, H = 16), a broadcast over too few
# particles for the segment sums, a dense context read through strides, and
# C around the input gradient's 64-entry tile
CTX_EDGES = (("B3_N1037_C36_dense", 3, 1037, 36, False, 2, 8, False),
             ("B3_N33_C36", 3, 33, 36, True, 2, 8, False),
             ("B32_N100_C1", 32, 100, 1, True, 2, 8, False),
             ("B32_N100_C197", 32, 100, 197, True, 2, 8, False),
             ("B3_N1037_C1_dense", 3, 1037, 1, False, 2, 8, False),
             ("B3_N1037_C197_dense", 3, 1037, 197, False, 2, 8, False),
             ("B32_N100_C36_K8", 32, 100, 36, True, 8, 8, False),
             ("B3_N1037_C36_dense_K8", 3, 1037, 36, False, 8, 8, False),
             ("B32_N100_C196_K3_H16", 32, 100, 196, True, 3, 16, False),
             ("B3_N1037_C36_dense_K3_H16", 3, 1037, 36, False, 3, 16, False),
             ("B64_N5_C36", 64, 5, 36, True, 2, 8, False),
             ("B3_N1037_C36_dense_view", 3, 1037, 36, False, 2, 8, True),
             ("B32_N100_C63", 32, 100, 63, True, 2, 8, False),
             ("B3_N1037_C64_dense", 3, 1037, 64, False, 2, 8, False),
             ("B3_N33_C65_K8", 3, 33, 65, True, 8, 8, False))
CTX_EDGE_ITERS = 50


def context_case(b, n, c, broadcast, n_blocks, hidden, view, seed):
    """A packed chain's parameters (``pack_chain_params``' layout, N(0, 0.3²)
    where the chain reads, biases N(0, 0.1²)), a (B, N, C) context (one row
    per batch element broadcast over the particles, or dense; with ``view``
    the context entries 5..5+C of a (N, B, C+9) tensor, transposed) and
    rows of g1 (B·N, 4K·H), on the card."""
    gen = torch.Generator().manual_seed(seed)
    max_in = max(1 + c, hidden)
    w = torch.zeros(n_blocks, 4, 3, max_in, hidden)
    w[:, :, 0, :1 + c] = torch.randn(n_blocks, 4, 1 + c, hidden, generator=gen) * 0.3
    w[:, :, 1, :hidden] = torch.randn(n_blocks, 4, hidden, hidden, generator=gen) * 0.3
    w[:, :, 2, :hidden, 0] = torch.randn(n_blocks, 4, hidden, generator=gen) * 0.3
    bias = torch.randn(n_blocks, 4, 3, hidden, generator=gen) * 0.1
    if view:
        ctx = torch.randn(n, b, c + 9, generator=gen).cuda().permute(1, 0, 2)[..., 5:5 + c]
    else:
        ctx = torch.randn(b, 1 if broadcast else n, c, generator=gen).cuda().expand(b, n, c)
    g1 = torch.randn(b * n, 4 * n_blocks * hidden, generator=gen).cuda()
    return ctx, w.cuda(), bias.cuda(), g1


def context_outputs(cc, ctx, w, bias, g1):
    """The context kernels' outputs at one case: the share, the weight
    gradient and the input gradient."""
    return (cc.ctx_share(ctx, w, bias), cc.ctx_weight_grad(g1, ctx, w),
            cc.ctx_input_grad(g1, w, ctx.shape[-1]))


def context_kernel_edges(cc) -> dict:
    """Every case of ``CTX_EDGES`` through ``context_kernel_rows`` (against
    the plain versions, bit-equal repeats, times and bounds); then stale
    state: every case's share, weight gradient and input gradient launched
    back to back with no synchronisation between, which must give each
    case's bits of its own launch (stale scratch would show)."""
    results, inputs = {}, {}
    for k, (case, b, n, c, broadcast, n_blocks, hidden, view) in enumerate(CTX_EDGES):
        ctx, w, bias, g1 = context_case(b, n, c, broadcast, n_blocks, hidden, view, 7000 + k)
        if view and (ctx.is_contiguous() or ctx.stride(1) == 0):
            raise AssertionError(f"{case}: the context is not a strided dense view")
        rows = context_kernel_rows(cc, ctx, w, bias, g1, b if broadcast else b * n, case,
                                   CTX_EDGE_ITERS)
        for name, row in rows.items():
            results.setdefault(name, {}).update(row)
        with torch.no_grad():
            inputs[case] = (ctx, w, bias, g1, context_outputs(cc, ctx, w, bias, g1))
    torch.cuda.synchronize()
    with torch.no_grad():
        again = {case: context_outputs(cc, ctx, w, bias, g1)
                 for case, (ctx, w, bias, g1, _) in inputs.items()}
    torch.cuda.synchronize()
    for case, (_, _, _, _, alone) in inputs.items():
        if not all(torch.equal(a, b) for a, b in zip(again[case], alone)):
            raise AssertionError(f"context kernels@{case}: launched back to back with the other "
                                 f"edge cases they gave other bits")
    for name in results:
        for case in inputs:
            results[name][case]["back_to_back_bits_equal"] = True
    return results


# the wide pair's cases as (hidden, blocks): four blocks at 12 (the narrow
# backward's factor tile), 17, 32 at four and nine blocks, 64 at twelve and
# 256, each at the filter's (32, 100) with the dynamics flow's, the
# proposal's and the CGLOW proposal's context broadcast over the particles;
# 512 and 1,024 (the widest tiles) there with the proposal's context; at two
# of them a dense 36-wide context and none at a ragged large N
WIDE_CHAINS = ((12, 4), (17, 2), (32, 4), (32, 9), (64, 12), (256, 2))
WIDE_CONTEXTS = (4, 36, 196)
WIDE_LARGE = ((512, 2), (1024, 2))
WIDE_DENSE = ((32, 4), (64, 12))
WIDE_SPILL_FREE = 256   # hidden widths up to this: the launched instantiation spills nothing
WIDE_ITERS = 20     # CUDA-graph replays a timed kernel call; eager plain/module calls: 3


def wide_chain(n_blocks: int, hidden: int, ctx_dim: int, gen):
    """A ``FlowChain`` whose weights are N(0, 0.3²·8/fan-in) where the fan-in
    passes 8 (0.3 at hidden 8, as ``chain_kernels`` draws them; at 0.3 a
    256-wide chain saturates every tanh and float32 rounding alone moves its
    outputs by 1e-3 of their size) and biases N(0, 0.1²), on the card."""
    from nfdpf_torch.ops.flows import realnvp_chain

    chain = realnvp_chain(n_blocks, 2, hidden, 0.3, ctx_dim=ctx_dim)
    with torch.no_grad():
        for layer in chain.modules():
            if isinstance(layer, torch.nn.Linear):
                fan_in = layer.in_features
                layer.weight.normal_(0.0, 0.3 * math.sqrt(8 / max(8, fan_in)), generator=gen)
                layer.bias.normal_(0.0, 0.1, generator=gen)
    return chain.cuda()


def phase_chain_kernels_wide():
    """The wide pair (``chain_fwd_wide_kernel``, ``chain_bwd_wide_kernel``)
    through ``fused_coupling_chain`` and its autograd Function, both
    directions, against the plain version and its autograd at every case of
    ``WIDE_CHAINS`` x ``WIDE_CONTEXTS``, ``WIDE_LARGE`` and ``WIDE_DENSE``: outputs to
    ``CHAIN_TOL``, every gradient (x, the context, weights, biases) to
    ``CHAIN_GRAD_TOL``, each of the case's scale (|err| <= tol·|ref| +
    tol·max|ref|), and the outputs at most twice as far from a float64 run
    of the plain version as the plain version is; a second call gives the
    same bits; each wide kernel
    launched once a call, the narrow pair never, the context-weight
    gradient's kernels once a column group of g1.  Timed at each case: the
    forward and backward launchers alone (CUDA-graph replays), the plain
    version's, the same call through the ``FlowChain`` module, the bound
    (``chain_ops``; the backward three times the forward's operations);
    each case's launches' registers and shared memory as the library noted
    them, held to the wrapper's mirror (``wide_smem_bytes``).  At hidden 8,
    two blocks (a chain both pairs take) the wide launchers against the
    narrow ones on the same P."""
    from nfdpf_torch.ops.cuda import coupling_cuda as cc

    dev, f4 = torch.device("cuda"), 4.0
    results, records = {}, {}
    cases = [(h, k, 32, 100, c, True) for h, k in WIDE_CHAINS for c in WIDE_CONTEXTS]
    cases += [(h, k, 32, 100, 36, True) for h, k in WIDE_LARGE]
    cases += [(h, k, 4, 4097, c, False) for h, k in WIDE_DENSE for c in (36, 0)]
    wide_lib = cc._library(cc.WIDE_BUILD)
    for hidden, n_blocks, b, n, c, broadcast in cases:
        gen = torch.Generator().manual_seed(7 * hidden + n_blocks + c + n)
        chain = wide_chain(n_blocks, hidden, c, gen)
        x = torch.randn(b, n, 2, generator=gen).to(dev)
        ctx_base = (torch.randn(b, 1 if broadcast else n, c, generator=gen).to(dev)
                    if c else None)
        ctx = None if ctx_base is None else ctx_base.expand(b, n, c)
        gy = torch.randn(b, n, 2, generator=gen).to(dev)
        gld = torch.randn(b, n, generator=gen).to(dev)
        with torch.no_grad():
            w, bias = (t.contiguous() for t in cc.pack_chain_params(chain))
            p_rows, mode = cc._launch_ctx_share(wide_lib, ctx, w, bias)
        if cc.narrow_pair_takes(n_blocks, hidden):
            raise AssertionError(f"({hidden}, {n_blocks}) is a chain the narrow pair takes")
        rows = b * n
        groups = len(cc.ctx_grad_groups(4 * n_blocks * hidden)) if c else 0
        params_bytes = f4 * (w.numel() + bias.numel())
        ops_fwd = chain_ops(rows, n_blocks, hidden)
        for inverse in (False, True):
            case = (f"H{hidden}_K{n_blocks}_B{b}_N{n}_C{c}{'' if broadcast or not c else '_dense'}"
                    f"_{'inverse' if inverse else 'forward'}")

            def fwd_bwd(fn, cot_y=gy):
                leaves = [t.detach().clone().requires_grad_() for t in (x, w, bias)]
                c_leaf = None if ctx_base is None else ctx_base.detach().clone().requires_grad_()
                c_in = None if c_leaf is None else c_leaf.expand(b, n, c)
                y, ld = fn(leaves[0], c_in, leaves[1], leaves[2], inverse)
                wanted = leaves + ([] if c_leaf is None else [c_leaf])
                return y.detach(), ld.detach(), torch.autograd.grad([y, ld], wanted,
                                                                    [cot_y, gld])

            def module_fwd():
                return chain.inverse(x, ctx) if inverse else chain(x, ctx)[::2]

            def module_fwd_bwd():
                y, ld = module_fwd()
                return torch.autograd.grad([y, ld], list(chain.parameters()), [gy, gld])

            def k4():
                return cc._launch_forward_wide(x, p_rows, mode, w, bias, inverse)

            def k5():
                return cc._launch_backward_wide(x, p_rows, mode, w, bias, gy, gld, inverse, c > 0)

            cc.reset_launches()
            y, ld, grads = fwd_bwd(cc.fused_coupling_chain)
            y2, ld2, grads2 = fwd_bwd(cc.fused_coupling_chain)
            torch.cuda.synchronize()
            counts = {k: v for k, v in cc.LAUNCHES.items() if v}
            fwd_name = "coupling_chain_wide_inverse" if inverse else "coupling_chain_wide"
            want = {fwd_name: 2, "coupling_chain_bwd_wide": 2, "coupling_ctx_share": 2}
            if c:
                want.update(coupling_ctx_grad_rows=2 * groups,
                            coupling_ctx_weight_grad=2 * groups, coupling_ctx_input_grad=2)
            if counts != want:
                raise AssertionError(f"chain_wide@{case}: the wrapper launched {counts}, "
                                     f"expected {want}")
            if not (torch.equal(y, y2) and torch.equal(ld, ld2)
                    and all(torch.equal(a, a2) for a, a2 in zip(grads, grads2))):
                raise AssertionError(f"chain_wide@{case}: a second call gave other bits")
            y_ref, ld_ref, refs = fwd_bwd(cc.chain_apply_packed_plain)
            # a deep chain's outputs span three decades within a case (to
            # ~700 at 12 blocks over a dense context), and where t + u·exp(s)
            # crosses zero float32 rounding leaves the plain version itself
            # percents off in relative terms: the outputs are held to
            # CHAIN_TOL of the case's scale as the gradients are, and both the
            # kernel and the plain version to a float64 run of the plain
            # version, the kernel at most twice as far from it
            errs_fwd = [check(f"chain_fwd_wide.{k}@{case}", got, ref, ("apply", CHAIN_TOL))
                        for k, got, ref in (("y", y, y_ref), ("ld", ld, ld_ref))]
            with torch.no_grad():
                y64, ld64 = cc.chain_apply_packed_plain(
                    x.double(), None if ctx is None else ctx.double(), w.double(),
                    bias.double(), inverse)
            f64 = {who: max(float((a.double() - r).abs().max()) for a, r in zip(got, (y64, ld64)))
                   for who, got in (("kernel", (y, ld)), ("plain", (y_ref, ld_ref)))}
            if not f64["kernel"] <= 2 * f64["plain"] + 1e-6 * float(y64.abs().max()):
                raise AssertionError(f"chain_fwd_wide@{case}: {f64['kernel']:.3e} from a float64 "
                                     f"run, the plain version {f64['plain']:.3e}")
            names = ["gx", "gw", "gb"] + (["gctx"] if c else [])
            errs_bwd = {k: check(f"chain_bwd_wide.{k}@{case}", got, ref,
                                 ("apply", CHAIN_GRAD_TOL))
                        for k, got, ref in zip(names, grads, refs)}
            with torch.no_grad():
                fwd_plan = cc.wide_fwd_plan(rows, hidden)
                rec_fwd = launch_record(k4, lambda: cc.launch_note(cc.WIDE_BUILD,
                                                                   "coupling_chain_wide"))
                rec_fwd["mirror_smem_bytes"] = fwd_plan["smem_bytes"]
                bound, by = bound_ms(f4 * rows * (2 + 2 + 1) + f4 * p_rows.numel()
                                     + params_bytes, ops_fwd)
                results.setdefault("coupling_chain_wide", {})[case] = {
                    "max_abs_err": max(e[0] for e in errs_fwd), "tol": CHAIN_TOL,
                    "float64_err": f64,
                    "ms": device_ms(k4, WIDE_ITERS),
                    "plain_ms": device_ms(
                        lambda: cc.chain_apply_packed_plain(x, ctx, w, bias, inverse), 3),
                    "module_ms": device_ms(module_fwd, 3), "library_ms": None,
                    "bound_ms": bound, "bound_by": by, "plan": fwd_plan, **rec_fwd}
            bwd_plan = cc.wide_bwd_plan(rows, n_blocks, hidden)
            rec_bwd = launch_record(k5, lambda: cc.launch_note(cc.WIDE_BUILD,
                                                               "coupling_chain_bwd_wide"))
            rec_bwd["mirror_smem_bytes"] = bwd_plan["smem_bytes"]
            g1_bytes = f4 * rows * 4 * n_blocks * hidden if c else 0.0
            bound, by = bound_ms(f4 * rows * (2 + 2 + 1 + 2) + f4 * p_rows.numel() + g1_bytes
                                 + 2 * params_bytes, 3 * ops_fwd)
            results.setdefault("coupling_chain_bwd_wide", {})[case] = {
                "max_abs_err": max(e[0] for e in errs_bwd.values()),
                "max_rel_err": {k: e[1] for k, e in errs_bwd.items()}, "tol": CHAIN_GRAD_TOL,
                "ms": device_ms(k5, WIDE_ITERS),
                # the plain version's and the module's forward + autograd backward, eager
                "plain_ms": call_ms(lambda: fwd_bwd(cc.chain_apply_packed_plain), 3),
                "kernels_fwd_bwd_ms": call_ms(lambda: fwd_bwd(cc.fused_coupling_chain), 3),
                "module_fwd_bwd_ms": call_ms(module_fwd_bwd, 3), "library_ms": None,
                "bound_ms": bound, "bound_by": by, "plan": bwd_plan,
                "ctx_grad_groups": groups, **rec_bwd}
            for name in ("coupling_chain_wide", "coupling_chain_bwd_wide"):
                rec = results[name][case]
                if rec["smem_bytes_per_block"] != rec["mirror_smem_bytes"]:
                    raise AssertionError(f"{name}@{case}: the launch took "
                                         f"{rec['smem_bytes_per_block']} bytes of shared "
                                         f"memory, the wrapper's mirror says "
                                         f"{rec['mirror_smem_bytes']}")
                records.setdefault(name, set()).add(rec["kernel"])
        del chain, x, ctx, ctx_base, gy, gld, w, bias, p_rows
        torch.cuda.empty_cache()
    log({"phase": "chain_kernels_wide", "results": results,
         "launched": {k: sorted(v) for k, v in records.items()},
         "cross_check_h8": wide_against_narrow(),
         "note": "checked through fused_coupling_chain and its autograd Function at "
                 "CHAIN_TOL / CHAIN_GRAD_TOL of each case's scale, second calls bit-equal; "
                 "float64_err: the kernel's and the plain version's largest distance to a "
                 "float64 run of the plain version (the kernel at most twice the plain "
                 "one's); weights N(0, "
                 "0.3^2·8/fan-in), biases N(0, 0.1^2); ms: CUDA-graph replays of the "
                 "launcher (the backward's: the kernel, the sum of its partials and their "
                 "unpacking), plain_ms and module_ms of the forward the same, the "
                 "backward's plain_ms, kernels_fwd_bwd_ms and module_fwd_bwd_ms eager "
                 "forward + autograd calls (CUDA events); no single PyTorch call computes "
                 "a chain: library_ms null; registers and smem_bytes_per_block of each "
                 "case's launch as the library noted it, mirror_smem_bytes the wrapper's"})
    return results, records


def wide_against_narrow() -> dict:
    """At hidden 8, two blocks, (32, 100) with a 36-wide context broadcast
    over the particles: the wide pair's launchers against the narrow pair's
    on the same P (the wide library's share gives the narrow one's bits),
    both directions: outputs to ``CHAIN_TOL``, gx, g1 and the weight and
    bias gradients to ``CHAIN_GRAD_TOL``."""
    from nfdpf_torch.ops.cuda import coupling_cuda as cc

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(88)
    chain = wide_chain(2, 8, 36, gen)
    x = torch.randn(32, 100, 2, generator=gen).to(dev)
    ctx = torch.randn(32, 1, 36, generator=gen).to(dev).expand(32, 100, 36)
    gy = torch.randn(32, 100, 2, generator=gen).to(dev)
    gld = torch.randn(32, 100, generator=gen).to(dev)
    out = {}
    with torch.no_grad():
        w, bias = (t.contiguous() for t in cc.pack_chain_params(chain))
        p, mode = cc._launch_ctx_share(cc._library(8), ctx, w, bias)
        p_wide, _ = cc._launch_ctx_share(cc._library(cc.WIDE_BUILD), ctx, w, bias)
        if not torch.equal(p_wide, p):
            raise AssertionError("the wide library's context share gave other bits than the "
                                 "narrow one's")
        for inverse in (False, True):
            case = f"H8_K2_B32_N100_C36_{'inverse' if inverse else 'forward'}"
            errs = [check(f"wide_vs_narrow.{k}@{case}", a, r, ("lse", CHAIN_TOL))
                    for k, a, r in zip(("y", "ld"),
                                       cc._launch_forward_wide(x, p, mode, w, bias, inverse),
                                       cc._launch_forward(x, p, mode, w, bias, inverse))]
            gx, g1, gw_plain, gb = cc._launch_backward(x, p, mode, w, bias, gy, gld, inverse,
                                                       True)
            gw = torch.zeros_like(w)
            gw[:, :, :, :8] = gw_plain
            errs += [check(f"wide_vs_narrow.{k}@{case}", a, r, ("apply", CHAIN_GRAD_TOL))
                     for k, a, r in zip(("gx", "g1", "gw", "gb"),
                                        cc._launch_backward_wide(x, p, mode, w, bias, gy, gld,
                                                                 inverse, True),
                                        (gx, g1, gw, gb))]
            out[case] = {"max_abs_err": max(e[0] for e in errs)}
    return out


def phase_wide_step(row: dict, wide: dict) -> dict:
    """The wide pair's device ms a train step of ``slice_cnf_wide`` (both
    flows four 32-wide blocks at (32, 100), contexts 4 and 36 broadcast over
    the particles): its 3 train steps' launches of each wide kernel times the
    kernel's mean device ms over those cases (``chain_kernels_wide``, both
    directions), over 3; beside the slice's step median and peak memory."""
    cases = [f"H32_K4_B32_N100_C{c}_{d}" for c in (4, 36) for d in ("forward", "inverse")]
    ms = {name: statistics.mean(wide[name][case]["ms"] for case in cases)
          for name in ("coupling_chain_wide", "coupling_chain_bwd_wide")}
    launches = row["launches_train_3_steps"]
    n_fwd = launches["coupling_chain_wide"] + launches["coupling_chain_wide_inverse"]
    out = {"phase": "wide_step", "slice": row["phase"], "median_step_ms": row["median_step_ms"],
           "peak_mem_gib": row["peak_mem_gib"], "kernel_ms": ms,
           "launches_a_step": {"forward": n_fwd / 3,
                               "backward": launches["coupling_chain_bwd_wide"] / 3},
           "wide_pair_device_ms_per_step": (n_fwd * ms["coupling_chain_wide"]
                                            + launches["coupling_chain_bwd_wide"]
                                            * ms["coupling_chain_bwd_wide"]) / 3,
           "note": "launches x the kernels' CUDA-graph ms at the slice's chains, not a trace"}
    log(out)
    return out


def synthetic_batch(cfg, device, seed):
    """bench.py's synthetic batch (uniform frames, N(0, 10²) states), from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, t, w = cfg.batch_size, cfg.sequence_length, cfg.width
    return {"image": torch.rand(b, t, w, w, 3, generator=gen, device=device),
            "state": torch.randn(b, t, 4, generator=gen, device=device) * 10,
            "start_state": torch.randn(b, 4, generator=gen, device=device) * 10}


def count_syncs(fn):
    """Run ``fn`` with CUDA sync debugging on; returns (result, syncs)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return result, sum("synchroniz" in str(w.message) for w in caught)


def launch_counts():
    from nfdpf_torch.ops.cuda import coupling_cuda as cc
    from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc

    return {**sc.LAUNCHES, **cc.LAUNCHES}


def reset_launch_counts():
    from nfdpf_torch.ops.cuda import coupling_cuda as cc
    from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc

    sc.reset_launches()
    cc.reset_launches()


def dense_loop():
    from nfdpf_torch.ops import sinkhorn as ts

    return dict(ts.DENSE_LOOP)


def streaming_loop():
    from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc

    return dict(sc.STREAMING_LOOP)


def phase_slice(name: str, settings: dict, train_kernels, eval_kernels, profile: bool):
    """3 train steps and 1 eval step of one configuration through
    ``Trainer``; the launch counters are set to 0 just before each part and
    read just after; every counter named must have moved, and every other
    counter must read 0.  The dense and the streaming Sinkhorn's loop counts
    (firings, iterations, host reads) are read the same way, step by step."""
    from nfdpf_torch import DPFConfig
    from nfdpf_torch.ops import sinkhorn as ts
    from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc
    from nfdpf_torch.train import Trainer

    cfg = DPFConfig(**settings)
    trainer = Trainer(cfg)                           # on cuda: no device given
    batch = synthetic_batch(cfg, trainer.device, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    steps = []
    for i in range(3):
        ts.reset_dense_loop()
        sc.reset_streaming_loop()
        t0 = time.perf_counter()
        if i == 0:
            metrics, syncs = count_syncs(
                lambda: trainer.train_step(batch, generator=trainer.generator(10)))
        else:
            metrics = trainer.train_step(batch, generator=trainer.generator(10 + i))
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t0, "dense_loop": dense_loop(),
                      "streaming_loop": streaming_loop(),
                      **{k: float(v) for k, v in metrics.items()}})
    train_launches = launch_counts()

    reset_launch_counts()
    ts.reset_dense_loop()
    t0 = time.perf_counter()
    ev, aux = trainer.eval_step(batch, generator=trainer.generator(20))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = launch_counts()
    eval_dense = dense_loop()
    peak = torch.cuda.max_memory_allocated()

    median_s = statistics.median(s["s"] for s in steps)
    transitions = cfg.batch_size * cfg.num_particles * cfg.sequence_length
    dense_calls = sum(s["dense_loop"]["calls"] for s in steps)
    step0 = steps[0]
    row = {"phase": name, "config": settings, "step_s": [s["s"] for s in steps],
           "median_step_ms": median_s * 1e3,
           "transitions_per_s": transitions / median_s,
           "losses": [s["loss"] for s in steps], "eval_loss": float(ev["loss"]),
           "loss_pseudolik": [s["loss_pseudolik"] for s in steps],
           "eval_s": eval_s, "resample_count": [s["resample_count"] for s in steps],
           "sinkhorn_iters": [s["sinkhorn_iters"] for s in steps],
           "dense_loop_by_step": [s["dense_loop"] for s in steps],
           "dense_iters_per_firing": (sum(s["dense_loop"]["iters"] for s in steps)
                                      / dense_calls if dense_calls else None),
           "dense_loop_eval": eval_dense,
           "streaming_loop_by_step": [s["streaming_loop"] for s in steps],
           "launches_train_3_steps": train_launches, "launches_eval": eval_launches,
           # the gate read on each step; on the streaming path one read of the
           # loop's stop flag per CUDA-graph replay (and, under remat, those
           # of the backward's recomputed loops); on the dense path each loop
           # test read on the host
           "device_syncs_step0": syncs,
           "syncs_by_count_step0": cfg.sequence_length + step0["dense_loop"]["host_syncs"]
           + step0["streaming_loop"]["host_reads"],
           "peak_mem_gib": peak / 2**30}
    if profile:
        prof = profile_step(trainer, batch)
        row["profile"] = {k: v for k, v in prof.items() if k != "top"}
    log(row)
    if profile:
        row["profile"]["top"] = prof["top"]

    for s in steps:
        if not all(math.isfinite(s[k]) for k in ("loss", "loss_sup", "loss_ae")):
            raise AssertionError(f"{name}: non-finite training loss: {s}")
        if s["resample_count"] <= 0:
            raise AssertionError(f"{name}: the ESS gate never fired")
    if not math.isfinite(float(ev["loss"])):
        raise AssertionError(f"{name}: non-finite eval loss: {ev}")
    out = aux["filter_out"]
    want = (cfg.batch_size, cfg.sequence_length, cfg.num_particles)
    if out.particles.shape != want + (2,) or out.jacobians.shape != want:
        raise AssertionError(f"{name}: history shapes {tuple(out.particles.shape)}, "
                             f"{tuple(out.jacobians.shape)}")
    if not bool(torch.isfinite(out.particles).all() and torch.isfinite(out.weights).all()):
        raise AssertionError(f"{name}: non-finite particles or weights in the eval step")
    if cfg.nf_dyn and float(out.jacobians.abs().max()) == 0.0:
        raise AssertionError(f"{name}: the dynamics flow left no jacobian")
    dense = not cfg.use_pallas and cfg.resampler_type == "ot"
    if dense != (dense_calls > 0 and eval_dense["calls"] > 0):
        raise AssertionError(f"{name}: dense Sinkhorn loops {dense_calls} (train), "
                             f"{eval_dense['calls']} (eval)")
    if cfg.train_type == "SDPF" and not all(math.isfinite(s["loss_pseudolik"])
                                            and s["loss_pseudolik"] != 0 for s in steps):
        raise AssertionError(f"{name}: pseudo-likelihood {[s['loss_pseudolik'] for s in steps]}")
    for launches, kernels in ((train_launches, train_kernels), (eval_launches, eval_kernels)):
        for kernel, count in launches.items():
            if kernel in kernels and count <= 0:
                raise AssertionError(f"{name}: kernel {kernel} was not launched on the path")
            if kernel not in kernels and count != 0:
                raise AssertionError(f"{name}: kernel {kernel} launched {count} times on a "
                                     f"path that does not run it ({launches})")
    return row


def phase_remat(plain: dict, remat: dict):
    """``slice_cglow_remat`` beside ``slice_cglow`` from the same run: each
    train step's firings and Sinkhorn iterations and the first step's loss
    must be equal (remat recomputes each time step; it changes no value),
    with both slices' peak memory and step times."""
    keys = ("peak_mem_gib", "median_step_ms", "step_s", "losses", "sinkhorn_iters",
            "resample_count", "device_syncs_step0", "launches_train_3_steps")
    row = {"phase": "remat", **{k: {"slice_cglow": plain[k], "slice_cglow_remat": remat[k]}
                                for k in keys}}
    log(row)
    for k in ("sinkhorn_iters", "resample_count"):
        if plain[k] != remat[k]:
            raise AssertionError(f"remat: {k} {remat[k]}, without remat {plain[k]}")
    if plain["losses"][0] != remat["losses"][0]:
        raise AssertionError(f"remat: first-step loss {remat['losses'][0]}, without remat "
                             f"{plain['losses'][0]}")
    return row


def phase_warm_start():
    """The bootstrap slice's eval filter at full width, cold and with the
    Sinkhorn warm start, from the same parameters and draws: the first
    firing is cold either way, so it must take the same iterations; the
    later firings together at most 1.1× the cold ones (the contract of
    tests/test_filter.py's warm-start test)."""
    from nfdpf_torch import DPFConfig
    from nfdpf_torch.train import Trainer

    iters, seconds = {}, {}
    for warm in (False, True):
        cfg = DPFConfig(**dict(SLICE, sinkhorn_warm_start=warm))
        trainer = Trainer(cfg)
        batch = synthetic_batch(cfg, trainer.device, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, aux = trainer.eval_step(batch, generator=trainer.generator(20))
        torch.cuda.synchronize()
        seconds[warm] = time.perf_counter() - t0
        out = aux["filter_out"]
        if not bool(out.resampled.all() and torch.isfinite(out.particles).all()):
            raise AssertionError(f"warm_start={warm}: a step did not fire, or a "
                                 "particle is not finite")
        iters[warm] = out.sinkhorn_iters.tolist()
    cold, warm = iters[False], iters[True]
    ratio = sum(warm[1:]) / sum(cold[1:])
    log({"phase": "warm_start", "iters_cold": cold, "iters_warm": warm,
         "first_firing": [cold[0], warm[0]], "later_firings": [sum(cold[1:]), sum(warm[1:])],
         "later_ratio": ratio, "eval_s_cold": seconds[False], "eval_s_warm": seconds[True]})
    if cold[0] != warm[0]:
        raise AssertionError(f"warm start: the first firing took {warm[0]} iterations, "
                             f"cold {cold[0]}")
    if not ratio <= 1.1:
        raise AssertionError(f"warm start: the later firings took {ratio:.3f}× the cold "
                             "iterations (limit 1.1)")


def profile_step(trainer, batch):
    """Device time by kernel over one train step (torch.profiler), and the
    share of the step's wall time in which the device ran no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch, generator=trainer.generator(30))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [{"name": ev.key[:100], "device_ms": ev.self_device_time_total / 1e3,
             "count": ev.count}
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    ours = ("lse_kernel", "apply_kernel", "sinkhorn_update_batch_kernel", "sinkhorn_update_kernel",
            "chain_fwd_kernel", "chain_bwd_kernel", "chain_ctx_share_kernel",
            "chain_ctx_grad_rows_kernel", "chain_ctx_weight_grad_kernel",
            "chain_ctx_input_grad_kernel")
    groups = {**{k: 0.0 for k in ours}, "conv (cudnn)": 0.0, "gemm": 0.0, "other": 0.0}
    counts = {k: 0 for k in ours}
    conv_words = ("cudnn", "xmma", "grad_alg", "dgrad", "wgrad", "implicit_gemm", "fprop",
                  "nchwToNhwc", "nhwcToNchw")
    for r in rows:
        # whole names only: Adam's multi_tensor_apply_kernel is not K2
        key = next((k for k in ours if re.search(rf"(?<![A-Za-z0-9_]){k}\b", r["name"])),
                   None)
        if key is not None:
            counts[key] += r["count"]
        elif (any(w in r["name"] for w in ("gemm", "gemv", "splitK"))
              and not any(w in r["name"] for w in ("cudnn", "implicit_gemm", "fprop", "dgrad",
                                                    "wgrad"))):
            key = "gemm"        # dense layers, patch convolutions, batched 12×12 products
        else:
            key = "conv (cudnn)" if any(w in r["name"] for w in conv_words) else "other"
        groups[key] += r["device_ms"]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "launches": sum(r["count"] for r in rows), "by_group_ms": groups,
            "launches_by_kernel": counts,
            "top": rows[:25]}


def phase_parity(name: str, settings: dict, flow_scale: float = 1.0, cglow_std: float = 0.0):
    """One loss + backward from the same parameters, noise and
    semi-supervised mask on the card (cuda: the kernels where the path has
    them) and on the plain versions (cpu): B=4, T=10, N=100.  ``flow_scale``
    multiplies every flow's initial N(0, 0.01²) weights (the chains' and the
    CRNVP measurement's) on both sides, so the flows are not near the
    identity.  With ``cglow_std`` the CGLOW's parameters are drawn from
    N(0, cglow_std²), but for the two nets that make its 1×1 convolution's
    weights: at init the CGLOW's likelihood does not depend on the particle
    at all (its gradients are rounding residue), and drawn 1×1 weights reach
    condition numbers at which two float32 runs part (phase 6 checks those
    weights).  The gate's firings, the streaming loop's and the dense loop's
    iterations must be equal; the loss within 1e-4 (relative), each
    gradient within 1e-3 (the decoder's 1e-2) as ‖Δ‖/‖g‖.

    Under bfloat16 compute the two devices round the convolutions
    differently (cuDNN, the CPU), and over T steps that moves the Sinkhorn
    loop's stopping test by a few iterations: the firings must be equal,
    the iterations are reported, and the loss and each group's gradient
    (encoder, decoder, measurement, each chain, as one vector) are held to
    ``BF16_FACTOR`` times the distance bfloat16 itself puts between a
    float32 and a bfloat16 run on the CPU (at least ``BF16_LOSS_FLOOR``,
    ``BF16_GRAD_FLOOR``).  Every number is logged before a check fails."""
    from nfdpf_torch import DPFConfig
    from nfdpf_torch import losses as L
    from nfdpf_torch.ops import sinkhorn as ts
    from nfdpf_torch.ops.flows import FlowChain
    from nfdpf_torch.parallel import ranks as R
    from nfdpf_torch.train import Trainer

    cfg = DPFConfig(**dict(settings, batch_size=4, sequence_length=10))
    b, t, n = cfg.batch_size, cfg.sequence_length, cfg.num_particles
    gen = torch.Generator().manual_seed(3)
    batch = synthetic_batch(cfg, "cpu", seed=4)
    noise = {"init": torch.rand(b, n, 2, generator=gen) * cfg.width - cfg.width / 2,
             "motion": torch.randn(t, b, n, 2, generator=gen),
             "vel": torch.randn(b, t, 2, generator=gen),
             "resample": torch.rand(t, b, 1, generator=gen) * (1.0 / n),
             "mask": L.semi_supervised_mask(b, t, cfg.labeled_ratio, gen)}
    bf16 = cfg.compute_dtype == "bfloat16"
    runs = {}
    for run in ("cuda", "cpu") + (("cpu_float32",) if bf16 else ()):
        run_cfg, device = cfg, run.split("_")[0]
        if run == "cpu_float32":
            run_cfg = DPFConfig(**dict(settings, batch_size=4, sequence_length=10,
                                       compute_dtype="float32"))
        trainer = Trainer(run_cfg, device=device)      # same seed: same parameters
        with torch.no_grad():
            for chain in trainer.engine.modules():
                if isinstance(chain, FlowChain):
                    for p in chain.parameters():
                        p.mul_(flow_scale)
            if cglow_std:
                R.draw_cglow(trainer.engine, cglow_std)
        dev_noise = {k: v.to(device) for k, v in noise.items()}
        reset_launch_counts()
        ts.reset_dense_loop()
        loss, aux = trainer._loss({k: v.to(device) for k, v in batch.items()}, True,
                                  dev_noise)
        loss.backward()
        runs[run] = {
            "loss": loss.item(), "loss_pseudolik": aux["loss_pseudolik"].item(),
            "resampled": aux["filter_out"].resampled.tolist(),
            "iters": aux["filter_out"].sinkhorn_iters.tolist(),
            "dense_iters": ts.DENSE_LOOP["iters"],
            "launches": launch_counts(),
            "grads": {k: p.grad.detach().cpu() for k, p in trainer.engine.named_parameters()
                      if p.grad is not None}}
    gpu, cpu = runs["cuda"], runs["cpu"]
    if any(cpu["launches"].values()):
        raise AssertionError(f"{name}: the CPU run launched kernels: {cpu['launches']}")
    iters_apart = max(abs(a - c) for a, c in zip(gpu["iters"], cpu["iters"]))
    if (gpu["resampled"] != cpu["resampled"] or (iters_apart and not bf16)
            or gpu["dense_iters"] != cpu["dense_iters"]):
        raise AssertionError(f"{name}: gate/iterations differ: cuda {gpu['iters']}, dense "
                             f"{gpu['dense_iters']}; cpu {cpu['iters']}, dense "
                             f"{cpu['dense_iters']}")
    if set(gpu["grads"]) != set(cpu["grads"]):
        raise AssertionError(f"{name}: cuda and cpu give gradients to different parameters")
    for chain, used in (("nf_dyn", cfg.nf_dyn), ("cond_model", cfg.nf_cond)):
        norm = sum(float(g.abs().sum()) for k, g in cpu["grads"].items() if k.startswith(chain))
        if used and not norm > 0:
            raise AssertionError(f"{name}: no gradient reached {chain}")
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    loss_tol, bad, worst, bounds, groups = 1e-4, [], {}, {}, {}
    for pname, g_cpu in cpu["grads"].items():
        rel = float((gpu["grads"][pname] - g_cpu).norm() / g_cpu.norm().clamp_min(1e-30))
        group = "cglow" if pname.startswith("measurement.cglow.") else pname.split(".")[0]
        worst[group] = max(worst.get(group, 0.0), rel)
        bound = 1e-2 if pname.startswith("decoder.") else 1e-3
        if not bf16 and not rel <= bound:
            bad.append(f"gradient {pname}: cuda vs cpu rel err {rel:.2e} > {bound}")
    if bf16:
        f32 = runs["cpu_float32"]
        loss_tol = max(BF16_FACTOR * abs(f32["loss"] - cpu["loss"]) / abs(cpu["loss"]),
                       BF16_LOSS_FLOOR)

        def flat(grads, group):
            return torch.cat([g.ravel() for k, g in sorted(grads.items())
                              if k.split(".")[0] == group])

        for group in sorted({k.split(".")[0] for k in cpu["grads"]}):
            ref = flat(cpu["grads"], group)
            gap = float((flat(gpu["grads"], group) - ref).norm() / ref.norm().clamp_min(1e-30))
            effect = float((flat(f32["grads"], group) - ref).norm() / ref.norm().clamp_min(1e-30))
            bounds[group] = max(BF16_FACTOR * effect, BF16_GRAD_FLOOR)
            groups[group] = {"cuda_vs_cpu": gap, "cpu_float32_vs_bf16": effect}
            if not gap <= bounds[group]:
                bad.append(f"{group} gradient: cuda vs cpu {gap:.2e} > {bounds[group]:.2e}")
    if not loss_rel <= loss_tol:
        bad.append(f"loss cuda {gpu['loss']} vs cpu {cpu['loss']} (tolerance {loss_tol:.2e})")
    pl_rel = None
    if cfg.train_type == "SDPF":
        pl_rel = abs(gpu["loss_pseudolik"] - cpu["loss_pseudolik"]) / abs(cpu["loss_pseudolik"])
        if not pl_rel <= loss_tol:
            bad.append(f"pseudo-likelihood cuda {gpu['loss_pseudolik']} vs cpu "
                       f"{cpu['loss_pseudolik']}")
    if cfg.measurement == "CGLOW" and not any(
            float(g.abs().sum()) > 0 for k, g in cpu["grads"].items()
            if k.startswith("measurement.cglow.")):
        bad.append("no gradient reached the CGLOW")
    row = {"phase": name, "loss_cuda": gpu["loss"], "loss_cpu": cpu["loss"],
           "loss_pseudolik_cuda": gpu["loss_pseudolik"],
           "loss_pseudolik_cpu": cpu["loss_pseudolik"],
           "loss_rel_err": loss_rel, "loss_tol": loss_tol, "grad_rel_err_max": worst,
           "grad_tol": ({"by_group": bounds} if bf16 else {"decoder": 1e-2, "other": 1e-3}),
           "flow_scale": flow_scale, "cglow_std": cglow_std,
           "iters": gpu["iters"], "iters_cpu": cpu["iters"], "dense_iters": gpu["dense_iters"],
           "launches_cuda": gpu["launches"]}
    if bf16:
        row.update(grad_by_group=groups, loss_cpu_float32=runs["cpu_float32"]["loss"])
    log(row)
    if bad:
        raise AssertionError(f"{name}: {'; '.join(bad)}")
    return row


def phase_linalg():
    """The CGLOW's batched ``logabsdet`` and ``inv`` (plain PyTorch ops: the
    JAX package has no kernel there either) and their analytic gradients at
    the filter's (3,200, 12, 12), on the weights the first 1×1 convolution
    makes from (32, 100) particles with every CGLOW parameter drawn from
    N(0, 0.15²), against float64 ``torch.linalg`` on the CPU: per matrix
    within 1e-5 + 1e-6·cond(W) (log-determinant absolute, the rest
    ‖Δ‖/‖ref‖), the inverse's gradient, a product of two inverses, within
    1e-5 + 2e-6·cond(W).  With their device times (CUDA-graph replay) and their
    eager call times beside those of ``torch.linalg.slogdet`` / ``inv`` on
    the card (whose error checks cannot be captured in a graph)."""
    from nfdpf_torch import DPFConfig
    from nfdpf_torch.models.measurement import build_measurement_model
    from nfdpf_torch.models.nets import flax_init_
    from nfdpf_torch.ops import linalg

    model = build_measurement_model(DPFConfig(measurement="CGLOW"))
    gen = torch.Generator().manual_seed(5)
    flax_init_(model, gen)
    with torch.no_grad():
        for p in model.cglow.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.15)
        particles = torch.randn(32, 100, 2, generator=gen) * 40
        e_state = model.particle_encoder(particles).reshape(3200, 8, 8, 3)
        w = model.cglow.layer_mods[0].invconv.net(e_state).reshape(3200, 12, 12)
    g_ld = torch.randn(3200, generator=gen)
    g_inv = torch.randn(3200, 12, 12, generator=gen)
    w64 = w.double().requires_grad_()
    ld64, y64 = torch.linalg.slogdet(w64)[1], torch.linalg.inv(w64)
    (gld64,) = torch.autograd.grad(torch.sum(ld64 * g_ld.double()), [w64])
    (ginv64,) = torch.autograd.grad(torch.sum(y64 * g_inv.double()), [w64])
    cond = torch.linalg.cond(w.double())
    tol = 1e-5 + 1e-6 * cond
    dev = torch.device("cuda")
    wc = w.to(dev).requires_grad_()
    ld, y = linalg.logabsdet(wc), linalg.inv(wc)
    (gld,) = torch.autograd.grad(torch.sum(ld * g_ld.to(dev)), [wc])
    (ginv,) = torch.autograd.grad(torch.sum(y * g_inv.to(dev)), [wc])
    errs = {"logabsdet": (ld.detach().cpu().double() - ld64.detach()).abs()}
    for key, got, ref in (("inv", y, y64.detach()), ("logabsdet_grad", gld, gld64),
                          ("inv_grad", ginv, ginv64)):
        errs[key] = ((got.detach().cpu().double() - ref).norm(dim=(-2, -1))
                     / ref.norm(dim=(-2, -1)))
    # the inverse's gradient multiplies two inverses: twice the room
    ratio = {k: float((e / (tol + (1e-6 * cond if k == "inv_grad" else 0))).max())
             for k, e in errs.items()}
    wd = w.to(dev)
    row = {"phase": "linalg", "shape": list(w.shape), "cond_max": float(cond.max()),
           "cond_median": float(cond.median()),
           "max_err": {k: float(e.max()) for k, e in errs.items()},
           "max_err_over_tol": ratio,
           "tol": "1e-5 + 1e-6·cond(W) per matrix, inv_grad 1e-5 + 2e-6·cond(W)",
           "logabsdet_ms": device_ms(lambda: linalg.logabsdet(wd), 50),
           "inv_ms": device_ms(lambda: linalg.inv(wd), 50),
           "logabsdet_call_ms": call_ms(lambda: linalg.logabsdet(wd), 50),
           "inv_call_ms": call_ms(lambda: linalg.inv(wd), 50),
           "torch_slogdet_call_ms": call_ms(lambda: torch.linalg.slogdet(wd), 50),
           "torch_inv_call_ms": call_ms(lambda: torch.linalg.inv(wd), 50)}
    log(row)
    bad = [k for k, r in ratio.items() if not r <= 1.0]
    if bad:
        raise AssertionError(f"linalg: {bad} outside their tolerance: {ratio}")
    return row


# ---------------------------------------------------------------------------
# the flow library: flows no configuration reaches (plain PyTorch, as the
# JAX package writes them in plain jnp), on the card against float64 on
# the CPU
# ---------------------------------------------------------------------------

FLOW_DIM = 2                                   # the filter's state width
FLOW_ROWS = {"B32_N100": (32, 100), "B4_N10240": (4, 10240)}
FLOW_TOL = 1e-5         # outputs and log-dets: |err| <= tol + tol·|ref|
FLOW_CHAIN_TOL = 5e-5   # the mixed chain's (five float32 flows in a row)
FLOW_GRAD_TOL = 1e-4    # each gradient: ‖err‖ <= tol·‖ref‖
FLOW_SHIFT_STD = 0.1    # added to every initial parameter (ActNorm starts as the identity)
FLOW_ITERS = 20
FLOW_SYNCING_INVERSE = ("invertible_linear", "mixed_chain")   # linalg.inv reads its status


def flow_library_modules() -> dict:
    """Each flow of the library the filter does not build, at the state
    width and the defaults (hidden 8, K=5, B=3.0), ``TransitionMLP``, and a
    mixed ``FlowChain``; name → (module, has an inverse)."""
    from nfdpf_torch.models.nets import TransitionMLP
    from nfdpf_torch.ops import flows as F

    d = FLOW_DIM
    chain = F.FlowChain([F.ActNorm(d), F.InvertibleLinear(d), F.NSFCoupling(d), F.MAF(d),
                         F.NSFAutoregressive(d)])
    return {"maf": (F.MAF(d), True), "actnorm": (F.ActNorm(d), True),
            "invertible_linear": (F.InvertibleLinear(d), True), "planar": (F.Planar(d), False),
            "radial": (F.Radial(d), False), "nsf_autoregressive": (F.NSFAutoregressive(d), True),
            "nsf_coupling": (F.NSFCoupling(d), True), "transition_mlp": (TransitionMLP(d), False),
            "mixed_chain": (chain, True)}


def _flow_outputs(module, x, inverse: bool) -> tuple:
    out = module.inverse(x) if inverse else module(x)
    return out if isinstance(out, tuple) else (out,)


def _flow_loss(outs) -> torch.Tensor:
    """Σ sin(y) + Σ (each log-prob or log-det)²."""
    loss = torch.sum(torch.sin(outs[0]))
    for extra in outs[1:]:
        loss = loss + torch.sum(extra * extra)
    return loss


def _flow_grads(module, x, inverse: bool):
    """The outputs and the gradients of ``_flow_loss`` for x and every
    parameter, detached."""
    module.zero_grad()
    x = x.detach().clone().requires_grad_()
    outs = _flow_outputs(module, x, inverse)
    _flow_loss(outs).backward()
    grads = {"x": x.grad, **{n: p.grad for n, p in module.named_parameters()}}
    return [o.detach() for o in outs], grads


def aten_ops(fn) -> int:
    """How many aten ops one call of ``fn`` dispatches (views included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return Count.n


def _flow_errors(outs, grads, ref_outs, ref_grads, tol: float):
    """The outputs' largest |err| / (tol + tol·|ref|), and each gradient's
    ‖err‖ / ‖ref‖, against the float64 run."""
    out_ratio = max(float(((o.cpu().double() - r).abs() / (tol + tol * r.abs())).max())
                    for o, r in zip(outs, ref_outs))
    grad_err = {k: float((g.cpu().double() - ref_grads[k]).norm() / ref_grads[k].norm())
                for k, g in grads.items()}
    return out_ratio, grad_err


def phase_flow_library(smi: str):
    """Each module of ``flow_library_modules`` on the card in float32 at
    (32, 100) and (4, 10240) rows of the state width, forward and (where
    the JAX package has one) inverse, against the same module in float64 on
    the CPU from the same parameters and inputs: outputs, log-dets (and the
    chain's prior log-prob) within the CPU tests' tolerances (FLOW_TOL, the
    chain FLOW_CHAIN_TOL) and the gradients of the input and every
    parameter within FLOW_GRAD_TOL, or, where float32 itself sits farther
    from float64 (the spline flows' steep bins over 40,960 rows), at most
    twice as far as the module's float32 run on the CPU.  The ms of the
    forward and of forward + backward over eager calls (CUDA events: the
    host's dispatch included), and the forward's device time alone (a
    CUDA-graph replay) where nothing in it syncs, and the aten ops the
    forward dispatches.  No kernel of ours runs: every launch counter must
    still read 0."""
    import copy

    from nfdpf_torch.models.nets import flax_init_

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(19)
    rows = {}
    reset_launch_counts()
    for name, (module, invertible) in flow_library_modules().items():
        flax_init_(module, gen)
        with torch.no_grad():
            for p in module.parameters():
                p.add_(torch.randn(p.shape, generator=gen) * FLOW_SHIFT_STD)
        ref_mod = copy.deepcopy(module).double()
        card = copy.deepcopy(module).to(dev)
        tol = FLOW_CHAIN_TOL if name == "mixed_chain" else FLOW_TOL
        for at, (b, n) in FLOW_ROWS.items():
            x = torch.randn(b, n, FLOW_DIM, generator=gen) * 2.0   # some outside the tails at ±3
            xd = x.to(dev)
            xg = xd.clone().requires_grad_()
            for inverse in ((False, True) if invertible else (False,)):
                ref = _flow_grads(ref_mod, x.double(), inverse)
                out_ratio, grad_err = _flow_errors(*_flow_grads(card, xd, inverse), *ref, tol)
                cpu_ratio, cpu_grad_err = _flow_errors(*_flow_grads(module, x, inverse), *ref,
                                                       tol)

                def fwd_bwd(inverse=inverse):
                    _flow_loss(_flow_outputs(card, xg, inverse)).backward()
                with torch.no_grad():
                    ops = aten_ops(lambda: _flow_outputs(card, xd, inverse))
                    ms = call_ms(lambda: _flow_outputs(card, xd, inverse), FLOW_ITERS)
                    # the device's own time (a CUDA-graph replay) where nothing
                    # syncs: not InvertibleLinear's inverse (linalg.inv checks)
                    dev_ms = None if inverse and name in FLOW_SYNCING_INVERSE else device_ms(
                        lambda: _flow_outputs(card, xd, inverse), FLOW_ITERS)
                key = f"{name}{'_inverse' if inverse else ''}@{at}"
                rows[key] = {"ms": ms, "device_ms": dev_ms, "aten_ops": ops,
                             "fwd_bwd_ms": call_ms(fwd_bwd, FLOW_ITERS),
                             "max_err_over_tol": out_ratio, "cpu_f32_max_err_over_tol": cpu_ratio,
                             "max_grad_rel_err": max(grad_err.values()),
                             "cpu_f32_max_grad_rel_err": max(cpu_grad_err.values()),
                             "worst_grad": max(grad_err, key=grad_err.get)}
                bad_out = out_ratio > max(1.0, 2 * cpu_ratio)
                bad_grad = [k for k, e in grad_err.items()
                            if e > max(FLOW_GRAD_TOL, 2 * cpu_grad_err[k])]
                if bad_out or bad_grad:
                    raise AssertionError(f"flow_library {key}: outputs at {out_ratio} of their "
                                         f"tolerance (the CPU's float32 {cpu_ratio}), gradients "
                                         f"{grad_err} (the CPU's float32 {cpu_grad_err})")
    launched = {k: v for k, v in launch_counts().items() if v}
    row = {"phase": "flow_library", "card": smi,
           "rows": {k: b * n for k, (b, n) in FLOW_ROWS.items()},
           "tol": {"outputs": FLOW_TOL, "mixed_chain": FLOW_CHAIN_TOL,
                   "grad_rel": FLOW_GRAD_TOL, "else": "2x the CPU's float32 run"},
           "cases": rows, "kernel_launches": launched}
    log(row)
    if launched:
        raise AssertionError(f"flow_library launched kernels of ours: {launched}")
    return row


def phase_simulator():
    """Sequences of the default simulator (T=50, 25 distractors, 128 px)
    made on the card, in the dataset writer's chunks of 32: timed to host
    arrays (``generate_batch``, what ``generate_dataset`` runs) and on the
    card alone; then 8 sequences from one set of draws on the card and on
    the CPU: frames, start frames and visible counts equal, states within
    1e-4 (the CPU tests' bound against JAX)."""
    from nfdpf_torch.data.simulator import DiskSimulator

    sim = DiskSimulator()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sim.sequence_from_draws(sim.draw_sequence(gen, 32))        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    num, reps = 256, 3
    to_host_s = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sim.generate_batch(gen, num)
        to_host_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(num // 32):
        rec = sim.sequence_from_draws(sim.draw_sequence(gen, 32))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del rec

    draws = sim.draw_sequence(gen, 8)
    gpu = sim.sequence_from_draws(draws)
    t0 = time.perf_counter()
    cpu = sim.sequence_from_draws({k: v.cpu() for k, v in draws.items()})
    cpu_s = time.perf_counter() - t0
    pixels_differ = int((gpu["image"].cpu() != cpu["image"]).sum()
                        + (gpu["start_image"].cpu() != cpu["start_image"]).sum())
    visible_differ = int((gpu["visible"].cpu() != cpu["visible"]).sum())
    state_err = float((gpu["state"].cpu() - cpu["state"]).abs().max())
    median = statistics.median(to_host_s)
    log({"phase": "simulator", "sequences": num, "chunk": 32,
         "to_host_s": to_host_s, "sequences_per_s": num / median,
         "card_only_s": card_s, "card_only_sequences_per_s": num / card_s,
         "peak_mem_gib": peak / 2**30, "cpu_s_8_sequences": cpu_s,
         "pixels_differ": pixels_differ, "visible_differ": visible_differ,
         "state_max_abs_err": state_err, "state_tol": 1e-4})
    if pixels_differ or visible_differ or not state_err <= 1e-4:
        raise AssertionError(f"simulator: card vs CPU: {pixels_differ} pixels and "
                             f"{visible_differ} visible counts differ, states {state_err:.2e}")


# the entry point's main path: the CNF-DPF on the coupling kernels and the
# streaming-Sinkhorn kernels, at the CLI's defaults (B=32, N=100, T=50, 128 px,
# ESS gate 0.5) on 80 generated train sequences (2 steps an epoch)
MAIN_CLI_FLAGS = ["--NF-dyn", "--NF-cond", "--pallas-coupling", "--use-pallas",
                  "--num-examples", "80"]
MAIN_CLI_ARTIFACTS = ("models/best", "models/final", "data/eval_loss_epoch.npy",
                      "data/eval_result_best.npz", "data/test_loss_epoch.npy",
                      "data/test_result.npz")


def metadata_against_restored(path: str):
    """``checkpoint_metadata(path)`` against the restored tree, leaf by
    leaf: a tensor's is a meta tensor of its shape and dtype, any other
    leaf equal.  Returns the leaf count and what disagrees."""
    from nfdpf_torch.utils.checkpoint import checkpoint_metadata, restore_checkpoint

    leaves, full = [], []
    torch.utils._pytree.tree_map(leaves.append, checkpoint_metadata(path))
    torch.utils._pytree.tree_map(full.append, restore_checkpoint(path))
    if len(leaves) != len(full):
        return len(leaves), [f"checkpoint_metadata: {len(leaves)} leaves, restored {len(full)}"]
    bad = [i for i, (m, r) in enumerate(zip(leaves, full))
           if not ((torch.is_tensor(m) and m.is_meta and m.shape == r.shape
                    and m.dtype == r.dtype) if torch.is_tensor(r) else m == r)]
    return len(leaves), ([f"checkpoint_metadata disagrees at leaves {bad[:5]}"] if bad else [])


def phase_main_cli():
    """Three runs of ``nfdpf_torch.main.main`` (no device given: the card)
    in a temporary directory, each with the launch counters set to 0 just
    before it and read just after; the steps are timed by wrapping
    ``Trainer.train_step``/``eval_step`` (host clock, synchronised)."""
    import shutil

    from nfdpf_torch import main as entry
    from nfdpf_torch.config import parse_args
    from nfdpf_torch.train import Trainer
    from nfdpf_torch.utils.checkpoint import restore_checkpoint

    steps = []
    wrapped = {}
    for kind in ("train_step", "eval_step"):
        wrapped[kind] = getattr(Trainer, kind)

        def timed(self, *args, _kind=kind, **kwargs):
            if self.device.type != "cuda":
                raise AssertionError(f"main_cli: a trainer on {self.device}")
            t0 = time.perf_counter()
            out = wrapped[_kind](self, *args, **kwargs)
            torch.cuda.synchronize()
            m = out if _kind == "train_step" else out[0]
            steps.append({"kind": _kind, "s": time.perf_counter() - t0,
                          "loss": float(m["loss"]), "loss_sup": float(m["loss_sup"]),
                          "resample_count": int(m["resample_count"])})
            return out
        setattr(Trainer, kind, timed)
    staged_calls = []
    fit_fused = Trainer.fit_fused

    def counted_fit_fused(self, *args, **kwargs):
        staged_calls.append(1)
        return fit_fused(self, *args, **kwargs)
    Trainer.fit_fused = counted_fit_fused
    gen_s = []
    generate = entry.generate_dataset

    def timed_generate(*args, **kwargs):
        t0 = time.perf_counter()
        generate(*args, **kwargs)
        gen_s.append(time.perf_counter() - t0)
    entry.generate_dataset = timed_generate

    home, tmp = os.getcwd(), tempfile.mkdtemp(prefix="nfdpf_main_cli_")
    base = MAIN_CLI_FLAGS + ["--data-path", os.path.join(tmp, "disks")]
    run_dir = os.path.join("logs", entry.get_run_id(parse_args(base)))
    # (name, argv, epoch saved after it, main's staging budget: 0 feeds host batches)
    runs = [("train", base + ["--num-epochs", "1"], 1, entry.STAGED_BYTES_LIMIT),
            ("resume", base + ["--num-epochs", "2", "--resume"], 2, 0),
            ("test", base + ["--testing", "--model-path", os.path.join(run_dir, "models")], 2,
             entry.STAGED_BYTES_LIMIT)]
    limit = entry.STAGED_BYTES_LIMIT
    rows = {}
    t_phase = time.perf_counter()
    try:
        os.chdir(tmp)
        for name, argv, epoch, budget in runs:
            entry.STAGED_BYTES_LIMIT = budget
            del steps[:], staged_calls[:]
            reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            entry.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = launch_counts()
            train = [s for s in steps if s["kind"] == "train_step"]
            evals = [s for s in steps if s["kind"] == "eval_step"]
            missing = [a for a in MAIN_CLI_ARTIFACTS if not os.path.exists(os.path.join(run_dir, a))]
            final = os.path.join(run_dir, "models", "final")
            saved_epoch = restore_checkpoint(final)["epoch"]
            meta_leaves, meta_bad = metadata_against_restored(final)
            test_losses = np.load(os.path.join(run_dir, "data", "test_loss_epoch.npy"))
            eval_losses = np.load(os.path.join(run_dir, "data", "eval_loss_epoch.npy"))
            rows[name] = {
                "argv": argv, "staged_bytes_limit": budget, "staged": bool(staged_calls),
                "s": seconds, "launches": counts,
                "train_steps": len(train), "eval_steps": len(evals),
                "median_train_step_ms": statistics.median(s["s"] for s in train) * 1e3
                if train else None,
                "median_eval_step_ms": statistics.median(s["s"] for s in evals) * 1e3,
                "ess_firings_train": [s["resample_count"] for s in train],
                "ess_firings_eval": [s["resample_count"] for s in evals],
                "train_losses": [s["loss"] for s in train],
                "eval_loss_epoch": eval_losses.tolist(), "test_losses": test_losses.tolist(),
                "saved_epoch": saved_epoch, "metadata_leaves": meta_leaves,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
            bad = meta_bad
            if missing:
                bad.append(f"missing artifacts {missing}")
            if saved_epoch != epoch:
                bad.append(f"models/final holds epoch {saved_epoch}, not {epoch}")
            if not all(math.isfinite(s["loss"]) for s in steps) or not (
                    np.isfinite(test_losses).all() and np.isfinite(eval_losses).all()):
                bad.append("a non-finite loss")
            if counts["coupling_chain"] + counts["coupling_chain_inverse"] <= 0:
                bad.append("K4 was not launched")
            if name != "test" and counts["coupling_chain_bwd"] <= 0:
                bad.append("K5 was not launched")
            if name == "test" and (train or counts["coupling_chain_bwd"]):
                bad.append("the test run trained")
            if bool(staged_calls) != (name == "train"):
                bad.append(f"{len(staged_calls)} fit_fused calls (staged only in run train)")
            if bad:
                raise AssertionError(f"main_cli run {name}: {'; '.join(bad)}: {rows[name]}")
    finally:
        os.chdir(home)
        shutil.rmtree(tmp, ignore_errors=True)
        entry.generate_dataset = generate
        entry.STAGED_BYTES_LIMIT = limit
        Trainer.fit_fused = fit_fused
        for kind, fn in wrapped.items():
            setattr(Trainer, kind, fn)
    if rows["train"]["train_steps"] != 2 or rows["resume"]["train_steps"] != 2:
        raise AssertionError(f"main_cli: {rows['train']['train_steps']} and "
                             f"{rows['resume']['train_steps']} train steps, expected 2 and 2")
    row = {"phase": "main_cli", "generate_s": gen_s, "phase_s": time.perf_counter() - t_phase,
           "runs": rows}
    log(row)
    return row


# ---------------------------------------------------------------------------
# device meshes: K1/K2 at rows ≠ columns, K6 on 2 ranks, mesh train
# steps, the entry point on a data mesh.  The script needs one card: the
# ranks share it over gloo (which stages CUDA tensors through the host), so
# these runs check correctness; their times say nothing of NCCL.
# ---------------------------------------------------------------------------

# (B, rows, columns) of the rows ≠ columns checks, with timing iterations:
# K6's local rows against all columns on 2 ranks at the slices' (32, 100)
# and main_cli's eval batch, config 5's N over 2 ranks, and a ragged case
RECT_SHAPES = (((32, 50, 100), 200), ((10, 50, 100), 200), ((4, 5120, 10240), 10),
               ((3, 1037, 2053), 20))
RECT_AT = "B4_N5120_M10240"       # the rows ≠ columns case in the kernels line
K6_SHAPE, K6_RANKS = (4, 10240), 2
K6_KW = dict(eps=0.1, scaling=0.75, threshold=1e-3, max_iter=100)
K6_GRAD_TOL = 1e-3
K6_TIMES = 5          # timed calls of K6 and of its plain version each, in turns
# K6's all-gathers outside its loop: the coordinates and log-weights, the
# start's potentials, the final f, the column term and the raw particles
K6_GATHERS = 6
# the mesh train steps: (settings, (data, particle)) at full width, T cut to
# MESH_T for the time limit; each against the unsharded card run of the same
# draws
MESH_T = 10
MESHES = {"mesh_particle": (CNF_SLICE, (1, 2)), "mesh_data": (SLICE, (2, 1)),
          "mesh_2x2": (NFDPF_SLICE, (2, 2)),
          # OT over materialised costs (bench.py's) with both flows on K4/K5,
          # and config 5 with the soft resampler (JAX's own sharded config-5
          # test): CGLOW, NF dynamics on K4/K5, SDPF
          "mesh_particle_dense": (dict(CNF_SLICE, use_pallas=False), (1, 2)),
          "mesh_particle_config5": (dict(CGLOW_SLICE, resampler_type="soft"), (1, 2))}
# the meshes whose CGLOW parameters are drawn from N(0, σ²) (``ranks.draw_cglow``,
# phase 5's rule), so that its gradients are not rounding residue
MESH_CGLOW_STD = {"mesh_particle_config5": 0.15}
MESH_WORLD = 4
# a float64 mesh step against the unsharded float64 one (loss and gradient
# groups, relative): rounding there is ~1e-13
FLOAT64_TOL = 1e-9
GRAD_GROUPS = ("encoder", "decoder", "measurement", "nf_dyn", "cond_model")


def rect_cases(b: int, n: int, m: int, seed: int):
    """K1 and K2 (both directions) on n rows against m columns of
    resampler-like inputs, with their plain versions and library calls."""
    from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    raw = torch.rand(b, m, 2, generator=gen) * 128 - 64
    centered = raw - raw.mean(1, keepdim=True)
    y = (centered / (centered.std(1, correction=0).amax(-1)[:, None, None]
                     * math.sqrt(2))).to(dev)
    x = y[:, :n].contiguous()                 # a rank's rows of the same cloud
    eps = torch.linspace(0.1, 2.0, b).to(dev)
    f1 = torch.log_softmax(torch.randn(b, 1, m, generator=gen), -1).to(dev)
    f2 = torch.log_softmax(torch.randn(b, 2, m, generator=gen), -1).to(dev)
    r = (torch.randn(b, n, generator=gen) * 0.1).to(dev)
    c = (torch.randn(b, m, generator=gen) * 0.1 - math.log(m)).to(dev)
    v = raw.to(dev)
    g = torch.randn(b, n, 2, generator=gen).to(dev)
    neg_cost = -sc._pair_cost(x, y) / eps[:, None, None]               # (B, N, M)
    s1, s2 = (f[:, :, None, :] + neg_cost[:, None] for f in (f1, f2))
    t_fwd = torch.exp(r[:, :, None] + c[:, None, :] + neg_cost)
    t_bwd = t_fwd.transpose(1, 2).contiguous()
    del neg_cost
    f4, pairs = 4.0, b * n * m
    lse_bytes = lambda g_: f4 * (b + 2 * b * n + 2 * b * m + b * g_ * m + b * g_ * n)  # noqa: E731
    fwd_bytes = f4 * (b + 2 * b * n + 2 * b * m + 2 * b * m + b * n + b * m + 2 * b * n)
    return {
        "sinkhorn_lse_g1": dict(
            kernel=lambda: sc.streaming_lse_multi(eps, x, y, f1),
            plain=lambda: sc.lse_multi_plain(eps, x, y, f1),
            library=lambda: torch.logsumexp(s1, dim=-1), tol=("lse", LSE_TOL),
            nbytes=lse_bytes(1), ops=pairs * (7 + 4 * 1)),
        "sinkhorn_lse": dict(
            kernel=lambda: sc.streaming_lse_multi(eps, x, y, f2),
            plain=lambda: sc.lse_multi_plain(eps, x, y, f2),
            library=lambda: torch.logsumexp(s2, dim=-1), tol=("lse", LSE_TOL),
            nbytes=lse_bytes(2), ops=pairs * (7 + 4 * 2)),
        "transport_apply": dict(
            kernel=lambda: sc._apply(eps, x, y, v, r, c, "transport_apply"),
            plain=lambda: sc.transport_apply_plain(v, eps, x, y, r, c),
            library=lambda: torch.bmm(t_fwd, v), tol=("apply", APPLY_TOL),
            nbytes=fwd_bytes, ops=pairs * 14),
        "transport_apply_bwd": dict(
            kernel=lambda: sc._apply(eps, y, x, g, c, r, "transport_apply_bwd"),
            plain=lambda: sc.transport_apply_plain(g, eps, y, x, c, r),
            library=lambda: torch.bmm(t_bwd, g), tol=("apply", APPLY_TOL),
            nbytes=fwd_bytes, ops=pairs * 14),
    }


def phase_rect_kernels():
    """K1 (G = 1, 2) and K2 (T@v and Tᵀg) on rows ≠ columns, as K6 runs
    them, against their plain versions, with equal bits on a second launch
    and their times (the same columns as phase 2)."""
    results = {}
    for (b, n, m), iters in RECT_SHAPES:
        cases = rect_cases(b, n, m, seed=b + n + m)
        shape = f"B{b}_N{n}_M{m}"
        for name, cs in cases.items():
            got, ref = cs["kernel"](), cs["plain"]()
            torch.cuda.synchronize()
            max_abs, rel = check(f"{name}@{shape}", got, ref, cs["tol"])
            if not torch.equal(cs["kernel"](), got):
                raise AssertionError(f"{name}@{shape}: a second launch gave other bits")
            del got, ref
            bound, by = bound_ms(cs["nbytes"], cs["ops"])
            results.setdefault(name, {})[shape] = {
                "max_abs_err": max_abs, "max_rel_err": rel, "tol": cs["tol"][1],
                "ms": device_ms(cs["kernel"], iters), "call_ms": call_ms(cs["kernel"], iters),
                "plain_ms": device_ms(cs["plain"], iters),
                "library_ms": device_ms(cs["library"], iters),
                "bound_ms": bound, "bound_by": by}
        del cases
        torch.cuda.empty_cache()
    log({"phase": "kernels_rows_ne_cols", "results": results,
         "note": "x is the first N rows of the M-point cloud y, as a rank's rows of the "
                 "gathered columns; library_ms as in phase 2"})
    return results


def k6_bound_ms(b: int, n: int, shards: int, iters: int):
    """The least time one rank's K6 call could take on this run's data:
    its K1 work (G = 2) on N/P rows × N columns for the cold start, each
    iteration and the final round, the column normaliser (G = 1) and K2's
    forward, against the coordinates and log-weights it gathers once, the
    2·B·N potentials it gathers at the start and the 2·B·N logsumexps it
    gathers each iteration."""
    pairs = b * (n // shards) * n
    ops = pairs * ((iters + 2) * (7 + 4 * 2) + (7 + 4) + 14)
    nbytes = 4.0 * (3 * b * n + (iters + 1) * 2 * b * n + 2 * b * n + 2 * b * (n // shards))
    return bound_ms(nbytes, ops)


def _mesh_inputs(cfg, seed: int):
    """A global uint8 batch and the global draws of one train step, made on
    the card from ``seed`` and brought to the host for the ranks."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, t, n, w = cfg.batch_size, cfg.sequence_length, cfg.num_particles, cfg.width
    batch = {"image": (torch.rand(b, t, w, w, 3, generator=gen, device="cuda") * 255
                       ).to(torch.uint8),
             "state": torch.randn(b, t, 4, generator=gen, device="cuda") * 10,
             "start_state": torch.randn(b, 4, generator=gen, device="cuda") * 10}
    noise = {"vel": torch.randn(b, t, 2, generator=gen, device="cuda"),
             "init": torch.rand(b, n, 2, generator=gen, device="cuda") * w - w / 2,
             "motion": torch.randn(t, b, n, 2, generator=gen, device="cuda"),
             "resample": torch.rand(t, b, 1, generator=gen, device="cuda") / n}
    if cfg.train_type == "SDPF":
        noise["mask"] = (torch.rand(b, t, generator=gen, device="cuda")
                         < cfg.labeled_ratio).to(torch.float32)
    return ({k: v.cpu().numpy() for k, v in batch.items()},
            {k: v.cpu().numpy() for k, v in noise.items()})


def _unsharded_step(settings, batch, noise, cglow_std: float = 0.0):
    """The unsharded card run of one train step from the seed's weights
    (with ``cglow_std`` the CGLOW's drawn)."""
    from nfdpf_torch import DPFConfig
    from nfdpf_torch.parallel import ranks as R
    from nfdpf_torch.train import Trainer

    trainer = Trainer(DPFConfig(**settings))
    if cglow_std:
        R.draw_cglow(trainer.engine, cglow_std)
    return R.step_result(trainer, batch, noise, "cuda")


def _group_rel(grads: dict, ref: dict) -> dict:
    out = {}
    for group in GRAD_GROUPS:
        keys = sorted(k for k in ref if k.startswith(group + "."))
        if not keys:
            continue
        a = np.concatenate([grads[k].ravel() for k in keys])
        r = np.concatenate([ref[k].ravel() for k in keys])
        out[group] = float(np.linalg.norm(a - r) / max(np.linalg.norm(r), 1e-30))
    return out


def phase_mesh(smi: str):
    """K6 on 2 ranks at (4, 10,240) against K3 unsharded and against its
    plain version (timed in turns with it; collectives, host reads and
    launches a call counted), and one train
    step on each mesh of ``MESHES`` against its unsharded card run, every
    rank on this card over gloo, all in one spawned group of 4 ranks (the
    smaller meshes on ranks 0-1).  Each rank sets the launch counters to 0
    just before its step and reads them just after.  cuDNN runs its
    deterministic algorithms here (the ranks too), so that a difference
    reads the mesh alone and not cuDNN's choice of summation order: on an
    H100 the data axis moved the encoder's gradient by a fixed 8.6e-4 to
    9.6e-4 (its BatchNorm sums split over ranks).  Each unsharded step runs
    twice, and how far the two parted is logged (``unsharded_repeat_grad_rel``).
    A mesh with a data axis also runs its step in float64 on the CPU, held
    within ``FLOAT64_TOL`` of the unsharded float64 step (how far each card
    run sits from that step is logged)."""
    torch.backends.cudnn.deterministic = True
    try:
        return _phase_mesh(smi)
    finally:
        torch.backends.cudnn.deterministic = False


def _phase_mesh(smi: str):
    from nfdpf_torch import DPFConfig
    from nfdpf_torch.models.dpf import streaming_ot
    from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc
    from nfdpf_torch.parallel import ranks as R

    phase_t0 = time.perf_counter()
    # K3 unsharded at K6's shape
    b, n = K6_SHAPE
    gen = torch.Generator().manual_seed(11)
    raw = torch.rand(b, n, 2, generator=gen) * 128 - 64
    probs = torch.softmax(torch.randn(b, n, generator=gen), -1)
    x = raw.cuda().requires_grad_()
    out, _, idx, k3_iters = sc.ot_resample_streaming(x, probs.cuda(), **K6_KW)
    (k3_grad,) = torch.autograd.grad(torch.sum(out**2), [x])
    with torch.no_grad():
        k3_ms = call_ms(lambda: sc.ot_resample_streaming(x, probs.cuda(), **K6_KW), 3, 1)
    k3 = {"particles": out.detach().cpu().numpy(), "grad": k3_grad.cpu().numpy()}
    del x, out, k3_grad

    unsharded, inputs, repeat, exact = {}, {}, {}, {}
    for name, (settings, shape) in MESHES.items():
        settings = dict(settings, sequence_length=MESH_T)
        inputs[name] = _mesh_inputs(DPFConfig(**settings), seed=31)
        unsharded[name] = _unsharded_step(settings, *inputs[name], MESH_CGLOW_STD.get(name, 0.0))
        again = _unsharded_step(settings, *inputs[name], MESH_CGLOW_STD.get(name, 0.0))
        repeat[name] = _group_rel(again["grads"], unsharded[name]["grads"])
        torch.cuda.empty_cache()
        if shape[0] > 1:
            exact[name] = R.float64_step(settings, *inputs[name])

    # K6 (timed in turns with its plain version), then its plain version's
    # outputs and counts
    jobs = [(R.resample_job, dict(shape=(1, K6_RANKS), ranks=list(range(K6_RANKS)),
                                  particles=raw.numpy(), probs=probs.numpy(), kw=K6_KW,
                                  device="cuda", times=0 if plain else K6_TIMES, plain=plain))
            for plain in (False, True)]
    for name, (settings, shape) in MESHES.items():
        batch, noise = inputs[name]
        jobs.append((R.train_step_job, dict(
            settings=dict(settings, sequence_length=MESH_T), shape=shape,
            ranks=list(range(shape[0] * shape[1])), batch=batch, noise=noise, device="cuda",
            cglow_std=MESH_CGLOW_STD.get(name, 0.0))))
    for name in exact:
        settings, shape = MESHES[name]
        jobs.append((R.float64_step_job, dict(
            cases={name: dict(settings, sequence_length=MESH_T)}, shape=shape,
            ranks=list(range(shape[0] * shape[1])), batch=inputs[name][0],
            noise=inputs[name][1])))
    t0 = time.perf_counter()
    results = R.spawn(MESH_WORLD, jobs, backend="gloo", threads=2, timeout=600)
    spawn_s = time.perf_counter() - t0

    # K6 against K3 and its plain version
    k6, k6_plain = results[0][0], results[1][0]
    iters = [r["iters"] for r in results[0][:K6_RANKS]]
    plain_iters = [r["iters"] for r in results[1][:K6_RANKS]]
    k6_err = float(np.abs(k6["particles"] - k3["particles"]).max())
    plain_err = float(np.abs(k6["particles"] - k6_plain["particles"]).max())
    bad = []
    if not np.allclose(k6["particles"], k3["particles"], rtol=1e-4, atol=1e-5):
        bad.append(f"K6 particles max abs err {k6_err:.3e} from K3's")
    if not np.allclose(k6["particles"], k6_plain["particles"], rtol=1e-4, atol=1e-5):
        bad.append(f"K6 particles max abs err {plain_err:.3e} from its plain version's")
    grad_rel = float(np.linalg.norm(k6["grad"] - k3["grad"]) / np.linalg.norm(k3["grad"]))
    plain_grad_rel = float(np.linalg.norm(k6["grad"] - k6_plain["grad"])
                           / np.linalg.norm(k6_plain["grad"]))
    if not max(grad_rel, plain_grad_rel) <= K6_GRAD_TOL:
        bad.append(f"K6 value gradient rel err {grad_rel:.3e} from K3's, {plain_grad_rel:.3e} "
                   f"from its plain version's")
    if iters != [k3_iters] * K6_RANKS or plain_iters != iters:
        bad.append(f"K6 iterations {iters}, its plain version's {plain_iters}, K3 {k3_iters}")
    if not np.array_equal(k6["idx"], np.broadcast_to(np.arange(n), (b, n))):
        bad.append("K6 indices are not the global ones")
    launched = k6["launches"]
    if (launched["sharded_resample"] != 1 or launched["sinkhorn_lse"] <= 0
            or launched["sinkhorn_update"] <= 0 or launched["transport_apply"] <= 0):
        bad.append(f"K6 launches {launched}")
    if any(k6_plain["launches"].values()):
        bad.append(f"K6's plain version launched kernels: {k6_plain['launches']}")
    # one all-gather an iteration (a replay holds one at N > LOOP_CHUNK_MAX_N)
    # and none outside the 6 of the geometry, the start, f, the column
    # term and the raw particles; the plain version one of each an iteration
    k3_it = k3_iters
    want = {"new": {"all_gather": K6_GATHERS + k3_it, "all_reduce": 0, "broadcast": 0},
            "plain": {"all_gather": K6_GATHERS + k3_it, "all_reduce": k3_it, "broadcast": 0}}
    for what, run in (("new", k6), ("plain", k6_plain)):
        if run["collectives"] != want[what]:
            bad.append(f"K6 {what}: collectives {run['collectives']}, expected {want[what]}")
    bound, by = k6_bound_ms(b, n, K6_RANKS, k3_iters)
    k6_row = {"phase": "k6", "card": smi, "transport": "gloo-on-one-card",
              "shape": K6_SHAPE, "ranks": K6_RANKS, "iters": iters, "iters_plain": plain_iters,
              "iters_k3": k3_iters, "max_abs_err": k6_err, "max_abs_err_plain": plain_err,
              "grad_rel_err": grad_rel, "grad_rel_err_plain": plain_grad_rel,
              "ms_per_call": k6["ms"], "plain_ms_per_call": k6["plain_ms"],
              "calls_ms": k6["calls_ms"], "k3_ms_per_call": k3_ms,
              "bound_ms": bound, "bound_by": by,
              "k3_bound_ms": k6_bound_ms(b, n, 1, k3_iters)[0],
              # each iteration: K1 (G=2) on N/P rows × N columns, and the
              # 2·B·N logsumexps all-gathered
              "bound_per_iteration_ms": bound_ms(4.0 * 2 * b * n,
                                                 b * (n // K6_RANKS) * n * (7 + 4 * 2))[0],
              "gathered_bytes_per_iteration": 4 * 2 * b * n,
              "collectives_per_call": k6["collectives"],
              "collectives_per_call_plain": k6_plain["collectives"],
              "collectives_per_iteration": {k: (v - (K6_GATHERS if k == "all_gather" else 0))
                                            / k3_iters for k, v in k6["collectives"].items()},
              "collectives_per_iteration_plain": {
                  k: (v - (K6_GATHERS if k == "all_gather" else 0)) / k3_iters
                  for k, v in k6_plain["collectives"].items()},
              "host_reads_per_call": k6["loop"]["host_reads"],
              "host_reads_per_call_plain": k6_plain["loop"]["host_reads"],
              "launches_per_call": launched,
              "note": "ms are 2 ranks sharing this card over gloo, whose collectives stage "
                      "through the host: not a time of NCCL; the driver and its plain "
                      "version timed in turns in one job, medians of calls_ms"}
    log(k6_row)

    rows = {}
    float64_runs = dict(zip(exact, results[2 + len(MESHES):]))
    for (name, (settings, shape)), runs in zip(MESHES.items(), results[2:2 + len(MESHES)]):
        ref = unsharded[name]
        runs = [r for r in runs if r is not None]
        losses = [r["metrics"]["loss"] for r in runs]
        loss_rel = max(abs(v - ref["metrics"]["loss"]) / abs(ref["metrics"]["loss"])
                       for v in losses)
        grads = [_group_rel(r["grads"], ref["grads"]) for r in runs]
        worst = {g: max(gr[g] for gr in grads) for g in grads[0]}
        iters = [r["metrics"]["sinkhorn_iters"] for r in runs]
        firings = [r["metrics"]["resample_count"] for r in runs]
        dense_iters = [r["dense_iters"] for r in runs]
        launches = runs[0]["launches"]
        rows[name] = {"phase": name, "card": smi, "transport": "gloo-on-one-card",
                      "mesh": {"data": shape[0], "particle": shape[1]},
                      "config": dict(settings, sequence_length=MESH_T),
                      "cglow_std": MESH_CGLOW_STD.get(name, 0.0),
                      "loss": losses, "loss_unsharded": ref["metrics"]["loss"],
                      "loss_rel_err": loss_rel, "grad_rel_err_by_group": worst,
                      "unsharded_repeat_grad_rel": repeat[name],
                      "sinkhorn_iters": iters,
                      "sinkhorn_iters_unsharded": ref["metrics"]["sinkhorn_iters"],
                      "dense_iters": dense_iters, "dense_iters_unsharded": ref["dense_iters"],
                      "resample_count": firings[0],
                      "resample_count_unsharded": ref["metrics"]["resample_count"],
                      "launches_rank0": launches, "launches_unsharded": ref["launches"],
                      "coupling_launches_by_rank": [
                          {k: r["launches"][k] for k in r["launches"] if k.startswith("coupling")}
                          for r in runs],
                      "collectives_rank0": runs[0]["collectives"],
                      "collectives_by_rank": [r["collectives"] for r in runs],
                      "step_s": [r["s"] for r in runs], "step_s_unsharded": ref["s"],
                      "peak_gib": [r["peak_gib"] for r in runs],
                      "peak_gib_unsharded": ref["peak_gib"]}
        if name in exact:
            f64 = exact[name]
            mesh64 = float64_runs[name][0][name]
            rows[name].update(
                float64_mesh_loss_rel=abs(mesh64["loss"] - f64["loss"]) / abs(f64["loss"]),
                float64_mesh_grad_rel=_group_rel(mesh64["grads"], f64["grads"]),
                card_from_float64={"sharded": _group_rel(runs[0]["grads"], f64["grads"]),
                                   "unsharded": _group_rel(ref["grads"], f64["grads"])})
        log(rows[name])
        if name in exact:
            gaps = dict(rows[name]["float64_mesh_grad_rel"],
                        loss=rows[name]["float64_mesh_loss_rel"])
            for what, rel in gaps.items():
                if not rel <= FLOAT64_TOL:
                    bad.append(f"{name}: float64 mesh step's {what} rel err {rel:.2e} from "
                               f"the unsharded float64 step")
        if not loss_rel <= 1e-4:
            bad.append(f"{name}: first-step loss rel err {loss_rel:.2e}")
        for g, rel in worst.items():
            if not rel <= (1e-2 if g == "decoder" else 1e-3):
                bad.append(f"{name}: {g} gradient rel err {rel:.2e}")
        if iters != [ref["metrics"]["sinkhorn_iters"]] * len(runs):
            bad.append(f"{name}: Sinkhorn iterations {iters}, unsharded "
                       f"{ref['metrics']['sinkhorn_iters']}")
        if dense_iters != [ref["dense_iters"]] * len(runs):
            bad.append(f"{name}: dense Sinkhorn iterations {dense_iters}, unsharded "
                       f"{ref['dense_iters']}")
        if firings != [ref["metrics"]["resample_count"]] * len(runs):
            bad.append(f"{name}: firings {firings}, unsharded "
                       f"{ref['metrics']['resample_count']}")
        cfg = DPFConfig(**settings)
        want = []
        if streaming_ot(cfg):
            want += ["sinkhorn_lse", "sinkhorn_update", "transport_apply"]
            want += ["sharded_resample"] if shape[1] > 1 else []
        want += (["coupling_chain_inverse", "coupling_chain_bwd"] if cfg.pallas_coupling
                 else [])
        for r in runs:
            missing = [k for k in want if r["launches"][k] <= 0]
            if missing:
                bad.append(f"{name}: {missing} not launched on a rank ({r['launches']})")
    log({"phase": "mesh_spawn", "ranks": MESH_WORLD, "seconds": spawn_s,
         "phase_seconds": time.perf_counter() - phase_t0})
    if bad:
        raise AssertionError("; ".join(bad))
    return k6_row, rows


# the entry point on 2 ranks: a data mesh with main_cli's flags, and a
# particle mesh at the CLI's default OT (over materialised costs)
MAIN_CLI_MESHES = {
    "data": MAIN_CLI_FLAGS + ["--mesh-data", "2", "--mesh-particle", "1"],
    "particle": [f for f in MAIN_CLI_FLAGS if f != "--use-pallas"]
    + ["--mesh-data", "1", "--mesh-particle", "2"],
}


def _torchrun_pair(argv, cwd: str, repo: str) -> tuple:
    """``python -m nfdpf_torch.main *argv`` on 2 ranks from ``cwd``, with the
    variables torchrun sets.  Returns (exit codes, outputs, seconds)."""
    from nfdpf_torch.parallel.ranks import free_port

    port = free_port()
    procs, t0 = [], time.perf_counter()
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nfdpf_torch.main", *argv], cwd=cwd,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs, time.perf_counter() - t0


def phase_main_cli_mesh():
    """``python -m nfdpf_torch.main`` as torchrun starts it (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) on 2 ranks, which share this card over gloo (more
    ranks than cards), on each mesh of ``MAIN_CLI_MESHES``: one epoch (the
    first run makes the data, the second reads the same 80 sequences),
    then ``--testing``, each mesh in a working directory of its own.  Each
    rank must exit 0; the artifacts must be there, the eval and test losses
    finite, and only rank 0 may print the epoch's line."""
    import shutil

    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="nfdpf_main_cli_mesh_")
    out, bad = {}, []
    try:
        from nfdpf_torch.config import parse_args
        from nfdpf_torch.main import get_run_id

        for mesh, flags in MAIN_CLI_MESHES.items():
            base = flags + ["--data-path", os.path.join(tmp, "disks")]
            cwd = os.path.join(tmp, mesh)
            os.makedirs(cwd)
            run_dir = os.path.join(cwd, "logs", get_run_id(parse_args(base)))
            rows = {}
            for name, extra in (("train", ["--num-epochs", "1"]),
                                ("test", ["--testing", "--model-path",
                                          os.path.join(run_dir, "models")])):
                codes, outs, seconds = _torchrun_pair(base + extra, cwd, repo)
                rows[name] = {"exit_codes": codes, "s": seconds,
                              "epoch_lines": [sum(ln.startswith("epoch ") for ln in o.splitlines())
                                              for o in outs],
                              "test_lines": [sum(ln.startswith("test loss")
                                                 for ln in o.splitlines()) for o in outs]}
                if codes != [0, 0]:
                    tails = "\n".join(f"--- rank {r} ---\n" + o[-3000:]
                                      for r, o in enumerate(outs))
                    raise AssertionError(f"main_cli_mesh {mesh} {name}: exit codes {codes}\n"
                                         f"{tails}")
            missing = [a for a in MAIN_CLI_ARTIFACTS
                       if not os.path.exists(os.path.join(run_dir, a))]
            losses = {k: np.load(os.path.join(run_dir, "data", f"{k}_loss_epoch.npy"))
                      for k in ("eval", "test") if f"data/{k}_loss_epoch.npy" not in missing}
            out[mesh] = {"argv": base, "runs": rows, "missing": missing,
                         **{f"{k}_losses": v.tolist() for k, v in losses.items()}}
            if missing:
                bad.append(f"{mesh}: missing artifacts {missing}")
            if rows["train"]["epoch_lines"] != [1, 0] or rows["test"]["test_lines"] != [1, 0]:
                bad.append(f"{mesh}: printing ranks: {rows}")
            if not all(np.isfinite(v).all() for v in losses.values()):
                bad.append(f"{mesh}: non-finite eval or test losses {losses}")
        row = {"phase": "main_cli_mesh", "transport": "gloo-on-one-card", "meshes": out}
        log(row)
        if bad:
            raise AssertionError(f"main_cli_mesh: {'; '.join(bad)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every phase's numbers to this JSON file")
    parser.add_argument("--profile", action="store_true",
                        help="profile one extra train step by kernel (torch.profiler)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs its kernels on a GPU only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nfdpf_torch import DPFConfig
    from nfdpf_torch.ops.cuda import coupling_cuda as cc

    cnf = DPFConfig(**CNF_SLICE)
    card = phase_setup((cnf.flow_hidden_dim, H16, cc.WIDE_BUILD))
    kernels = phase_kernels()
    kernels["sinkhorn_update"], k3 = phase_k3()
    kernels.update(phase_chain_kernels(cnf.n_sequence, cnf.flow_hidden_dim))
    kernels["sinkhorn_update"][AT["sinkhorn_update"]].update(update_launch())
    h16 = phase_chain_kernels(cnf.n_sequence, H16, f"chain_kernels_h{H16}", record=False)
    wide, wide_launched = phase_chain_kernels_wide()
    kernels.update(wide)
    ptxas = {h: chain_resources(h) for h in (cnf.flow_hidden_dim, H16)}
    ptxas_update = update_resources()
    ptxas_wide = wide_resources()
    log({"phase": "chain_resources", "ptxas": ptxas[cnf.flow_hidden_dim],
         f"ptxas_h{H16}": ptxas[H16], "ptxas_update": ptxas_update, "ptxas_wide": ptxas_wide})
    # every wide launch's registers are ptxas's for the instantiation it ran,
    # which spills nothing up to hidden WIDE_SPILL_FREE (the spills of the
    # widest tiles are recorded)
    for name in WIDE_LINE:
        for case, rec in wide[name].items():
            counts = ptxas_wide[rec["kernel"]]
            spills = counts.get("spill_bytes", 0)
            if (rec["registers"] != counts["registers"]
                    or (spills and int(case.split("_")[0][1:]) <= WIDE_SPILL_FREE)):
                raise AssertionError(f"{name}@{case}: the launch of {rec['kernel']} took "
                                     f"{rec['registers']} registers; ptxas says {counts} "
                                     f"(spills must be 0 up to hidden {WIDE_SPILL_FREE})")
            rec["ptxas_spill_bytes"] = spills
    # the redesigned kernels' recorded launches against ptxas's counts, the
    # launched kernel the one the wrapper's plan names
    update_at = kernels["sinkhorn_update"][AT["sinkhorn_update"]]
    plan = kernels["coupling_ctx_input_grad"][AT["coupling_ctx_input_grad"]]["plan"]
    in_grad = "chain_ctx_input_grad_kernel<{}, {}, {}>".format(
        plan["tile_rows"] // plan["rows_a_thread"], plan["rows_a_thread"],
        plan["tile_cols"] // cc.CTX_IN_LANES)
    recorded = [("sinkhorn_update", update_at["kernel"], ptxas_update),
                ("coupling_ctx_input_grad", in_grad, ptxas[cnf.flow_hidden_dim])]
    for name, kernel, report in recorded:
        rec, counts = kernels[name][AT[name]], report[kernel]
        if rec["kernel"] != kernel:
            raise AssertionError(f"{name}@{AT[name]}: the launch ran {rec['kernel']}, the "
                                 f"plan names {kernel}")
        if ((rec["registers"], rec["smem_bytes_per_block"], 0)
                != (counts["registers"], counts["smem_bytes"], counts.get("spill_bytes", 0))):
            raise AssertionError(f"{name}@{AT[name]}: the launch took {rec['registers']} "
                                 f"registers and {rec['smem_bytes_per_block']} bytes of shared "
                                 f"memory; ptxas says {counts} (spills must be 0)")
        rec["ptxas_spill_bytes"] = counts.get("spill_bytes", 0)
    slices = {name: phase_slice(name, *spec, args.profile) for name, spec in SLICES.items()}
    phase_wide_step(slices["slice_cnf_wide"], wide)
    phase_remat(slices["slice_cglow"], slices["slice_cglow_remat"])
    phase_warm_start()
    phase_parity("parity", SLICE)
    phase_parity("parity_cnf", CNF_SLICE, flow_scale=10.0)
    phase_parity("parity_dense", DENSE_SLICE)
    phase_parity("parity_transport_grad", dict(SLICE, ot_transport_grad=True))
    phase_parity("parity_soft", SOFT_SLICE)
    phase_parity("parity_nfdpf", NFDPF_SLICE, flow_scale=10.0)
    phase_parity("parity_nn", dict(SLICE, measurement="NN"))
    phase_parity("parity_gaussian", dict(SLICE, measurement="gaussian"))
    phase_parity("parity_sdpf", dict(SLICE, train_type="SDPF", labeled_ratio=0.5))
    phase_parity("parity_cglow", CGLOW_SLICE, flow_scale=10.0, cglow_std=0.15)
    phase_parity("parity_cglow_nfcond", CGLOW_NFCOND_SLICE, flow_scale=10.0, cglow_std=0.15)
    phase_parity("parity_bf16", BF16_SLICE, flow_scale=10.0)
    # at ×10 the 16-wide flows make the step ~100× more sensitive to float32
    # rounding than at width 8 (on the CPU a 1e-6 relative change of the
    # initial particles moves the measurement's gradient by 6e-3, the flows'
    # by 2e-4; 1e-5 at width 8): the flows stay at their init scale here,
    # and K4/K5 at 16 are held to their plain versions with N(0, 0.3²)
    # weights in chain_kernels_h16
    phase_parity("parity_h16", H16_SLICE)
    phase_parity("parity_remat", dict(CNF_SLICE, remat_scan_step=True, sinkhorn_warm_start=True),
                 flow_scale=10.0)
    phase_parity("parity_per_step", PER_STEP_SLICE)
    # the wide pair at init scale, as parity_h16 (at x10 the 32-wide flows
    # are more sensitive still to float32 rounding than the 16-wide ones)
    launched = phase_parity("parity_cnf_wide", CNF_WIDE_SLICE)["launches_cuda"]
    missing = [k for k in CNF_WIDE_TRAIN if k.startswith("coupling") and not launched[k]]
    if missing:
        raise AssertionError(f"parity_cnf_wide: the card run did not launch {missing}: "
                             f"{launched}")
    phase_linalg()
    flow_library = phase_flow_library(card)
    phase_simulator()
    cli = phase_main_cli()
    rect = phase_rect_kernels()
    k6, meshes = phase_mesh(card)
    phase_main_cli_mesh()

    # each kernel's numbers at its case in AT; its launches over the 3 train
    # steps of the NF-DPF slice, which runs all four, of every slice, and
    # over the three runs of main_cli (the forward coupling kernel's: both
    # directions together)
    runs = [row["launches_train_3_steps"] for row in slices.values()]
    runs.append({k: sum(r["launches"][k] for r in cli["runs"].values()) for k in runs[0]})
    by_slice = {}
    for sname, launches in zip(list(slices) + ["main_cli"], runs):
        counts = dict(launches)
        counts["coupling_chain"] += counts["coupling_chain_inverse"]
        counts["coupling_chain_wide"] += counts["coupling_chain_wide_inverse"]
        by_slice[sname] = counts
    floor = kernels["sinkhorn_lse"][AT["sinkhorn_lse"]]["launch_floor_ms"]
    line = []
    for name, (source, replaces) in KERNELS.items():
        # K1's entry covers both of its instantiations (G=2 timed, G=1 checked)
        cases = [kernels[name]] + ([kernels["sinkhorn_lse_g1"]] if name == "sinkhorn_lse" else [])
        cases += [h16[name]] if name in h16 else []
        worst = max(c[s]["max_abs_err"] for c in cases for s in c)
        m = kernels[name][AT[name]]
        main_path = "slice_cnf_wide" if name in WIDE_LINE else "slice_nfdpf"
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": by_slice[main_path][name], "max_abs_err": worst,
                 "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                 "bound_by": m["bound_by"], "library_ms": m["library_ms"], "at": AT[name],
                 "launch_floor_ms": floor,
                 "launches_by_slice": {k: v[name] for k, v in by_slice.items()}}
        if name == "transport_apply":
            entry["launches_backward_by_slice"] = {k: v["transport_apply_bwd"]
                                                   for k, v in by_slice.items()}
        if "registers" in m:   # the coupling kernels' timed launch (launch_record)
            entry["registers"] = m["registers"]
            entry["smem_bytes_per_block"] = m["smem_bytes_per_block"]
        if name in ("coupling_chain", "coupling_chain_bwd"):
            # the same case at the widest build, with ptxas's counts
            w = h16[name][AT[name]]
            kernel = "chain_fwd_kernel" if name == "coupling_chain" else "chain_bwd_kernel"
            entry[f"h{H16}"] = {
                **{k: w[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                "max_abs_err": max(c["max_abs_err"] for c in h16[name].values()),
                "ptxas": {k: v for k, v in ptxas[H16].items() if k.startswith(kernel)},
                "at": AT[name]}
        if name in WIDE_LINE:   # the module route's time, every launched instantiation
            entry["module_ms"] = m.get("module_ms", m.get("module_fwd_bwd_ms"))
            entry["launched"] = sorted(wide_launched[name])
            entry["main_path"] = main_path
        if name in CTX_RECORDED:   # the redesigned context kernels: ptxas's counts, the plan
            entry["ptxas"] = {k: v for k, v in ptxas[cnf.flow_hidden_dim].items()
                              if k.startswith(CTX_RECORDED[name])}
            entry["plan"] = m["plan"]
        if name == "sinkhorn_update":
            entry.update(ptxas=ptxas_update, plan=m["plan"], ms_all_running=m["ms_all_running"],
                         at_all_running={k: v["ms_all_running"] for k, v in kernels[name].items()})
        if name == "coupling_ctx_weight_grad":
            entry["note"] = ("ms, plain_ms and library_ms are of the whole gradient: both "
                             "kernels (coupling_ctx_grad_rows folds the rows of g1 first)")
        if name == "coupling_ctx_input_grad":
            entry["note"] = ("the filter detaches its contexts: only a context that asks for "
                             "a gradient launches it (chain_kernels checks it)")
        line.append(entry)
    # K3, the driver of K1, the update and K2: its calls on the main path;
    # one call's ms at (32, 100) with its iterations and host syncs; its
    # plain version (the eager loop on plain K1/K2/update) as plain_ms
    m = k3[f"{K3_AT}_cold"]
    line.append({"name": "ot_resample_streaming", "route": "cuda",
                 "source": "nfdpf_torch/ops/cuda/sinkhorn_cuda.py",
                 "replaces": "nfdpf_tpu/ops/pallas/sinkhorn_pallas.py:291",
                 "launches": by_slice["slice_nfdpf"]["streaming_resample"],
                 "max_abs_err": max(c["max_abs_err"] for c in k3.values()), "ms": m["ms"],
                 "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                 "library_ms": None, "at": f"{K3_AT}_cold", "iters": m["iters"],
                 "chunk": m["chunk"], "syncs": m["syncs"], "ms_chunk_1": m["ms_chunk_1"],
                 "launches_by_slice": {k: v["streaming_resample"] for k, v in by_slice.items()}})
    # K1/K2 at rows ≠ columns, their launches in the particle mesh's step
    # (rank 0: K6 runs them on its rows against all columns)
    mesh_launches = {k: v["launches_rank0"] for k, v in meshes.items()}
    for name, both in (("sinkhorn_lse", ("sinkhorn_lse", "sinkhorn_lse_g1")),
                       ("transport_apply", ("transport_apply", "transport_apply_bwd"))):
        m = rect[name][RECT_AT]
        line.append({"name": f"{name}_rows_ne_cols", "route": "cuda", "source": SINKHORN_CU,
                     "replaces": KERNELS[name][1],
                     "launches": mesh_launches["mesh_particle"][name],
                     "max_abs_err": max(c["max_abs_err"] for k in both
                                        for c in rect[k].values()),
                     "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"], "library_ms": m["library_ms"], "at": RECT_AT,
                     "launches_by_mesh": {k: v[name] for k, v in mesh_launches.items()}})
    # K6: its calls in the particle mesh's step; its time and its plain
    # version's on 2 ranks sharing the card over gloo, in turns; K3's
    # unsharded (the reference it is held to) beside them
    line.append({"name": "ot_resample_streaming_sharded", "route": "cuda",
                 "source": "nfdpf_torch/ops/cuda/sinkhorn_cuda.py",
                 "replaces": "nfdpf_tpu/ops/pallas/sinkhorn_pallas.py:462",
                 "launches": mesh_launches["mesh_particle"]["sharded_resample"],
                 "max_abs_err": k6["max_abs_err"], "ms": k6["ms_per_call"],
                 "plain_ms": k6["plain_ms_per_call"], "bound_ms": k6["bound_ms"],
                 "bound_by": k6["bound_by"], "library_ms": None,
                 "at": f"B{K6_SHAPE[0]}_N{K6_SHAPE[1]}_P{K6_RANKS}",
                 "transport": "gloo-on-one-card",
                 "plain": "ot_resample_streaming_sharded_plain on the card",
                 "k3_ms": k6["k3_ms_per_call"], "iters": k6["iters"][0],
                 "collectives_per_call": k6["collectives_per_call"],
                 "host_reads_per_call": k6["host_reads_per_call"],
                 "launches_by_mesh": {k: v["sharded_resample"] for k, v in mesh_launches.items()}})
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kernels": kernels, "k3": k3,
                       f"kernels_h{H16}": h16,
                       **slices, "flow_library": flow_library, "main_cli": cli,
                       "kernels_rows_ne_cols": rect, "k6": k6,
                       **meshes}, fh, indent=1)
    print(json.dumps({"kernels": line}), flush=True)
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
