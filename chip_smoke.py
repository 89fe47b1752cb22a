#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nfdpf_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, one line of output each, then the device line last:

1. setup: the card's name and power limit (nvidia-smi), the kernels' build;
2. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the main path's shape (B=32, N=M=100) and a ragged one (B=4,
   N=M=4097), with its time, the plain version's time, the time of one
   PyTorch library call where one computes the same function, and the
   least time the card could take (bound);
3. slice: the bootstrap-DPF training step at full width (B=32, N=100, T=50,
   128×128×3 frames, OT resampling on the streaming-Sinkhorn kernels):
   3 train steps and 1 eval step, the launch counts of each kernel over
   them, step time, transitions/s, peak memory, device syncs per step;
4. parity: one loss + gradient on the kernels (cuda) and on the plain
   versions (cpu) from the same parameters and noise;
5. the ``kernels`` JSON line.

Every comparison runs with TF32 off.  Any failed check raises, so the
script exits non-zero without printing the last line.  The port has no CPU
fallback: with no CUDA device the script stops before any phase.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import warnings

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
# the kernels of the path → the TPU kernel each replaces.  K2's backward
# (Tᵀg, the same kernel with rows and columns swapped) is checked and timed
# in phase 2 but is not on this slice's path: the bootstrap DPF's particles
# carry no gradient (they come from noise and teacher-forced velocities),
# so autograd never asks for it.
KERNELS = {
    "sinkhorn_lse": "nfdpf_tpu/ops/pallas/sinkhorn_pallas.py:78",
    "transport_apply": "nfdpf_tpu/ops/pallas/sinkhorn_pallas.py:180",
}
KERNEL_SOURCE = "nfdpf_torch/ops/cuda/csrc/sinkhorn.cu"
LSE_TOL = 1e-5     # K1: |err| <= tol + tol·|ref|
APPLY_TOL = 1e-4   # K2: |err| <= tol·|ref| + tol·max|ref|


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


def phase_setup():
    from nfdpf_torch.ops.cuda import build    # fails first when the port is absent

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build("sinkhorn")
    info = build.build_log["sinkhorn"]
    ptxas = [ln.strip() for ln in info["ptxas"].splitlines() if "registers" in ln]
    log({"phase": "setup", "card": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
         "nvcc_s": info["seconds"], "ptxas": ptxas})
    return smi


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
    f4 = 4.0
    lse_bytes = lambda g_: f4 * (b + 4 * b * n + b * g_ * n + b * g_ * n)  # noqa: E731
    apply_bytes = f4 * (b + 4 * b * n + 2 * b * n + 2 * b * n + 2 * b * n)
    pairs = b * n * n
    return {
        "sinkhorn_lse_g1": dict(
            kernel=lambda: sc.streaming_lse_multi(eps, x, x, f1),
            plain=lambda: sc.lse_multi_plain(eps, x, x, f1),
            library=None, tol=("lse", LSE_TOL),
            nbytes=lse_bytes(1), ops=pairs * (7 + 4 * 1)),
        "sinkhorn_lse": dict(
            kernel=lambda: sc.streaming_lse_multi(eps, x, x, f2),
            plain=lambda: sc.lse_multi_plain(eps, x, x, f2),
            library=None, tol=("lse", LSE_TOL),
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
    """Every kernel against its plain version at both shapes; times at both."""
    from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc

    results = {}
    for (b, n), iters in (((32, 100), 200), ((4, 4097), 3)):
        cases = kernel_cases(b, n, seed=b + n)
        ag = cases.pop("_autograd")
        shape = f"B{b}_N{n}"
        for name, cs in cases.items():
            got, ref = cs["kernel"](), cs["plain"]()
            torch.cuda.synchronize()
            max_abs, rel = check(f"{name}@{shape}", got, ref, cs["tol"])
            bound, by = bound_ms(cs["nbytes"], cs["ops"])
            results.setdefault(name, {})[shape] = {
                "max_abs_err": max_abs, "max_rel_err": rel, "tol": cs["tol"][1],
                "ms": device_ms(cs["kernel"], iters),
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
    log({"phase": "kernels", "results": results,
         "note": "K1 (sinkhorn_lse) has no single PyTorch call computing it: library_ms null"})
    return results


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


def phase_slice(profile: bool):
    from nfdpf_torch import DPFConfig
    from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc
    from nfdpf_torch.train import Trainer

    cfg = DPFConfig(**SLICE)
    trainer = Trainer(cfg)                           # on cuda: no device given
    batch = synthetic_batch(cfg, trainer.device, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    sc.reset_launches()
    steps = []
    for i in range(3):
        t0 = time.perf_counter()
        if i == 0:
            metrics, syncs = count_syncs(
                lambda: trainer.train_step(batch, generator=trainer.generator(10)))
        else:
            metrics = trainer.train_step(batch, generator=trainer.generator(10 + i))
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t0,
                      **{k: float(v) for k, v in metrics.items()}})
    train_launches = dict(sc.LAUNCHES)

    sc.reset_launches()
    t0 = time.perf_counter()
    ev, aux = trainer.eval_step(batch, generator=trainer.generator(20))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = dict(sc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    median_s = statistics.median(s["s"] for s in steps)
    transitions = cfg.batch_size * cfg.num_particles * cfg.sequence_length
    row = {"phase": "slice", "config": SLICE, "step_s": [s["s"] for s in steps],
           "median_step_ms": median_s * 1e3,
           "transitions_per_s": transitions / median_s,
           "losses": [s["loss"] for s in steps], "eval_loss": float(ev["loss"]),
           "eval_s": eval_s, "resample_count": [s["resample_count"] for s in steps],
           "sinkhorn_iters": [s["sinkhorn_iters"] for s in steps],
           "launches_train_3_steps": train_launches, "launches_eval": eval_launches,
           # the gate read on each step, plus the loop test on each iteration
           # and the one that ends each firing's loop
           "device_syncs_step0": syncs,
           "syncs_by_count_step0": cfg.sequence_length
           + int(steps[0]["sinkhorn_iters"] + steps[0]["resample_count"]),
           "peak_mem_gib": peak / 2**30}
    if profile:
        prof = profile_step(trainer, batch)
        row["profile"] = {k: v for k, v in prof.items() if k != "top"}
    log(row)
    if profile:
        row["profile"]["top"] = prof["top"]

    for s in steps:
        if not all(math.isfinite(s[k]) for k in ("loss", "loss_sup", "loss_ae")):
            raise AssertionError(f"non-finite training loss: {s}")
        if s["resample_count"] <= 0:
            raise AssertionError("the ESS gate never fired: the kernels were not on the path")
    if not math.isfinite(float(ev["loss"])):
        raise AssertionError(f"non-finite eval loss: {ev}")
    out = aux["filter_out"]
    if out.particles.shape != (cfg.batch_size, cfg.sequence_length, cfg.num_particles, 2):
        raise AssertionError(f"particle history shape {tuple(out.particles.shape)}")
    for launches in (train_launches, eval_launches):
        for name in KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the main path")
    return row


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
    groups = {"lse_kernel": 0.0, "apply_kernel": 0.0, "conv (cudnn)": 0.0, "other": 0.0}
    for r in rows:
        key = next((k for k in ("lse_kernel", "apply_kernel") if k in r["name"]), None)
        if key is None:
            key = "conv (cudnn)" if any(w in r["name"] for w in
                                        ("cudnn", "xmma", "grad_alg", "dgrad", "wgrad",
                                         "implicit_gemm", "nchwToNhwc", "nhwcToNchw")) else "other"
        groups[key] += r["device_ms"]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "launches": sum(r["count"] for r in rows), "by_group_ms": groups,
            "top": rows[:25]}


def phase_parity():
    """One loss + backward from the same parameters and noise on the kernels
    (cuda) and on the plain versions (cpu): B=4, T=10, N=100."""
    from nfdpf_torch import DPFConfig
    from nfdpf_torch.train import Trainer

    cfg = DPFConfig(**dict(SLICE, batch_size=4, sequence_length=10))
    b, t, n = cfg.batch_size, cfg.sequence_length, cfg.num_particles
    gen = torch.Generator().manual_seed(3)
    batch = synthetic_batch(cfg, "cpu", seed=4)
    noise = {"init": torch.rand(b, n, 2, generator=gen) * cfg.width - cfg.width / 2,
             "motion": torch.randn(t, b, n, 2, generator=gen),
             "vel": torch.randn(b, t, 2, generator=gen)}
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(cfg, device=device)         # same seed: same parameters
        dev_noise = {k: v.to(device) for k, v in noise.items()}
        loss, aux = trainer._loss({k: v.to(device) for k, v in batch.items()}, True,
                                  dev_noise)
        loss.backward()
        runs[device] = {
            "loss": loss.item(), "resampled": aux["filter_out"].resampled.tolist(),
            "iters": aux["filter_out"].sinkhorn_iters.tolist(),
            "grads": {k: p.grad.detach().cpu() for k, p in trainer.engine.named_parameters()}}
    gpu, cpu = runs["cuda"], runs["cpu"]
    if gpu["resampled"] != cpu["resampled"] or gpu["iters"] != cpu["iters"]:
        raise AssertionError(f"gate/iterations differ: cuda {gpu['iters']} cpu {cpu['iters']}")
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    worst = {}
    for name, g_cpu in cpu["grads"].items():
        rel = float((gpu["grads"][name] - g_cpu).norm() / g_cpu.norm().clamp_min(1e-30))
        bound = 1e-2 if name.startswith("decoder.") else 1e-3
        if not rel <= bound:
            raise AssertionError(f"gradient {name}: cuda vs cpu rel err {rel:.2e} > {bound}")
        worst[name.split(".")[0]] = max(worst.get(name.split(".")[0], 0.0), rel)
    if not loss_rel <= 1e-4:
        raise AssertionError(f"loss cuda {gpu['loss']} vs cpu {cpu['loss']}")
    log({"phase": "parity", "loss_cuda": gpu["loss"], "loss_cpu": cpu["loss"],
         "loss_rel_err": loss_rel, "loss_tol": 1e-4, "grad_rel_err_max": worst,
         "grad_tol": {"decoder": 1e-2, "other": 1e-3}, "iters": gpu["iters"]})


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

    card = phase_setup()
    kernels = phase_kernels()
    sl = phase_slice(args.profile)
    phase_parity()

    main_shape = "B32_N100"
    line = []
    for name, replaces in KERNELS.items():
        # K1's entry covers both of its instantiations (G=2 timed, G=1 checked)
        cases = [kernels[name]] + ([kernels["sinkhorn_lse_g1"]] if name == "sinkhorn_lse" else [])
        worst = max(c[s]["max_abs_err"] for c in cases for s in c)
        m = kernels[name][main_shape]
        line.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                     "replaces": replaces,
                     "launches": sl["launches_train_3_steps"][name], "max_abs_err": worst,
                     "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kernels": kernels, "slice": sl}, fh, indent=1)
    print(json.dumps({"kernels": line}), flush=True)
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
