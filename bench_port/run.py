"""Run one cell of the port's benchmark and print its result as one JSON line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration file and a traffic file
(``bench_port/benchlib/spec.py``).  The run, on one CUDA card:

1. set-up (``setup_s``, from the process's start): import the port, make
   the traffic's work set on the card from the traffic file's ``work_seed``
   and the checked steps from ``--seed`` (``benchlib/traffic.py``), build
   the ``nfdpf_torch.train.Trainer`` with the initial weights drawn on the
   card from ``work_seed``, warm up the resampler's CUDA graph at the
   cell's shapes, then drive the trainer through the checked steps (which
   also build the CUDA libraries);
2. the window: ``Trainer.train_step`` on the work set, pass after pass,
   each pass from the initial weights with a fresh Adam, for ``--seconds``
   and on to the end of a whole pass, ending in ``torch.cuda.synchronize()``;
   ``train_transitions_per_s`` is B·N·T times the steps over the window's
   wall time, ``peak_mem_gib`` the allocator's peak over it;
3. with ``--trace 1``: one more step counting host syncs, then the work
   set's first ``TRACE_STEPS`` steps under ``torch.profiler``, with spans
   around the resampler's and the flows' entries, and the per-layer metrics
   read by ``bench_port/metrics/<metric>.py``;
4. the check: the program's state is freed and the plain reference
   (``bench_port/reference/``) follows the checked steps from the same
   weights, batches and draws; ``correct`` holds when each compared number is
   within its limit (``bench_port/benchlib/check.py``).

It exits non-zero and prints no result without a CUDA card, or when JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
if str(HERE.parent) not in sys.path:
    sys.path.insert(1, str(HERE.parent))

FORBIDDEN = ("jax", "jaxlib", "flax", "nfdpf_tpu")
# train steps under each of the traced run's two profilers
TRACE_STEPS = 2


class NoCard(RuntimeError):
    pass


def process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE_AT_T0 = process_age_s()


def since_start() -> float:
    return _AGE_AT_T0 + time.perf_counter() - _T0


def log(what: str) -> None:
    """A progress line on standard error, with the seconds since the start."""
    print(f"bench_port: {since_start():9.2f} s  {what}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


SMI_FIELDS = ("power.limit", "power.draw", "clocks.sm", "clocks.max.sm", "temperature.gpu")


def card_state() -> dict:
    """``nvidia-smi``'s reading of the first card: power limit and draw (W),
    SM clock and its maximum (MHz), temperature (C); {} where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        values = [float(v) for v in out.stdout.splitlines()[0].split(",")]
        return dict(zip(SMI_FIELDS, values))
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return {}


def build_config(cell: dict, overrides: dict | None = None):
    """The ``DPFConfig`` a cell runs and its traffic spec (``overrides``,
    for tests at a tiny size, replace traffic fields)."""
    from benchlib.traffic import CONFIG_FIELDS
    from nfdpf_torch import DPFConfig

    traffic = {**cell["traffic"], **(overrides or {})}
    fields = dict(cell["config_fields"])
    for key in CONFIG_FIELDS:
        fields[key] = traffic[key]
    return DPFConfig(**fields), traffic


class Program:
    """The system under test: the trainer with the initial weights, the
    work set of the window and the checked steps of the seed."""

    def __init__(self, cfg, traffic_spec: dict, seed: int, device, parts: dict, trainer=None):
        import torch

        from benchlib import traffic
        from benchlib.weights import initial_state
        from nfdpf_torch.train import Trainer

        self.cfg, self.device = cfg, torch.device(device)
        t = time.perf_counter()
        self.work = traffic.work_set(traffic_spec, device, cfg.width, cfg.labeled_ratio)
        self.checked = traffic.checked_set(traffic_spec, seed, device, cfg.width,
                                           cfg.labeled_ratio)
        self._sync()
        parts["pool_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.trainer = Trainer(cfg, device=device) if trainer is None else trainer
        self._sync()
        parts["trainer_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.start = initial_state(self.trainer.engine, traffic_spec["work_seed"], device)
        self.restore()
        self._sync()
        parts["weights_s"] = time.perf_counter() - t
        self.next_step = 0

    def restore(self):
        """The initial weights and BatchNorm statistics, and a fresh Adam."""
        self.trainer.engine.load_state_dict(self.start)
        self.trainer.optimizer.state.clear()

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self):
        """One train step of the window: the work set's next step, the
        first of a pass from the initial weights with a fresh Adam."""
        k = self.next_step % self.work.count
        if k == 0:
            self.restore()
        self.next_step += 1
        return self.trainer.train_step(self.work.batch(k), noise=self.work.draws(k))

    def rewind(self):
        """The next step starts a pass."""
        self.next_step = 0

    def warm_resampler(self):
        """Warm the streaming resampler at the cell's shapes (its CUDA graph
        is captured at a shape's first call), forward and backward, where the
        configuration resamples on it: a cell whose gate seldom fires would
        otherwise capture it inside the window."""
        import torch

        from nfdpf_torch.models import dpf
        from nfdpf_torch.ops.cuda import sinkhorn_cuda

        cfg = self.cfg
        if not dpf.streaming_ot(cfg):
            return
        gen = torch.Generator(device=self.device).manual_seed(0)
        b, n = cfg.batch_size, cfg.num_particles
        x = (torch.randn((b, n, 2), generator=gen, device=self.device) * 20.0).requires_grad_()
        probs = torch.softmax(torch.randn((b, n), generator=gen, device=self.device), dim=-1)
        out = sinkhorn_cuda.ot_resample_streaming(
            x, probs, eps=cfg.epsilon, scaling=cfg.scaling, threshold=cfg.threshold,
            max_iter=cfg.max_iter, convergence=cfg.sinkhorn_convergence)
        out[0].sum().backward()
        self._sync()

    def checked_steps(self) -> dict:
        """The checked steps from the initial weights, recorded for the
        check: each loss, the first gradient from Adam's first moment after
        one step, the leaves after the last."""
        engine, opt = self.trainer.engine, self.trainer.optimizer
        names = {p: name for name, p in engine.named_parameters()}
        beta1 = opt.param_groups[0]["betas"][0]
        record = {"loss": [], "loss_sup": [], "loss_ae": [], "firings": [], "iters": []}
        self.restore()
        for k in range(self.checked.count):
            m = self.trainer.train_step(self.checked.batch(k), noise=self.checked.draws(k))
            for key in ("loss", "loss_sup", "loss_ae"):
                record[key].append(float(m[key]))
            record["firings"].append(int(m["resample_count"]))
            record["iters"].append(int(m["sinkhorn_iters"]))
            if k == 0:
                record["grad"] = {names[p]: st["exp_avg"].detach().clone() / (1.0 - beta1)
                                  for p, st in opt.state.items() if "exp_avg" in st}
        record["params"] = {name: p.detach().clone() for name, p in engine.named_parameters()}
        record["start"] = {name: self.start[name] for name in record["params"]}
        return record

    def checked_inputs(self) -> list:
        """The checked steps' (batch, draws), for the reference."""
        return [(self.checked.batch(k), self.checked.draws(k)) for k in range(self.checked.count)]


def counters() -> dict:
    from nfdpf_torch.ops import sinkhorn as dense
    from nfdpf_torch.ops.cuda import sinkhorn_cuda

    return {"streaming": dict(sinkhorn_cuda.STREAMING_LOOP), "dense": dict(dense.DENSE_LOOP)}


def delta(after: dict, before: dict) -> dict:
    return {k: {c: after[k][c] - before[k][c] for c in after[k]} for k in after}


def count_syncs(fn):
    """Run ``fn`` with CUDA's sync debugging on; (result, syncs reported)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return result, sum("synchroniz" in str(w.message) for w in caught)


def traced_window(program: Program, steps: int, on_card: bool) -> dict:
    """The traced steps, the work set's first ``steps`` steps twice: first
    under a profiler that records the device alone (the device's busy time
    and the window's wall time, with the least overhead on the host), then
    under one that also records the host, with spans around the resampler's
    and the packed flows' entries (the layers' device time and the
    breakdown)."""
    import torch

    from benchlib import trace
    from nfdpf_torch.models import dpf, dynamics

    def profiled(activities, annotate: bool):
        program.rewind()
        program._sync()
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(trace.PREFIX + "window") if annotate \
                    else contextlib.nullcontext():
                t0 = time.perf_counter()
                for _ in range(steps):
                    program.step()
                program._sync()
                wall = time.perf_counter() - t0
        return trace.read_events(prof), wall

    cpu, cuda = torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA
    device_only, window_s = profiled([cuda] if on_card else [cpu], False)
    busy_s = trace.busy_ns(device_only["device"]) / 1e9

    ot_calls, coupling_calls = [], []

    def describe_ot(args, out):
        b, n, _ = args[0].shape
        return {"b": b, "n": n, "iters": int(out[3])}

    def describe_coupling(args, out):
        x, ctx, weights = args[0], args[1], args[2]
        rows = x.shape[0] * x.shape[1]
        broadcast = ctx is not None and ctx.stride(1) == 0
        return {"rows": rows, "ctx_rows": (x.shape[0] if broadcast else rows) if ctx is not None
                else 0, "ctx_dim": 0 if ctx is None else ctx.shape[-1],
                "n_blocks": weights.shape[0], "hidden": weights.shape[-1],
                "max_in": weights.shape[3]}

    ot = trace.spanned(dpf.ot_resample_streaming, "ot_resample", ot_calls, describe_ot)
    cp = trace.spanned(dynamics.fused_coupling_chain, "coupling", coupling_calls,
                       describe_coupling)
    with trace.patched(dpf, "ot_resample_streaming", ot), \
            trace.patched(dynamics, "fused_coupling_chain", cp):
        events, spans_wall_s = profiled([cpu, cuda] if on_card else [cpu], True)
    main = next((tid for name, _, _, tid, _ in events["host"]
                 if name == trace.PREFIX + "window"), None)
    return {"events": events, "window_s": window_s, "busy_s": busy_s, "steps": steps,
            "spans_window_s": spans_wall_s,
            "spans_busy_s": trace.busy_ns(events["device"]) / 1e9,
            "attributed_share": trace.attributed_share(events),
            "ot_calls": ot_calls, "coupling_calls": coupling_calls,
            "breakdown": trace.breakdown(events, main)}


def run_cell(cell: dict, seed: int, seconds: float, trace_on: bool, device: str = "cuda",
             overrides: dict | None = None) -> dict:
    """One run of one cell (``benchlib.spec.cell``'s record); returns the
    result object (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, [``breakdown``], ``check``) and what the run learnt besides,
    under other keys."""
    from benchlib import check, spec

    import torch

    from nfdpf_torch.train import Trainer  # noqa: F401  (the import is set-up)

    parts = {"import_s": since_start()}
    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell["entry"]["chips"]):
        raise NoCard(f"the cell needs {cell['entry']['chips']} CUDA card(s); "
                     f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    cfg, traffic = build_config(cell, overrides)
    log(f"imported; building {cell['entry']['name']} at seed {seed}")
    program = Program(cfg, traffic, seed, device, parts)
    log(f"pool {parts['pool_s']:.2f} s, trainer {parts['trainer_s']:.2f} s, "
        f"weights {parts['weights_s']:.2f} s")
    t = time.perf_counter()
    program.warm_resampler()
    record = program.checked_steps()
    program._sync()
    parts["warmup_s"] = time.perf_counter() - t
    try:
        from nfdpf_torch.ops.cuda import build

        parts["libraries_s"] = sum(v.get("seconds", 0.0) for v in build.build_log.values())
    except ImportError:
        parts["libraries_s"] = None

    log(f"warm-up and checked steps {parts['warmup_s']:.2f} s; the window")
    # ---- the window
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    before = counters()
    losses = []
    setup_s = since_start()
    t0 = time.perf_counter()
    ends = []
    while True:
        losses.append(program.step()["loss"])
        ends.append(time.perf_counter() - t0)
        # whole passes over the work set, the first end after --seconds
        if time.perf_counter() - t0 >= seconds and len(losses) % program.work.count == 0:
            break
    program._sync()
    window_s = time.perf_counter() - t0
    card = card_state() if on_card else {}
    losses = [float(v) for v in losses]
    window = {"seconds": window_s, "steps": len(losses), "step_ends_s": ends, "losses": losses,
              **delta(counters(), before)}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    failed = int(sum(not math.isfinite(v) for v in losses))
    b, n, t_len = cfg.batch_size, cfg.num_particles, cfg.sequence_length
    transitions = b * n * t_len * len(losses) / window_s

    log(f"window {window_s:.2f} s, {len(losses)} steps")
    # ---- the traced run's extra steps
    traced = None
    if trace_on:
        program.rewind()
        before = counters()
        if on_card:
            _, syncs = count_syncs(program.step)
        else:
            program.step()
            syncs = None
        sync_counts = delta(counters(), before)
        traced = traced_window(program, TRACE_STEPS, on_card)
        traced.update(syncs=syncs, sync_step_counters=sync_counts)

        log(f"traced 2 x {traced['steps']} steps, {traced['window_s']:.2f} s "
            f"and {traced['spans_window_s']:.2f} s")
    # ---- the check, with the program's state freed
    program.trainer = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    from reference.model import follow

    t = time.perf_counter()
    reference = follow(cfg, program.start, program.checked_inputs(), device)
    reference_s = time.perf_counter() - t
    log(f"reference {reference_s:.2f} s")
    numbers = check.compare(record, reference)
    limits = cell["limits"]
    correct = check.verdict(numbers, limits) and failed == 0

    ctx = {"cfg": cfg, "window": window, "trace": traced, "b": b, "n": n, "t": t_len}
    if trace_on:
        metrics = {}
        for m in cell["per_layer"]:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"train_transitions_per_s": transitions, "peak_mem_gib": peak / 2**30,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["entry"]["chips"], "memory_peak_bytes": int(peak),
           "power_limit_w": card.get("power.limit")}
    result = {"correct": bool(correct), "attempted": len(losses), "failed": failed,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = traced["breakdown"]
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NUMBERS}
    extra = {"setup_parts": parts, "reference_s": reference_s, "window": window, "card": card,
             "checked": {"loss": record["loss"], "firings": record["firings"],
                         "iters": record["iters"], "ref_loss": reference["loss"],
                         "loss_ae": record["loss_ae"], "ref_loss_ae": reference["loss_ae"],
                         "ref_firings": reference["firings"], "ref_iters": reference["iters"],
                         **{k: numbers[k] for k in numbers if k not in check.NUMBERS}}}
    if traced is not None:
        extra["trace"] = {"syncs": traced["syncs"], "sync_step": traced["sync_step_counters"],
                          "ot_calls": len(traced["ot_calls"]),
                          "coupling_calls": len(traced["coupling_calls"]),
                          "steps": traced["steps"], "spans_window_s": traced["spans_window_s"],
                          "spans_busy_s": traced["spans_busy_s"],
                          "attributed_share": traced["attributed_share"]}
    return {"result": result, "extra": extra}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        from benchlib import spec

        out = run_cell(spec.cell(args.workload), args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"bench_port: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    result = out["result"]
    print(json.dumps({"bench_port_extra": out["extra"]}, default=str), file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
