"""Where the card sits idle in traced train steps, by the port's spans.

    python3 tools/idle_by_span.py [--workload <cell>] [--seed <n>] [--steps 2]
                                  [--out <file.json>]

Builds a cell of ``BENCHMARK.json`` as its harness does (``bench_port/run.py``:
the work set, the trainer, the initial weights), warms it up with two steps,
then takes the work set's first ``--steps`` steps under a ``torch.profiler``
that records the host and the device, as the harness's traced run does.
Each idle gap of the device (between consecutive device operations, their
intervals merged) goes to the innermost ``nfdpf_torch::`` span open at the
gap's start on the thread that launched the operation ending the gap, else
to the innermost one open then on the thread that took the steps (a
``backward`` whose kernels the autograd thread launches), else to "none".
Prints, as one JSON line, the window's wall time, the device's busy and
idle seconds, the idle seconds by span and by the step's parts
(``ot.loop``, ``filter.gate``, the rest of the forward, ``backward``,
``optimizer``, none), each also as a share of the window.  Needs a CUDA
card.  The harness's per-layer metrics ``ot_loop_idle_share`` and
``gate_idle_share`` read the first two parts by the rule's first half.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "bench_port"))
sys.path.insert(1, str(ROOT))

PARTS = ("ot.loop", "filter.gate", "backward", "optimizer")


def attribute(events: dict, main_tid) -> dict:
    """Idle ns by innermost span and by part of the step."""
    from benchlib import spans as program_spans
    from benchlib import trace

    by_thread: dict = {}
    for name, s, e, tid, _ in events["host"]:
        if name.startswith(program_spans.PREFIX):
            by_thread.setdefault(tid, []).append((s, e, name[len(program_spans.PREFIX):]))
    index = {tid: (sorted(v), [s for s, _, _ in sorted(v)]) for tid, v in by_thread.items()}

    def chain(tid, ts):
        """The names of the spans open at ``ts`` on ``tid``, innermost first."""
        if tid not in index:
            return []
        spans, starts = index[tid]
        names = []
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0:
            s, e, name = spans[i]
            if s <= ts <= e:
                names.append(name)
            i -= 1
        return names

    by_span: dict = {}
    by_part = {part: 0 for part in PARTS + ("forward, other spans", "none")}
    for g0, g1, corr in program_spans.idle_gaps(events):
        launch = trace.launch_of(events, corr)
        names = chain(launch[1], g0) if launch is not None else []
        if not names:
            names = chain(main_tid, g0)
        key = names[0] if names else "none"
        by_span[key] = by_span.get(key, 0) + g1 - g0
        if any(n.endswith(".bwd") for n in names):
            names.append("backward")
        part = next((p for p in PARTS if p in names),
                    "forward, other spans" if names else "none")
        by_part[part] += g1 - g0
    return {"by_span": by_span, "by_part": by_part}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="bootstrap_dpf.n10k_resample_every_step")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    import run
    from benchlib import spec, trace

    cfg, traffic = run.build_config(spec.cell(args.workload))
    program = run.Program(cfg, traffic, args.seed, "cuda", {})
    program.warm_resampler()
    for _ in range(2):
        program.step()
    program.rewind()
    program._sync()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            program.step()
        program._sync()
        window_s = time.perf_counter() - t0
    events = trace.read_events(prof)
    busy_s = trace.busy_ns(events["device"]) / 1e9
    # the thread that took the steps, as the profiler numbers it
    main_tid = next((tid for name, _, _, tid, _ in events["host"]
                     if name == "nfdpf_torch::train_step"), threading.get_native_id())
    found = attribute(events, main_tid)
    gaps_s = sum(found["by_part"].values()) / 1e9
    out = {"workload": args.workload, "steps": args.steps, "window_s": window_s,
           "busy_s": busy_s, "idle_s": window_s - busy_s,
           "idle_share": 100.0 * (1 - busy_s / window_s),
           # before the first device operation and after the last
           "idle_outside_gaps_s": window_s - busy_s - gaps_s,
           "by_part_s": {k: v / 1e9 for k, v in found["by_part"].items()},
           "by_part_share": {k: 100.0 * v / 1e9 / window_s for k, v in found["by_part"].items()},
           "by_span_s": {k: v / 1e9 for k, v in sorted(found["by_span"].items(),
                                                        key=lambda kv: -kv[1])}}
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
