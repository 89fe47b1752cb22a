#!/usr/bin/env python3
"""Same-process A/B of the streaming Sinkhorn loop's chunk size on one GPU.

    python3 tools/k3_chunk_ab.py [--chunk 8] [--rounds 2] [--out ab.json]

K3 (``ot_resample_streaming``) runs ``LOOP_CHUNK`` iterations of (K1, the
fused update) per CUDA-graph replay and reads its stop flag on the host
once per replay.  This script sets ``LOOP_CHUNK`` to 1 and to ``--chunk`` in
turns (1, k, k, 1, ``--rounds`` times; at N=100 the chunk rule takes
``LOOP_CHUNK``) and, for the bootstrap DPF and the
CNF-DPF at ``chip_smoke.py``'s full width (B=32, N=100, T=50, every step
resampled), takes 3 train steps (host clock, synchronised), counts the host
syncs of the first (``torch.cuda.set_sync_debug_mode``) and profiles one
more (device busy time, idle share, launches; torch.profiler).  Each turn
builds a fresh trainer from the same seed, so every turn computes the same
steps: the Sinkhorn iterations must be equal across turns (the losses are
reported: cuDNN's algorithms move their last digits from trainer to
trainer).
Prints the card's name and power limit, then one JSON line.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chunk", type=int, default=None,
                        help="the chunk set against 1 (default: LOOP_CHUNK)")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--out", help="also write the JSON line to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k3_chunk_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as smoke
    from nfdpf_torch import DPFConfig
    from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc
    from nfdpf_torch.train import Trainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    chunk = args.chunk or sc.LOOP_CHUNK
    order = [1, chunk, chunk, 1] * args.rounds
    slices = {"slice": smoke.SLICE, "slice_cnf": smoke.CNF_SLICE}
    turns = []
    for k in order:
        sc.LOOP_CHUNK = k
        for name, settings in slices.items():
            cfg = DPFConfig(**settings)
            trainer = Trainer(cfg)
            batch = smoke.synthetic_batch(cfg, trainer.device, seed=1)
            # one step first, so that every shape's graph is captured outside the timed steps
            trainer.train_step(batch, generator=trainer.generator(9))
            torch.cuda.synchronize()
            times, iters, losses = [], [], []
            for i in range(3):
                sc.reset_streaming_loop()
                t0 = time.perf_counter()
                if i == 0:
                    metrics, syncs = smoke.count_syncs(
                        lambda: trainer.train_step(batch, generator=trainer.generator(10)))
                    reads = sc.STREAMING_LOOP["host_reads"]
                else:
                    metrics = trainer.train_step(batch, generator=trainer.generator(10 + i))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                iters.append(int(metrics["sinkhorn_iters"]))
                losses.append(float(metrics["loss"]))
            prof = smoke.profile_step(trainer, batch)
            turns.append({"chunk": k, "slice": name, "step_s": times,
                          "median_step_ms": statistics.median(times) * 1e3,
                          "syncs_step0": syncs, "loop_host_reads_step0": reads,
                          "sinkhorn_iters": iters, "losses": losses,
                          **{key: prof[key] for key in ("wall_ms", "device_busy_ms",
                                                        "device_idle_share", "launches",
                                                        "launches_by_kernel")}})
            del trainer, batch
            torch.cuda.empty_cache()
    bad = []
    for name in slices:
        runs = [t for t in turns if t["slice"] == name]
        if any(t["sinkhorn_iters"] != runs[0]["sinkhorn_iters"] for t in runs):
            bad.append(f"{name}: Sinkhorn iterations differ across turns")
    summary = {name: {k: statistics.median(t["median_step_ms"] for t in turns
                                           if t["slice"] == name and t["chunk"] == k)
                      for k in sorted(set(order))} for name in slices}
    row = {"card": card.strip().splitlines()[0], "chunk": chunk, "order": order,
           "median_step_ms_by_chunk": summary, "turns": turns}
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(row, fh, indent=1)
    if bad:
        print("; ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
