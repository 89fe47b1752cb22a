"""The readings that a cell's limits for ``correct`` are set from.

    python3 bench_port/readings.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--steps K]

For each seed, in one process: the program's checked steps exactly as a
benchmark run takes them (``run.Program``), then the plain reference over
the same steps, and the compared numbers (``benchlib/check.py``).  Besides
the sound runs:

* ``--control-seeds``: the control, the program's own bfloat16 path
  (``compute_dtype="bfloat16"``: the encoder and decoder in bfloat16), the
  nearest precision below the configuration's float32;
* ``--fault-seeds``: a fault planted in the program, half of the batch left
  out and the loss's mean taken over the rest.  A step that leaves the state
  unchanged reads 1 on ``update_gap`` by the measure and needs no run.

Each reading is one JSON line on standard output.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import run  # noqa: E402


def half_batch(trainer) -> None:
    """Plant the fault: ``trainer.train_step`` sees the first half of each
    batch and of its draws."""
    step = trainer.train_step

    def broken(batch, noise=None, generator=None):
        half = batch["image"].shape[0] // 2
        batch = {k: v[:half] for k, v in batch.items()}
        noise = {k: (v[:, :half] if k == "motion" else v[:half]) for k, v in noise.items()}
        return step(batch, noise=noise, generator=generator)

    trainer.train_step = broken


_TRAINERS: dict = {}


def reading(cell: dict, seed: int, kind: str, device: str, overrides=None) -> dict:
    """One reading: ``kind`` is "sound", "control" or "half_batch".  One
    trainer per configuration serves every seed (``run.Program`` loads the
    initial weights into it and gives it a fresh Adam)."""
    import torch

    from benchlib import check
    from reference.model import follow

    cfg, traffic = run.build_config(cell, overrides)
    program_cfg = cfg.replace(compute_dtype="bfloat16") if kind == "control" else cfg
    from nfdpf_torch.train import Trainer

    if program_cfg not in _TRAINERS:
        _TRAINERS[program_cfg] = Trainer(program_cfg, device=device)
    trainer = _TRAINERS[program_cfg]
    trainer.__dict__.pop("train_step", None)          # a planted fault of an earlier reading
    program = run.Program(program_cfg, traffic, seed, device, {}, trainer=trainer)
    if kind == "half_batch":
        half_batch(program.trainer)
    t = time.perf_counter()
    record = program.checked_steps()
    program._sync()
    program_s = time.perf_counter() - t
    program.trainer = trainer = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    reference = follow(cfg, program.start, program.checked_inputs(), device)
    numbers = check.compare(record, reference)
    return {"kind": kind, "seed": seed, **numbers, "program_s": program_s,
            "reference_s": time.perf_counter() - t, "loss": record["loss"],
            "ref_loss": reference["loss"], "firings": record["firings"],
            "ref_firings": reference["firings"], "iters": record["iters"],
            "ref_iters": reference["iters"], "loss_sup": record["loss_sup"],
            "ref_loss_sup": reference["loss_sup"], "loss_ae": record["loss_ae"],
            "ref_loss_ae": reference["loss_ae"]}


def main(argv=None) -> int:
    from benchlib import spec

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    for kind, seeds in (("sound", args.seeds), ("control", args.control_seeds),
                        ("half_batch", args.fault_seeds)):
        for seed in seeds:
            print(json.dumps(reading(cell, seed, kind, args.device), default=str), flush=True)
    found = run.forbidden_modules()
    if found:
        print(f"readings: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
