#!/usr/bin/env python3
"""Paired timing of two batch sources for the port's train loop on one GPU.

    python3 tools/batch_source_ab.py [--pairs 2] [--num-examples 192] [--out ab.json]

``host``: ``iterate_batches`` over the dataset's numpy arrays, each batch
copied to the card inside the step, as ``Trainer.fit`` takes them from
``main``.  ``staged``: the uint8 frames and states copied to the card once,
each batch gathered there by a device index.

The data is made with the port's simulator on the card (T=50, 25
distractors, 128 px; ``--num-examples`` train sequences).  The trainer is
the CLI's with ``--NF-dyn --NF-cond --pallas-coupling --use-pallas`` (B=32,
N=100, default gate).  After one warm-up epoch of each source, train-only
epochs run in the order host, staged, staged, host, ``--pairs`` times, each
timed on the host clock up to a synchronise, as the loop runs them (no
sync between steps).  Apart from the epochs, the batch preparation alone
(host gather + copy, or card gather) is timed over 10 batches each.  Prints
the card's name and power limit, then one JSON line.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FLAGS = ["--NF-dyn", "--NF-cond", "--pallas-coupling", "--use-pallas"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--num-examples", type=int, default=192)
    parser.add_argument("--out", help="also write the JSON line to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("batch_source_ab: no CUDA device", file=sys.stderr)
        return 2
    from nfdpf_torch.config import parse_args
    from nfdpf_torch.data.dataset import DiskDataset, iterate_batches
    from nfdpf_torch.data.simulator import generate_dataset
    from nfdpf_torch.train import BATCH_KEYS, Trainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    cfg = parse_args(FLAGS)
    bs = cfg.batch_size
    with tempfile.TemporaryDirectory(prefix="nfdpf_ab_") as tmp:
        generate_dataset(tmp, num_examples=args.num_examples, file_size=args.num_examples,
                         pos_noise=cfg.true_pos_noise, sequence_length=cfg.sequence_length,
                         im_size=cfg.width, seed=0)
        ds = DiskDataset(tmp, f"toy_pn={cfg.true_pos_noise}_d=25_const", "train_data")
    n = len(ds)
    steps = n // bs
    trainer = Trainer(cfg)
    dev = trainer.device
    gen = trainer.generator(0)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = {k: torch.as_tensor(ds.data[k]).to(dev) for k in BATCH_KEYS}
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0

    def host_batches(epoch):
        return iterate_batches(ds, bs, shuffle=True, drop_last=True, seed=epoch)

    def staged_batches(epoch):
        order = np.random.default_rng(epoch).permutation(n)[: steps * bs]
        idx = torch.as_tensor(order.reshape(steps, bs), device=dev)
        return ({k: v[ids] for k, v in staged.items()} for ids in idx)

    sources = {"host": host_batches, "staged": staged_batches}

    def epoch(source, e):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sups = [trainer.train_step(b, generator=gen)["loss_sup"] for b in sources[source](e)]
        torch.cuda.synchronize()
        return time.perf_counter() - t0, float(torch.stack(sups).mean())

    def prep_ms(source):
        out = []
        for e in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer._batch(next(iter(sources[source](e))))
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    warm = [epoch(s, 0)[0] for s in ("host", "staged")]
    order = ["host", "staged", "staged", "host"] * args.pairs
    epochs = []
    for e, source in enumerate(order, start=1):
        seconds, sup = epoch(source, e)
        epochs.append({"source": source, "s": seconds, "loss_sup": sup})
    blocks = [epochs[4 * i:4 * i + 4] for i in range(args.pairs)]
    gains = [(b[0]["s"] + b[3]["s"] - b[1]["s"] - b[2]["s"]) / (b[0]["s"] + b[3]["s"])
             for b in blocks]
    row = {
        "card": card.strip(), "torch": torch.__version__, "flags": FLAGS,
        "train_sequences": n, "batch_size": bs, "steps_per_epoch": steps,
        "stage_s": stage_s, "staged_gib": sum(v.nbytes for v in staged.values()) / 2**30,
        "warmup_s": dict(zip(("host", "staged"), warm)), "epochs": epochs,
        "median_epoch_s": {s: statistics.median(x["s"] for x in epochs if x["source"] == s)
                           for s in sources},
        "staged_gain_per_block": gains,
        "staged_faster_in_every_epoch_of_every_block": all(
            max(b[1]["s"], b[2]["s"]) < min(b[0]["s"], b[3]["s"]) for b in blocks),
        "prep_ms": {s: prep_ms(s) for s in sources},
    }
    row["median_prep_ms"] = {s: statistics.median(v) for s, v in row["prep_ms"].items()}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(row, fh, indent=1)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
