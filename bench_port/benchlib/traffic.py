"""The one generator of training traffic, driven by a traffic file.

A traffic file (``bench_port/traffic/<name>.json``) gives the batch B, the
particles N, the sequence length T, the ESS gate, and two sets of steps,
each step a batch of B sequences made on the card by the frozen simulator
and staged there (as ``Trainer.fit_fused`` stages an epoch) with its draws
(initial particles, motion noise, velocity noise, supervision mask):

* the work set, ``work_items`` steps drawn from the file's ``work_seed``,
  with the initial weights.  The window goes through it in its order, pass
  after pass, and each pass starts from the initial weights with a fresh
  Adam.  The Sinkhorn loop's iterations and the gate's firings follow the
  data and the weights, so every pass, and every run whatever its seed,
  does the same work;
* the checked steps, ``check_steps`` steps drawn from the run's ``--seed``,
  which set-up drives through the trainer from the initial weights before
  the window and the reference follows after it.

A given seed gives the same inputs every time; every seed gives the same
sizes and the same window.
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib.simulator import sequences

# the streams that seed the draws
POOL, STEP, WEIGHTS, CHECK = 1, 3, 4, 5
# the fields of a traffic file that are DPFConfig fields
CONFIG_FIELDS = ("batch_size", "num_particles", "sequence_length", "ess_threshold")


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for a stream of draws of ``seed`` (any whole number)."""
    words = np.random.SeedSequence([int(seed) % 2**64, *stream]).generate_state(2, np.uint32)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & (2**63 - 1)


def generator(device, seed: int, *stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *stream))


class Steps:
    """``count`` steps of traffic drawn from ``seed``: their batches staged
    on the card, and each step's draws."""

    def __init__(self, spec: dict, seed: int, count: int, device, width: int,
                 labeled_ratio: float):
        self.device = torch.device(device)
        self.width = width
        self.labeled_ratio = labeled_ratio
        self.seed = seed
        self.count = count
        self.b = spec["batch_size"]
        self.n = spec["num_particles"]
        self.t = spec["sequence_length"]
        sim = spec["simulator"]
        gen = generator(device, seed, POOL)
        parts = []
        pool = count * self.b
        for lo in range(0, pool, sim["chunk"]):
            parts.append(sequences(gen, min(sim["chunk"], pool - lo), self.t,
                                   sim["num_distractors"], sim["pos_noise"], width))
        self.pool = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def batch(self, k: int) -> dict:
        lo = k * self.b
        return {key: v[lo:lo + self.b] for key, v in self.pool.items()}

    def draws(self, k: int) -> dict:
        """The draws of step ``k``, in the layout ``Trainer.train_step``'s
        ``noise`` takes: init (B, N, 2) uniform over the frame, motion
        (T, B, N, 2) and vel (B, T, 2) standard normal, mask (B, T) with
        ⌊B·T·labeled_ratio⌋ ones."""
        gen = generator(self.device, self.seed, STEP, k)
        b, n, t, dev = self.b, self.n, self.t, self.device
        init = torch.rand((b, n, 2), generator=gen, device=dev) * self.width - self.width / 2.0
        motion = torch.randn((t, b, n, 2), generator=gen, device=dev)
        vel = torch.randn((b, t, 2), generator=gen, device=dev)
        labeled = int(b * t * self.labeled_ratio)
        flat = torch.cat([torch.zeros(b * t - labeled, device=dev),
                          torch.ones(labeled, device=dev)])
        mask = flat[torch.randperm(b * t, generator=gen, device=dev)].reshape(b, t)
        return {"init": init, "motion": motion, "vel": vel, "mask": mask}


def work_set(spec: dict, device, width: int, labeled_ratio: float) -> Steps:
    """The window's steps, from the traffic file's ``work_seed``."""
    return Steps(spec, spec["work_seed"], spec["work_items"], device, width, labeled_ratio)


def checked_set(spec: dict, seed: int, device, width: int, labeled_ratio: float) -> Steps:
    """The checked steps of a run, from its seed."""
    return Steps(spec, sub_seed(seed, CHECK), spec["check_steps"], device, width,
                 labeled_ratio)
