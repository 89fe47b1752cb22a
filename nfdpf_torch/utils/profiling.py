"""Profiling: a ``torch.profiler`` trace and a particle-throughput counter.

Counterpart of ``nfdpf_tpu/utils/profiling.py``:

  * ``trace(logdir)``: context manager around ``torch.profiler`` (host, and
    the GPU when there is one) that writes a Chrome trace of everything
    inside to ``logdir/trace.json``;
  * ``ThroughputMeter``: particle transitions per second over training or
    filtering steps, fenced with ``torch.cuda.synchronize`` and with the
    warm-up steps discarded.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; the Chrome trace (Perfetto, chrome://tracing) goes
    to ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _fence(tensor) -> None:
    """Wait until the device that holds ``tensor`` has finished its work."""
    if torch.is_tensor(tensor) and tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)


class ThroughputMeter:
    """Particle transitions per second over training or filtering steps.

    Usage::

        meter = ThroughputMeter(batch=32, particles=100, seq_len=50, warmup=3)
        for step in ...:
            m = trainer.train_step(batch)
            meter.tick(m["loss"])
        print(meter.rate(m["loss"]))   # transitions/s over the post-warm-up steps
    """

    def __init__(self, batch: int, particles: int, seq_len: int, warmup: int = 3):
        self.transitions_per_step = batch * particles * seq_len
        self.warmup = warmup
        self._steps = 0
        self._t0: Optional[float] = None

    def tick(self, fence=None) -> None:
        """Count one step; pass an output tensor as ``fence`` so the clock
        starts only once the device has finished the warm-up steps."""
        self._steps += 1
        if self._steps == self.warmup:
            _fence(fence)
            self._t0 = time.perf_counter()

    def rate(self, fence=None) -> float:
        _fence(fence)
        timed_steps = self._steps - self.warmup
        if self._t0 is None or timed_steps <= 0:
            return float("nan")
        dt = time.perf_counter() - self._t0
        return self.transitions_per_step * timed_steps / dt
