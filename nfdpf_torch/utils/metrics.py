"""Metrics logging: JSON lines always; TensorBoard when it imports.

Counterpart of ``nfdpf_tpu/utils/metrics.py``, with the reference's scalar
tags.
"""

from __future__ import annotations

import json
import os
import time

from nfdpf_torch.parallel.distributed import is_primary


class MetricsLogger:
    """Scalar logger.  In a multi-process run only rank 0 writes (every rank
    sees the same reduced scalars)."""

    def __init__(self, log_dir: str, tensorboard: bool = True):
        self._enabled = is_primary()
        self._jsonl = None
        self._tb = None
        if not self._enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self._tb = SummaryWriter(log_dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if not self._enabled:
            return
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}
        ) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self) -> None:
        if not self._enabled:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
