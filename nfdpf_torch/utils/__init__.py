"""Utilities: checkpointing, metrics logging, parameter freezing, profiling."""

from nfdpf_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from nfdpf_torch.utils.metrics import MetricsLogger

__all__ = ["save_checkpoint", "restore_checkpoint", "MetricsLogger"]
