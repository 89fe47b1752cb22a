"""Disk-tracking data: the simulator and the npz dataset pipeline."""

from nfdpf_torch.data.simulator import DiskSimulator, generate_dataset
from nfdpf_torch.data.dataset import DiskDataset, iterate_batches

__all__ = ["DiskSimulator", "generate_dataset", "DiskDataset", "iterate_batches"]
