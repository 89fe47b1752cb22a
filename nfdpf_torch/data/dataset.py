"""npz dataset pipeline for the disk-tracking task.

The port's own copy of ``nfdpf_tpu/data/dataset.py`` (numpy only): the same
shard glob, field order and batch order for a seed, so shards written by
either package load in either.

Deviation from the reference, documented as in the JAX package: the
reference loads only the FIRST matching shard; here all shards are
concatenated unless ``max_files=1`` is passed.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

FIELDS = ("start_image", "start_state", "image", "state", "q", "visible")


class DiskDataset:
    """Loads ``{filename}*_{train,val,test}.npz`` shards into host arrays."""

    def __init__(
        self,
        data_path: str,
        filename: str,
        datatype: str = "train_data",
        max_files: Optional[int] = None,
    ):
        split = datatype.replace("_data", "")
        pattern = os.path.join(data_path, f"{filename}*{split}*.npz")
        files = sorted(glob.glob(pattern))
        if not files:
            raise FileNotFoundError(f"no dataset shards match {pattern}")
        if max_files is not None:
            files = files[:max_files]
        chunks: Dict[str, list] = {k: [] for k in FIELDS}
        for f in files:
            payload = dict(np.load(f, allow_pickle=True))[datatype].item()
            for k in FIELDS:
                chunks[k].append(np.asarray(payload[k]))
        self.data = {k: np.concatenate(v, axis=0) for k, v in chunks.items()}
        self.size = len(self.data["start_image"])

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx) -> Tuple[np.ndarray, ...]:
        return tuple(self.data[k][idx] for k in FIELDS)


def iterate_batches(
    dataset: DiskDataset,
    batch_size: int,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Epoch iterator yielding dict batches of host arrays, shuffled by
    ``np.random.default_rng(seed)`` and, with ``drop_last``, whole batches
    only (the reference DataLoader's semantics)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n = len(dataset)
    stop = n - (n % batch_size) if drop_last else n
    for lo in range(0, stop, batch_size):
        idx = order[lo : lo + batch_size]
        yield {k: dataset.data[k][idx] for k in FIELDS}
