"""Checkpoints with true epoch resume.

Counterpart of ``nfdpf_tpu/utils/checkpoint.py``: a checkpoint is a
*directory*, as orbax writes one, holding the tree (module and optimizer
state dicts, the epoch) in one ``torch.save`` file, so callers test for one
with ``os.path.isdir``.  The file is written beside its final name and
renamed into place, so a cut run leaves the previous checkpoint whole.  In
a multi-process run only the primary rank writes, and every rank loads.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from nfdpf_torch.parallel.distributed import is_primary

_FILE = "checkpoint.pt"


def save_checkpoint(path: str, tree: Any, group=None) -> None:
    """Save a tree of tensors, numbers, strings, lists and dicts into the
    directory ``path`` (created; an earlier checkpoint there is replaced).
    Only the primary rank writes; with a process ``group`` its ranks wait
    until the file is in place, so any of them may load it next."""
    if is_primary():
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, _FILE)
        tmp = target + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, target)
    if group is not None:
        torch.distributed.barrier(group=group)


def restore_checkpoint(path: str, map_location=None) -> Any:
    """The tree saved in ``path``, its tensors on ``map_location`` (as saved
    when None).  Loads tensors and plain containers only (``weights_only``)."""
    return torch.load(os.path.join(path, _FILE), map_location=map_location,
                      weights_only=True)


def checkpoint_metadata(path: str) -> Any:
    """The tree saved in ``path`` with every tensor on the meta device: its
    leaves carry ``.shape`` and ``.dtype`` and no data (torch skips the
    storages' records), the other leaves as saved.  Lets a caller build a
    matching template, or pick a format, before reading any array."""
    return restore_checkpoint(path, map_location="meta")


def latest_checkpoint(root: str, prefix: str = "ckpt_") -> Optional[str]:
    """The ``{prefix}<n>`` entry of ``root`` with the largest ``n``, or None."""
    if not os.path.isdir(root):
        return None
    cands = [d for d in os.listdir(root) if d.startswith(prefix)]
    if not cands:
        return None
    cands.sort(key=lambda d: int(d[len(prefix):]))
    return os.path.join(root, cands[-1])
