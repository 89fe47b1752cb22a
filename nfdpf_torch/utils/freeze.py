"""Parameter freezing.

Counterpart of ``nfdpf_tpu/utils/freeze.py``.  A frozen top-level module
gets zero updates and no optimizer state at all: the optimizer is built
over the other parameters only, which is what
``optax.masked(..., set_to_zero)`` gives in the JAX package (its Adam
moments of a frozen subtree never move).

Example: freeze the pretrained autoencoder during end-to-end fine-tuning::

    opt = masked_optimizer(torch.optim.Adam, engine, frozen=("encoder", "decoder"),
                           lr=1e-4)
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch


def frozen_mask(module: torch.nn.Module, frozen: Iterable[str]) -> Dict[str, bool]:
    """For each parameter name of ``module``: True where its top-level
    submodule's name is in ``frozen``."""
    frozen = set(frozen)
    return {name: name.split(".")[0] in frozen for name, _ in module.named_parameters()}


def masked_optimizer(optimizer_cls, module: torch.nn.Module, frozen: Iterable[str],
                     **kwargs) -> torch.optim.Optimizer:
    """``optimizer_cls(params, **kwargs)`` over every parameter of ``module``
    outside the frozen top-level modules."""
    mask = frozen_mask(module, frozen)
    params = [p for name, p in module.named_parameters() if not mask[name]]
    return optimizer_cls(params, **kwargs)
