"""The initial weights of a cell, drawn on the card from its traffic file's
``work_seed``.

One normal draw on the device covers every parameter; each leaf takes its
slice of it scaled by the rule below, which follows the program's own
initialisers (flax's defaults and the flows' N(0, 0.01²)):

* a BatchNorm scale 1 and shift 0, running mean 0 and variance 1;
* a conditioner layer of a flow (a parameter under a ``flows`` list)
  N(0, 0.01²), its bias 0;
* any other weight N(0, 1/fan_in) (a transposed conv's fan-in counts its
  input channels, as flax does), any other bias 0.

The same dictionary goes to the program and to the reference.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from benchlib.traffic import WEIGHTS, generator

FLOW_STD = 0.01


def _rule(module_type: str, name: str, shape) -> tuple:
    """(kind, std) of a parameter: kind "normal", "ones" or "zeros"."""
    leaf = name.rsplit(".", 1)[-1]
    if module_type.endswith("BatchNorm"):
        return ("ones", 0.0) if leaf == "weight" else ("zeros", 0.0)
    if len(shape) < 2:
        return "zeros", 0.0
    if ".flows." in f".{name}":
        return "normal", FLOW_STD
    if module_type == "ConvTranspose2d":
        fan_in = shape[0] * math.prod(shape[2:])
    else:
        fan_in = math.prod(shape[1:])
    return "normal", 1.0 / math.sqrt(fan_in)


def initial_state(model: nn.Module, seed: int, device) -> dict:
    """A state dict for ``model``'s parameters and buffers, drawn on
    ``device`` from ``seed``."""
    owners = {}
    for mod_name, module in model.named_modules():
        for p_name, _ in module.named_parameters(recurse=False):
            owners[f"{mod_name}.{p_name}" if mod_name else p_name] = type(module).__name__
    params = dict(model.named_parameters())
    total = sum(p.numel() for p in params.values())
    draw = torch.randn(total, generator=generator(device, seed, WEIGHTS), device=device)
    state, offset = {}, 0
    for name, p in params.items():
        kind, std = _rule(owners[name], name, tuple(p.shape))
        if kind == "normal":
            state[name] = (draw[offset:offset + p.numel()] * std).reshape(p.shape)
        else:
            state[name] = (torch.ones if kind == "ones" else torch.zeros)(
                p.shape, device=device)
        offset += p.numel()
    for name, buf in model.named_buffers():
        leaf = name.rsplit(".", 1)[-1]
        state[name] = (torch.ones if leaf == "running_var" else torch.zeros)(
            buf.shape, dtype=buf.dtype, device=device)
    return state
