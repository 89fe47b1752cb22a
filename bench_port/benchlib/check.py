"""What decides ``correct``: the program's first train steps against the
plain reference's, from the same weights, batches and draws.

Four numbers, each against a limit of its own (``bench_port/limits/<cell>.json``):

* ``loss_gap``: the largest relative gap of a followed step's loss;
* ``ae_loss_gap``: the same of the loss's autoencoder term (the decoder's
  reconstruction of the frames), the number that a lower precision of the
  encoder and decoder moves most;
* ``grad_gap``: the first step's gradient, as the program's Adam holds it
  after one step (its first moment over 1 − β1), by the worst leaf: the gap
  between the program's norm of the leaf and the reference's, over the
  larger of the reference's norm of that leaf and of the median leaf;
* ``update_gap``: the same measure of each leaf's change over the followed
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move under Adam by round-off).

A leaf that one side moves and the other does not reads 1 or more.
"""

from __future__ import annotations

import math

import torch

NUMBERS = ("loss_gap", "ae_loss_gap", "grad_gap", "update_gap")
TINY_GRADIENT = 1e-3


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _worst(prog: dict, ref: dict, keys) -> tuple:
    """(largest gap of norms over ``keys`` against max(ref leaf, median), leaf)."""
    med = _median([ref.get(k, 0.0) for k in keys])
    worst, leaf = 0.0, None
    for k in keys:
        scale = max(ref.get(k, 0.0), med)
        gap = abs(prog.get(k, 0.0) - ref.get(k, 0.0)) / scale if scale > 0 else 0.0
        if not math.isfinite(gap):
            gap = math.inf
        if gap > worst or leaf is None:
            worst, leaf = gap, k
    return worst, leaf


def _median(values) -> float:
    values = sorted(values)
    if not values:
        return 0.0
    mid = len(values) // 2
    return values[mid] if len(values) % 2 else 0.5 * (values[mid - 1] + values[mid])


def _relative(program: list, reference: list) -> float:
    """The largest relative gap of the program's values from the reference's
    (infinite where the program's is not finite)."""
    if not all(math.isfinite(v) for v in program):
        return math.inf
    return max(abs(p - r) / abs(r) if r != 0 else abs(p - r) for p, r in zip(program, reference))


def compare(program: dict, reference: dict) -> dict:
    """The numbers from the program's record (``loss``, ``loss_ae`` and
    ``loss_sup``: per step; ``grad``:
    step 1's gradient by leaf; ``start``/``params``: the leaves before the
    first step and after the last followed one) and the reference's
    (``follow``'s result)."""
    steps = len(reference["loss"])
    loss_gap = _relative(program["loss"][:steps], reference["loss"])
    g_prog, g_ref = _norms(program["grad"]), _norms(reference["grad"])
    grad_keys = sorted(set(g_prog) | set(g_ref))
    grad_gap, grad_leaf = _worst(g_prog, g_ref, grad_keys)
    med = _median([g_ref[k] for k in g_ref])
    moved = [k for k in g_ref if g_ref[k] >= TINY_GRADIENT * med]
    skipped = sorted(set(g_ref) - set(moved))
    moved += sorted(set(g_prog) - set(g_ref))         # the program moves what the reference does not
    start = program["start"]
    d_prog = _norms({k: program["params"][k].to(start[k].device) - start[k] for k in moved})
    d_ref = _norms({k: reference["params"][k].to(start[k].device) - start[k] for k in moved})
    update_gap, update_leaf = _worst(d_prog, d_ref, moved)
    ae_loss_gap = _relative(program["loss_ae"][:steps], reference["loss_ae"])
    sup_loss_gap = _relative(program["loss_sup"][:steps], reference["loss_sup"])
    return {"loss_gap": loss_gap, "ae_loss_gap": ae_loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap, "sup_loss_gap": sup_loss_gap,
            "worst_grad_leaf": grad_leaf, "worst_update_leaf": update_leaf,
            "left_out_leaves": skipped, "steps_followed": steps}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)
