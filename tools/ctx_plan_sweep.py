#!/usr/bin/env python3
"""Launch-plan sweep of the context kernels on one GPU.

    python3 tools/ctx_plan_sweep.py [--out sweep.json]

Times the context share (``coupling_cuda.ctx_share``) and the
context-weight gradient (``ctx_weight_grad``, both its kernels) under every
launch plan of a small grid, at the filter's shapes (B=32 and 10, N=100, a
context of 4, 36 or 196 broadcast over the particles) and dense ones ((4,
4097, 36) at hidden 8 and 16, (3, 1037, 197)), K=2 blocks: the weight
gradient's first kernel's chunks (segments: the pieces a context row is
summed in; rows: the shared memory a block stages), the share's tiles of
context rows (narrow: a block per net, a thread a row; wide: every net, 16
rows a thread) with its context staged in shared memory or read from global
memory.  Each plan's result is first held to the plain version at
``chip_smoke.py``'s tolerances; times are ``chip_smoke.device_ms``
(CUDA-graph replay, ms a call).  Prints the card's name and power limit,
then one JSON line: per kernel and shape the wrapper's own plan with its
time, and every plan tried with its time, fastest first.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as s  # noqa: E402
from nfdpf_torch.ops.cuda import coupling_cuda as cc  # noqa: E402

SHAPES = ((32, 100, 196, True, 8), (32, 100, 36, True, 8), (32, 100, 4, True, 8),
          (10, 100, 196, True, 8), (10, 100, 4, True, 8), (4, 4097, 36, False, 8),
          (4, 4097, 36, False, 16), (3, 1037, 197, False, 8))
ROW_BUDGETS = (16, 32, 64, 100, 200)   # KB a first-kernel block stages (rows mode)
PIECES = (1, 2, 4)                      # pieces a context row is summed in (segments)


def grad_plans(rows, n, mode, c, ps):
    """The wrapper's plan, then variants of the first kernel's chunk (rows
    mode: the shared-memory budget; segments: pieces of each context row)."""
    own = cc.ctx_weight_grad_plan(rows, n, mode, c, ps)
    plans, seen = [own], set()
    original = cc.CTX_GRAD_SMEM_BYTES
    try:
        for budget in ROW_BUDGETS if not own["segments"] else (None,):
            if budget is not None:
                cc.CTX_GRAD_SMEM_BYTES = budget * 1024
            for pieces in PIECES if own["segments"] else (1,):
                plan = cc.ctx_weight_grad_plan(rows, n, mode, c, ps)
                if own["segments"]:
                    rpb = -(-n // pieces)
                    plan.update(rows_per_block=rpb, pieces=pieces, parts=rows // n * pieces,
                                grid1=(rows // n * pieces, plan["grid1"][1]),
                                part_floats=rows // n * pieces * ps)
                key = (plan["rows_per_block"], plan["c_tile1"])
                if key not in seen and plan["smem_bytes1"] <= cc.MAX_SMEM_BYTES:
                    seen.add(key)
                    plans.append(plan)
    finally:
        cc.CTX_GRAD_SMEM_BYTES = original
    return plans


def share_plans(r, n_blocks, hidden, c):
    nets = 4 * n_blocks
    plans = [cc.ctx_share_plan(r, n_blocks, hidden, c)]
    shapes = [(rows, 1, 1) for rows in (1, 2, 4, 8, 16, 32)]
    shapes += [(lanes * 16, nets, 16) for lanes in (1, 2, 4) if lanes * nets * hidden <= 512]
    for rows, nets_a, rpt in shapes:
        for chunk in (0, c):
            if c and chunk and cc.ctx_share_smem_bytes(rows, nets_a, hidden, chunk) > 48 * 1024:
                continue
            plans.append({"rows_a_block": rows, "nets_a_block": nets_a, "rows_a_thread": rpt,
                          "c_chunk": chunk, "grid": (cc._cdiv(r, rows), nets // nets_a),
                          "threads": rows // rpt * nets_a * hidden,
                          "smem_bytes": cc.ctx_share_smem_bytes(rows, nets_a, hidden, chunk)})
    return plans


def sweep(kernel, plain, tol, plans, attr, iters):
    """Time ``kernel`` under each plan (the wrapper's plan function patched)."""
    original = getattr(cc, attr)
    rows = []
    try:
        for plan in plans:
            setattr(cc, attr, lambda *a, plan=plan: dict(plan))
            s.check(f"{attr}{plan}", kernel(), plain(), tol)
            rows.append({**{k: v for k, v in plan.items() if k != "part_floats"},
                         "ms": s.device_ms(kernel, iters)})
    finally:
        setattr(cc, attr, original)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON line to this file")
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": card, "coupling_ctx_weight_grad": {}, "coupling_ctx_share": {}}
    for k, (b, n, c, broadcast, hidden) in enumerate(SHAPES):
        ctx, w, bias, g1 = s.context_case(b, n, c, broadcast, 2, hidden, False, 500 + k)
        mode, r = cc.context_layout(ctx)
        case = f"B{b}_N{n}_C{c}" + ("" if broadcast else "_dense") + (
            "" if hidden == 8 else f"_h{hidden}")
        iters = 100
        with torch.no_grad():
            grad = sweep(lambda: cc.ctx_weight_grad(g1, ctx, w),
                         lambda: cc.ctx_weight_grad_plain(g1, ctx, w), ("apply", s.CHAIN_GRAD_TOL),
                         grad_plans(b * n, n, mode, c, g1.shape[1]), "ctx_weight_grad_plan", iters)
            share = sweep(lambda: cc.ctx_share(ctx, w, bias),
                          lambda: cc.ctx_share_plain(ctx, w, bias), ("lse", s.CHAIN_TOL),
                          share_plans(r, 2, hidden, c), "ctx_share_plan", iters)
        for name, rows in (("coupling_ctx_weight_grad", grad), ("coupling_ctx_share", share)):
            out[name][case] = {"own": rows[0], "tried": sorted(rows[1:], key=lambda x: x["ms"])}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
