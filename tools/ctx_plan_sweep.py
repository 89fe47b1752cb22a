#!/usr/bin/env python3
"""Launch-plan sweep of the context kernels and K3's update kernel on one GPU.

    python3 tools/ctx_plan_sweep.py [--only input_grad|update] [--out sweep.json]

Times the context share (``coupling_cuda.ctx_share``) and the
context-weight gradient (``ctx_weight_grad``, both its kernels) under every
launch plan of a small grid, at the filter's shapes (B=32 and 10, N=100, a
context of 4, 36 or 196 broadcast over the particles) and dense ones ((4,
4097, 36) at hidden 8 and 16, (3, 1037, 197)), K=2 blocks: the weight
gradient's first kernel's chunks (segments: the pieces a context row is
summed in; rows: the shared memory a block stages), the share's tiles of
context rows (narrow: a block per net, a thread a row; wide: every net, 16
rows a thread) with its context staged in shared memory or read from global
memory; and the context-input gradient (``ctx_input_grad``) at
``IN_SHAPES`` (the shapes above and C = 1, 4, 65; K=3 blocks at hidden 16,
K=8 at hidden 8) under each tile shape of ``coupling_cuda.CTX_IN_TILES``,
in the wrapper's library and in each build of ``IN_BUILDS`` (the library
built with other lanes or ring budget, or summing nothing: what staging
alone takes), launched through the C entry point; and K3's update kernel
(``sinkhorn_cuda._Loop.update``, every row running) at ``UPDATE_SHAPES``
with the batch in one cluster of 1, 2, 4 or 8 blocks.  ``--only`` sweeps
one of the last two alone.  Each plan's result is first held to the plain
version at ``chip_smoke.py``'s tolerances; times are
``chip_smoke.device_ms`` (CUDA-graph replay, ms a call).  Prints the
card's name and power limit, then one JSON line: per kernel and shape the
wrapper's own plan with its time, and every plan tried with its time,
fastest first.
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
from nfdpf_torch.ops.cuda import build  # noqa: E402
from nfdpf_torch.ops.cuda import coupling_cuda as cc  # noqa: E402
from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc  # noqa: E402

SHAPES = ((32, 100, 196, True, 8), (32, 100, 36, True, 8), (32, 100, 4, True, 8),
          (10, 100, 196, True, 8), (10, 100, 4, True, 8), (4, 4097, 36, False, 8),
          (4, 4097, 36, False, 16), (3, 1037, 197, False, 8))
# (B, N, C, broadcast, blocks, hidden) of the input gradient's sweep
IN_SHAPES = ((32, 100, 196, True, 2, 8), (32, 100, 36, True, 2, 8), (32, 100, 4, True, 2, 8),
             (32, 100, 1, True, 2, 8), (10, 100, 196, True, 2, 8), (4, 4097, 36, False, 2, 8),
             (32, 100, 196, True, 3, 16), (4, 4097, 36, False, 2, 16),
             (3, 1037, 197, False, 2, 8), (32, 100, 36, True, 8, 8), (3, 1037, 36, False, 8, 8),
             (3, 33, 65, True, 8, 8), (3, 1037, 36, False, 3, 16))
# the input gradient's variant builds: (lanes, -D defines); SUMS=0 stages
# every chunk and sums none
IN_BUILDS = ((4, ("NFDPF_IN_LANES=4",)), (16, ("NFDPF_IN_LANES=16",)),
             (cc.CTX_IN_LANES, ("NFDPF_IN_RING=49152",)), (cc.CTX_IN_LANES, ("NFDPF_IN_SUMS=0",)))
UPDATE_SHAPES = ((32, 100), (10, 100), (64, 5))
UPDATE_BATCH_ROWS = 16                  # most rows of a batch update block (kBatchRows)
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


def tile_plan(rows, c, ps, tile, lanes):
    """The input gradient's launch on ``tile`` in a library of ``lanes``
    lanes (``in_tile_plan``'s, its shared memory left out: a variant
    build's ring differs)."""
    plan = cc.in_tile_plan(rows, c, ps, tile)
    del plan["smem_bytes"]
    cols = lanes * tile[2]
    return {**plan, "tile_cols": cols, "threads": tile[0] * lanes,
            "grid": (plan["grid"][0], cc._cdiv(c, cols))}


def launch_input_grad(lib, g1, w, c, plan):
    """The input gradient through ``lib``'s C entry point on ``plan``."""
    g1, w = cc.kernel_args(g1, w)
    gctx = torch.empty((g1.shape[0], c), device=g1.device, dtype=torch.float32)
    rc = lib.nfdpf_coupling_ctx_input_grad(
        g1.data_ptr(), g1.shape[0], c, w.shape[0], w.shape[-2], w.shape[-1], w.data_ptr(),
        plan["tile_rows"], plan["tile_cols"], plan["rows_a_thread"], gctx.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    cc.check_launch(rc, "coupling_ctx_input_grad")
    return gctx


def input_grad_sweep(g1, w, c, hidden):
    """Every tile of ``CTX_IN_TILES`` in the wrapper's library and in each of
    ``IN_BUILDS``, each result held to the plain version (but SUMS=0's)."""
    rows, ps = g1.shape
    plain = cc.ctx_input_grad_plain(g1, w, c)
    out = []
    for lanes, defines in ((cc.CTX_IN_LANES, ()),) + IN_BUILDS:
        lib = build.load("coupling", cc._SIGNATURES, cc.build_defines(hidden) + defines)
        for tile in cc.CTX_IN_TILES:
            plan = tile_plan(rows, c, ps, tile, lanes)
            fn = lambda plan=plan: launch_input_grad(lib, g1, w, c, plan)  # noqa: E731
            if "NFDPF_IN_SUMS=0" not in defines:
                s.check(f"ctx_input_grad{defines}{plan}", fn(), plain,
                        ("apply", s.CHAIN_GRAD_TOL))
            out.append({**plan, "lanes": lanes, "defines": list(defines),
                        "ms": s.device_ms(fn, 100)})
    return out


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
    parser.add_argument("--only", choices=["input_grad", "update"],
                        help="sweep this kernel alone")
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": card, "coupling_ctx_weight_grad": {}, "coupling_ctx_share": {},
           "coupling_ctx_input_grad": {}, "sinkhorn_update": {}}
    for b, n in UPDATE_SHAPES if args.only in (None, "update") else ():
        rows = []
        for blocks in (None, 1, 2, 4, 8):    # None: the wrapper's plan
            loop, inputs = s.update_case(sc, b, n, "all", "running",
                                         torch.Generator().manual_seed(b + n), threshold=-1.0)
            per_block = -(-b // (blocks or 1))
            if blocks is not None:
                if per_block > UPDATE_BATCH_ROWS or not loop.plan["batch"]:
                    continue
                loop.plan = {**loop.plan, "blocks": blocks, "rows_a_block": per_block,
                             "threads": 32 * per_block, "grid": blocks}
            s.check_update(sc, loop, inputs, f"B{b}_N{n}")
            rows.append({**loop.plan, "own": blocks is None,
                         "ms": s.device_ms(lambda: loop.update(freeze=False), 200)})
        out["sinkhorn_update"][f"B{b}_N{n}"] = sorted(rows, key=lambda x: x["ms"])
    if args.only in (None, "input_grad"):
        build.build_all([("coupling", cc.build_defines(h) + d)
                         for h in (8, 16) for d in ((),) + tuple(d for _, d in IN_BUILDS)])
    for k, (b, n, c, broadcast, n_blocks, hidden) in enumerate(
            IN_SHAPES if args.only in (None, "input_grad") else ()):
        ctx, w, _, g1 = s.context_case(b, n, c, broadcast, n_blocks, hidden, False, 700 + k)
        case = f"B{b}_N{n}_C{c}" + ("" if broadcast else "_dense") + (
            "" if n_blocks == 2 else f"_K{n_blocks}") + ("" if hidden == 8 else f"_h{hidden}")
        with torch.no_grad():
            own = {**cc.ctx_input_grad_plan(b * n, c, g1.shape[1]),
                   "ms": s.device_ms(lambda: cc.ctx_input_grad(g1, w, c), 100)}
            rows = input_grad_sweep(g1, w, c, hidden)
            w0 = w[:, :, 0, 1:1 + c].permute(0, 1, 3, 2).reshape(-1, c).contiguous()
            mm = s.device_ms(lambda: torch.mm(g1, w0), 100)
        out["coupling_ctx_input_grad"][case] = {"own": own, "library_ms": mm,
                                                "tried": sorted(rows, key=lambda x: x["ms"])}
    for k, (b, n, c, broadcast, hidden) in enumerate(() if args.only else SHAPES):
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
