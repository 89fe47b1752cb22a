#!/usr/bin/env python3
"""Same-call A/B of the context kernels and K3's update kernel of two trees
of the port on one GPU.

    git archive <commit> nfdpf_torch | tar -x -C _archive/parent
    python3 tools/ctx_kernels_ab.py --other _archive/parent [--rounds 1] [--out ab.json]

Times each tree's context kernels (``coupling_cuda.ctx_share``,
``ctx_weight_grad``, ``ctx_input_grad``, through the wrappers the chain
calls) at every case where ``chip_smoke.py`` runs them: the main cases of its
``chain_kernels`` phase (B=32 and 10 with N=100 and a context of 4, 36 or
196 broadcast over the particles, B=4, N=4097 with a dense 36-wide one; K=2
blocks at hidden 8 and 16) and its edge cases (``CTX_EDGES``).  Inputs come
from this tree's ``chip_smoke.context_case`` (random g1, seeded), times from
its ``device_ms`` (CUDA-graph replay, ms a call); each result is first held
to the tree's own plain version at the smoke's tolerances, and a hash of its
bits is kept.  Then each tree's update kernel (``sinkhorn_cuda._Loop.update``)
at (B, N) = (32, 100), (10, 100), (4, 4097) and (4, 10240) on one K1 output
(``chip_smoke.update_case``), first held to its plain version bit for bit,
timed on repeated launches in two states: "stopped" (every third row's flag
down, the rows stopping as the potentials settle: the smoke's ``ms``) and
"running" (a negative threshold keeps every row's flag up at every launch,
the filter's usual state).  Each turn is a fresh process from that tree's
root, in the order other, this, this, other (``--rounds`` times); a turn
builds its tree's libraries first.  Prints the card's name and power limit,
then one JSON line: per kernel and case each tree's median ms over its
turns, whether every turn of both trees gave the same bits, and every
turn's times.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURN = r"""
import hashlib, importlib.util, json, sys, torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("ab_smoke", sys.argv[1])
s = importlib.util.module_from_spec(spec)
spec.loader.exec_module(s)
from nfdpf_torch.ops.cuda import build
from nfdpf_torch.ops.cuda import coupling_cuda as cc
torch.backends.cuda.matmul.allow_tf32 = False
from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc
build.build_all([("coupling", cc.build_defines(8)), ("coupling", cc.build_defines(16)),
                 ("sinkhorn", ())])
cases = []
for h in (8, 16):
    for b, n, c, broadcast in ((32, 100, 4, True), (32, 100, 36, True), (32, 100, 196, True),
                               (10, 100, 4, True), (10, 100, 36, True), (10, 100, 196, True),
                               (4, 4097, 36, False)):
        name = f"B{b}_N{n}_C{c}" + ("" if h == 8 else f"_h{h}")
        cases.append((name, b, n, c, broadcast, 2, h, False, 200 if broadcast else 20))
cases += [case + (s.CTX_EDGE_ITERS,) for case in s.CTX_EDGES]
out, bits = {}, {}
for k, (case, b, n, c, broadcast, n_blocks, hidden, view, iters) in enumerate(cases):
    ctx, w, bias, g1 = s.context_case(b, n, c, broadcast, n_blocks, hidden, view, 9000 + k)
    with torch.no_grad():
        kernels = {
            "coupling_ctx_share": (lambda: cc.ctx_share(ctx, w, bias),
                                   lambda: cc.ctx_share_plain(ctx, w, bias), ("lse", s.CHAIN_TOL)),
            "coupling_ctx_weight_grad": (lambda: cc.ctx_weight_grad(g1, ctx, w),
                                         lambda: cc.ctx_weight_grad_plain(g1, ctx, w),
                                         ("apply", s.CHAIN_GRAD_TOL)),
            "coupling_ctx_input_grad": (lambda: cc.ctx_input_grad(g1, w, c),
                                        lambda: cc.ctx_input_grad_plain(g1, w, c),
                                        ("apply", s.CHAIN_GRAD_TOL))}
        for name, (kernel, plain, tol) in kernels.items():
            got = kernel()
            s.check(f"{name}@{case}", got, plain(), tol)
            digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
            bits.setdefault(name, {})[case] = digest
            out.setdefault(name, {})[case] = s.device_ms(kernel, iters)
for b, n in ((32, 100), (10, 100), (4, 4097), (4, 10240)):
    gen = torch.Generator().manual_seed(b + n)
    for state, threshold in (("stopped", 1e-3), ("running", -1.0)):
        loop, (lse, a_y, b_x, running, eps_run, eps_b, logw) = s.update_case(
            sc, b, n, "all", state, gen, threshold=threshold)
        loop.update(freeze=True)
        ref = sc.sinkhorn_update_plain(lse, a_y, b_x, running, eps_run, eps_b, logw,
                                       loop.uniform, threshold, 0.75**2)
        got = (loop.a_y, loop.b_x, loop.running, loop.eps_run, loop.fs)
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"sinkhorn_update@B{b}_N{n}_{state}: other bits than the "
                                 "plain version's")
        case = f"B{b}_N{n}_{state}"
        bits.setdefault("sinkhorn_update", {})[case] = hashlib.sha256(
            b"".join(t.cpu().numpy().tobytes() for t in got)).hexdigest()
        out.setdefault("sinkhorn_update", {})[case] = s.device_ms(
            lambda: loop.update(freeze=False), 200 if n <= 4097 else 50)
        del loop
print("TURN " + json.dumps({"ms": out, "bits": bits}))
"""


def turn(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN, os.path.join(HERE, "chip_smoke.py")],
                          cwd=root, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=root))
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")), None)
    if proc.returncode or line is None:
        raise RuntimeError(f"the turn in {root} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(line[len("TURN "):])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="root of the other tree")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--out", help="also write the JSON line to this file")
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    other = os.path.abspath(args.other)
    order = ["other", "this", "this", "other"] * args.rounds
    turns = [{"tree": tree, **turn(other if tree == "other" else HERE)} for tree in order]
    summary = {name: {case: {**{tree: statistics.median(t["ms"][name][case] for t in turns
                                                        if t["tree"] == tree)
                                for tree in ("other", "this")},
                             "bits_equal": len({t["bits"][name][case] for t in turns}) == 1}
                      for case in turns[0]["ms"][name]}
               for name in turns[0]["ms"]}
    row = {"card": card, "other": other, "order": order, "summary": summary, "turns": turns}
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(row, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
