#!/usr/bin/env python3
"""Same-call A/B of the wide pair of coupling-chain kernels of two trees of
the port on one GPU.

    git archive <commit> nfdpf_torch | tar -x -C _archive/parent
    python3 tools/wide_pair_ab.py --other _archive/parent [--rounds 1] [--out ab.json]

Times each tree's wide forward and backward launchers
(``coupling_cuda._launch_forward_wide``, ``_launch_backward_wide``: the
backward's time includes the sum of its partials and their unpacking) in
the inverse direction at the cases of ``PERF.md`` §6's wide-pair table:
``chip_smoke.WIDE_CHAINS`` and ``WIDE_LARGE`` at (B=32, N=100) with a
36-wide context broadcast over the particles, ``WIDE_DENSE`` at (B=4,
N=4097) with a dense 36-wide one.  Inputs come from this tree's
``chip_smoke.wide_chain`` (seeded), times from its ``device_ms`` (CUDA-graph
replays, ms a call); each result is first held to the tree's plain version
at the smoke's tolerances, and a hash of its bits is kept.  Each turn is a
fresh process from that tree's root, in the order other, this, this, other
(``--rounds`` times); a turn builds its tree's wide library first.  Prints
the card's name and power limit, then one JSON line: per kernel and case
each tree's median ms over its turns, whether each tree's turns gave the
same bits, and every turn's times.
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
from nfdpf_torch.ops.cuda import coupling_cuda as cc
torch.backends.cuda.matmul.allow_tf32 = False
lib = cc._library(cc.WIDE_BUILD)
dev = torch.device("cuda")
cases = [(h, k, 32, 100, True) for h, k in s.WIDE_CHAINS + s.WIDE_LARGE]
cases += [(h, k, 4, 4097, False) for h, k in s.WIDE_DENSE]
out, bits = {}, {}
for hidden, n_blocks, b, n, broadcast in cases:
    case = f"H{hidden}_K{n_blocks}_B{b}_N{n}_C36{'' if broadcast else '_dense'}_inverse"
    gen = torch.Generator().manual_seed(7 * hidden + n_blocks + 36 + n)
    chain = s.wide_chain(n_blocks, hidden, 36, gen)
    x = torch.randn(b, n, 2, generator=gen).to(dev)
    ctx = torch.randn(b, 1 if broadcast else n, 36, generator=gen).to(dev).expand(b, n, 36)
    gy = torch.randn(b, n, 2, generator=gen).to(dev)
    gld = torch.randn(b, n, generator=gen).to(dev)
    with torch.no_grad():
        w, bias = (t.contiguous() for t in cc.pack_chain_params(chain))
        p, mode = cc._launch_ctx_share(lib, ctx, w, bias)
        fwd = lambda: cc._launch_forward_wide(x, p, mode, w, bias, True)
        bwd = lambda: cc._launch_backward_wide(x, p, mode, w, bias, gy, gld, True, True)
        y, ld = fwd()
        y_ref, ld_ref = cc.chain_apply_packed_plain(x, ctx, w, bias, True)
        s.check(f"fwd@{case}", y, y_ref, ("apply", s.CHAIN_TOL))
        s.check(f"fwd@{case}", ld, ld_ref, ("apply", s.CHAIN_TOL))
        grads = bwd()
        bits.setdefault("coupling_chain_wide", {})[case] = hashlib.sha256(
            b"".join(t.cpu().numpy().tobytes() for t in (y, ld))).hexdigest()
        bits.setdefault("coupling_chain_bwd_wide", {})[case] = hashlib.sha256(
            b"".join(t.cpu().numpy().tobytes() for t in grads)).hexdigest()
        iters = 20 if hidden <= 256 else 5
        out.setdefault("coupling_chain_wide", {})[case] = s.device_ms(fwd, iters)
        out.setdefault("coupling_chain_bwd_wide", {})[case] = s.device_ms(bwd, iters)
    del chain, x, ctx, gy, gld, w, bias, p, y, ld, grads
    torch.cuda.empty_cache()
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
                             **{f"bits_equal_{tree}": len({t["bits"][name][case] for t in turns
                                                           if t["tree"] == tree}) == 1
                                for tree in ("other", "this")}}
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
