#!/usr/bin/env python3
"""Same-call A/B of two trees of the port on one GPU: this one and another.

    git archive <commit> nfdpf_torch chip_smoke.py | tar -x -C _archive/parent
    python3 tools/commit_ab.py --other _archive/parent [--rounds 1] [--out ab.json]
        [--slices slice,slice_cnf] [--no-profile]

Runs slices of each tree's own ``chip_smoke.py`` (``phase_slice``, the
settings of its ``SLICES``: 3 train steps and an eval step at full width,
B=32, N=100, T=50, every step resampled, then, unless ``--no-profile``, one
profiled train step), by default the bootstrap DPF (``slice``) and the
CNF-DPF (``slice_cnf``), each turn in a fresh process from that tree's
root, in the order other, this, this, other (``--rounds`` times).  A turn
builds its tree's kernels first.  Prints the card's name and power limit,
then one JSON line: per slice and tree the step medians, host syncs at step
0, first-step loss, Sinkhorn iterations and, with the profile, device busy
ms, idle share and launches of the profiled step.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURN = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as s
from nfdpf_torch.ops.cuda import build
from nfdpf_torch.ops.cuda.coupling_cuda import build_defines
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_all([("sinkhorn", ())] + [("coupling", build_defines(h)) for h in (8, 16)])
profile = sys.argv[2] == "1"
rows = [s.phase_slice(name, *s.SLICES[name], profile) for name in sys.argv[1].split(",")]
print("TURN " + json.dumps(rows))
"""
KEYS = ("median_step_ms", "step_s", "device_syncs_step0", "losses", "sinkhorn_iters")
PROFILE_KEYS = ("wall_ms", "device_busy_ms", "device_idle_share", "launches")


def turn(root: str, slices: str, profile: bool) -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN, slices, str(int(profile))], cwd=root,
                          capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=root))
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")), None)
    if proc.returncode or line is None:
        raise RuntimeError(f"the turn in {root} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return {row["phase"]: {**{k: row[k] for k in KEYS},
                           **{k: row["profile"][k] for k in PROFILE_KEYS if "profile" in row}}
            for row in json.loads(line[len("TURN "):])}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="root of the other tree")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--out", help="also write the JSON line to this file")
    parser.add_argument("--slices", default="slice,slice_cnf",
                        help="comma-separated names of chip_smoke.SLICES")
    parser.add_argument("--no-profile", action="store_true",
                        help="skip the profiled train step")
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    other = os.path.abspath(args.other)
    order = ["other", "this", "this", "other"] * args.rounds
    turns = [{"tree": tree, **turn(other if tree == "other" else HERE, args.slices,
                                   not args.no_profile)} for tree in order]
    summary = {name: {tree: {"median_step_ms": statistics.median(
                          t[name]["median_step_ms"] for t in turns if t["tree"] == tree),
                      "device_syncs_step0": [t[name]["device_syncs_step0"]
                                             for t in turns if t["tree"] == tree]}
                      for tree in ("other", "this")}
               for name in args.slices.split(",")}
    row = {"card": card, "other": other, "order": order, "summary": summary, "turns": turns}
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(row, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
