#!/usr/bin/env python3
"""K6 of this checkout against K6 of another, in turns, on one GPU.

    python3 tools/k6_ab.py [--other DIR] [--rounds 2] [--calls 5] [--out ab.json]

K6 (``ot_resample_streaming_sharded``) runs on 2 ranks that share the card
over gloo, at ``chip_smoke.py``'s ``k6`` inputs: (B, N) = (4, 10,240), seed
11, ε = 0.1, scaling 0.75, threshold 1e-3, cold.  Each turn is a process of
its own that imports one checkout's ``nfdpf_torch`` (this one, or ``--other``,
e.g. a parent unpacked with ``git archive <commit> nfdpf_torch | tar -x -C
_archive/parent``) and spawns the 2 ranks; turns go this, other, other,
this, ``--rounds`` times (this checkout alone without ``--other``).  A turn
takes one warm-up call, ``--calls`` calls back to back (one synchronise at
the end), ``--calls`` calls each synchronised, then one call with every
collective counted and timed on the host clock between two synchronises
(torch.distributed's functions wrapped in the ranks, so any checkout is
counted alike), then the loop's all-gather alone ((B, 2, N/2) floats) as
``all_gather_into_tensor`` and as ``all_gather`` into views of one buffer,
in turns, 40 of each.  The card is shared by 2 processes and gloo stages every
collective through the host: these are times of that setting, not of NCCL.
Prints the card's name and power limit, then one JSON line: each turn's
rank-0 numbers, each checkout's medians, and the largest difference between
the checkouts' particles.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SHAPE, SEED = (4, 10240), 11
KW = dict(eps=0.1, scaling=0.75, threshold=1e-3, max_iter=100)
GATHERS = 20         # timed gathers of each way, in turns (twice that in all)
OPS = ("all_gather", "all_gather_into_tensor", "all_gather_single", "all_reduce", "broadcast")


def _sync():
    torch.cuda.synchronize()


def _counted(dist, stats):
    """Wrap torch.distributed's collectives: calls and synchronised host ms."""
    saved = {}
    for op in OPS:
        fn = getattr(dist, op, None)
        if fn is None:
            continue
        saved[op] = fn

        def wrapped(*a, _fn=fn, _op=op, **k):
            _sync()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            _sync()
            stats[_op] = stats.get(_op, 0) + 1
            stats["ms"] = stats.get("ms", 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        setattr(dist, op, wrapped)
    return saved


def rank_job(raw, probs, calls):
    import torch.distributed as dist

    from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc
    from nfdpf_torch.parallel.mesh import PARTICLE_AXIS, all_gather, local_slice, make_mesh

    mesh = make_mesh(1, 2)
    x = local_slice(torch.as_tensor(raw).cuda(), mesh, PARTICLE_AXIS, 1)
    w = local_slice(torch.as_tensor(probs).cuda(), mesh, PARTICLE_AXIS, 1)
    fn = sc.ot_resample_streaming_sharded
    with torch.no_grad():
        out, _, _, iters = fn(x, w, mesh=mesh, **KW)
        _sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(x, w, mesh=mesh, **KW)
        _sync()
        b2b = (time.perf_counter() - t0) / calls * 1e3
        each = []
        for _ in range(calls):
            _sync()
            t0 = time.perf_counter()
            fn(x, w, mesh=mesh, **KW)
            _sync()
            each.append((time.perf_counter() - t0) * 1e3)
        stats = {}
        saved = _counted(dist, stats)
        _sync()
        t0 = time.perf_counter()
        fn(x, w, mesh=mesh, **KW)
        _sync()
        counted_ms = (time.perf_counter() - t0) * 1e3
        for op, f in saved.items():
            setattr(dist, op, f)
        whole = all_gather(out, mesh, PARTICLE_AXIS, 1).cpu().numpy()
        # the loop's gather alone, (B, 2, N/P) floats, two ways, in turns
        block = torch.randn(SHAPE[0], 2, SHAPE[1] // 2, device="cuda")
        parts = torch.empty(2, *block.shape, device="cuda")
        ways = {"all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                    parts.flatten(0, 1), block, group=mesh.particle_group),
                "all_gather_list": lambda: dist.all_gather(
                    list(parts.unbind(0)), block, group=mesh.particle_group)}
        gather_ms = {k: [] for k in ways}
        for i in range(2 * GATHERS):
            for k in (list(ways) if i % 2 == 0 else list(ways)[::-1]):
                _sync()
                t0 = time.perf_counter()
                ways[k]()
                _sync()
                gather_ms[k].append((time.perf_counter() - t0) * 1e3)
    return {"iters": iters, "ms_back_to_back": b2b, "ms_each": each,
            "counted_call_ms": counted_ms, "collective_ms": stats.pop("ms", 0.0),
            "collectives": stats, "particles": whole,
            "gather_ms": {k: statistics.median(v) for k, v in gather_ms.items()}}


def turn(tree: str, calls: int, dump: str) -> None:
    """One turn in this process: ``tree``'s package on 2 ranks."""
    from nfdpf_torch.parallel import ranks as R

    gen = torch.Generator().manual_seed(SEED)
    raw = torch.rand(*SHAPE, 2, generator=gen) * 128 - 64
    probs = torch.softmax(torch.randn(*SHAPE, generator=gen), -1)
    res = R.spawn(2, [(rank_job, dict(raw=raw.numpy(), probs=probs.numpy(), calls=calls))],
                  backend="gloo", threads=2, timeout=600)[0][0]
    np.save(dump, res.pop("particles"))
    print(json.dumps(dict(res, tree=tree)), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", help="a checkout (holding nfdpf_torch/) to time against")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--calls", type=int, default=5)
    parser.add_argument("--out", help="also write the JSON line to this file")
    parser.add_argument("--turn", help=argparse.SUPPRESS)
    parser.add_argument("--dump", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k6_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.turn:
        turn(args.turn, args.calls, args.dump)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"this": here}
    if args.other:
        trees["other"] = os.path.abspath(args.other)
    order = (["this", "other", "other", "this"] if args.other else ["this"]) * args.rounds
    turns, particles = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(order):
            dump = os.path.join(tmp, f"{i}.npy")
            env = dict(os.environ, PYTHONPATH=trees[name])
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", name,
                                   "--calls", str(args.calls), "--dump", dump],
                                  cwd=trees[name], env=env, capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                return 1
            turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            particles.setdefault(name, np.load(dump))
    medians = {}
    for name in trees:
        mine = [t for t in turns if t["tree"] == name]
        medians[name] = {
            "ms_back_to_back": statistics.median(t["ms_back_to_back"] for t in mine),
            "ms_each": statistics.median(v for t in mine for v in t["ms_each"]),
            "collective_ms_of_counted_call": statistics.median(t["collective_ms"] for t in mine),
            "counted_call_ms": statistics.median(t["counted_call_ms"] for t in mine),
            "iters": sorted({t["iters"] for t in mine}), "collectives": mine[0]["collectives"],
            "gather_ms": {k: statistics.median(t["gather_ms"][k] for t in mine)
                          for k in mine[0]["gather_ms"]}}
    line = {"card": card.strip().splitlines()[0], "shape": SHAPE, "ranks": 2,
            "transport": "gloo-on-one-card", "order": order, "turns": turns,
            "medians": medians}
    if args.other:
        line["max_abs_diff_particles"] = float(np.abs(particles["this"]
                                                      - particles["other"]).max())
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(line, fh, indent=1)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
