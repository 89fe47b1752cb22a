#!/usr/bin/env python3
"""Same-call A/B of K1, the streaming logsumexp, of two trees of the port
on one GPU, with its accuracy, its registers and its instructions per pair.

    git archive <commit> nfdpf_torch | tar -x -C _archive/parent
    python3 tools/k1_ab.py --other _archive/parent [--rounds 1] [--sweep] \\
        [--sass k1_sass] [--out ab.json]

Each turn is a fresh process from a tree's root, in the order other, this,
this, other (``--rounds`` times); a turn builds its tree's sinkhorn library
and then, for every case of ``CASES`` (B, N rows, M columns, G groups: the
benchmark cell's (8, 10240), the kernel table's (32, 100), (4, 4097) and
(4, 10240), K6's rank rows (4, 5120) against 10240 columns), times K1
(``sinkhorn_cuda._launch_lse`` into a fixed output, ``ITERS`` launches a
CUDA-graph replay, the median over ``REPLAYS`` replays, ms a launch) on the
kernel table's inputs (``table_inputs``), and keeps a hash of its bits.

Accuracy (``ACCURACY``): on inputs written once by this tree before the
first turn, K1's largest absolute and relative error against a float64
logsumexp of the same float32 inputs, computed on the card in row chunks;
the float32 plain version (``lse_multi_plain``) is held to the same
reference.  Two input sets: the kernel table's, and a firing's (the cell's
particles, ε = 0.1, the potentials of a converged loop: K1's input at the
loop's last iteration, as the resampler hands it over).

Each tree's ptxas report gives every K1 instantiation's registers and
spills; with ``--sass DIR`` each tree's library is disassembled with
``cuobjdump -sass`` into ``DIR/<tree>.sass`` and each K1 instantiation's
instructions are counted by kind in its tile loop (the many-tile path: the
loop's body over the R·C pairs a lane takes in a tile) or its whole body
(the one-tile path).

``--sweep`` then times this tree's K1 at other tile constants (``SWEEP``:
rows per warp, columns per lane and warps per block of the many-tile path,
``kLseR``, ``kLseC``, ``kLseWarps``), each a copy of ``sinkhorn.cu`` with
those lines rewritten, built with the same flags, checked against this
tree's library at rtol/atol 1e-5.

Prints the card's name and power limit, then one JSON line: per case each
tree's median ms over its turns, whether the turns of each tree gave equal
bits, the errors, the ptxas and SASS counts, and the sweep.
"""

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = ((8, 10240, 10240, 2), (8, 10240, 10240, 1), (32, 100, 100, 2), (32, 100, 100, 1),
         (4, 4097, 4097, 2), (4, 4097, 4097, 1), (4, 10240, 10240, 2), (4, 10240, 10240, 1),
         (4, 5120, 10240, 2), (4, 5120, 10240, 1))
ACCURACY = (8, 10240, 2)
ITERS = {100: 200, 4097: 20, 5120: 10, 10240: 5}
REPLAYS = 5
# (R, C, warps) of K1's many-tile path (kLseR, kLseC, kLseWarps) tried by
# --sweep, each at G = 1 and 2
SWEEP = ((8, 8, 4), (4, 8, 8), (4, 8, 4), (8, 8, 8), (16, 8, 4), (8, 4, 4), (16, 4, 4),
         (4, 4, 4))
SWEEP_SHAPES = ((8, 10240, 10240), (4, 4097, 4097), (4, 10240, 10240), (4, 5120, 10240),
                (1, 700, 700))

COMMON = r"""
import hashlib, json, math, statistics, sys, torch
sys.path.insert(0, ".")
from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc


def table_inputs(b, n, m, g, seed):
    # the kernel table's inputs: scaled coordinates, eps from the target 0.1
    # to an annealing start, log-weights as potentials
    gen = torch.Generator().manual_seed(seed)
    def coords(k):
        raw = torch.rand(b, k, 2, generator=gen) * 128 - 64
        c = raw - raw.mean(1, keepdim=True)
        return c / (c.std(1, correction=0).amax(-1)[:, None, None] * math.sqrt(2))
    x, y = coords(n), coords(m) if m != n else None
    y = x if y is None else y
    fs = torch.log_softmax(torch.randn(b, g, m, generator=gen), -1)
    eps = torch.linspace(0.1, 2.0, b)
    return [t.cuda().contiguous() for t in (eps, x, y, fs)]


def graph_ms(fn, iters, replays):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def lse64(eps, x, y, fs, rows=512):
    # float64 logsumexp of the float32 inputs, in row chunks
    out = []
    e, xx, yy, ff = (t.double() for t in (eps, x, y, fs))
    for i in range(0, x.shape[1], rows):
        d = xx[:, i:i + rows, None, :] - yy[:, None, :, :]
        nc = -0.5 * (d * d).sum(-1) / e[:, None, None]
        out.append(torch.logsumexp(ff[:, :, None, :] + nc[:, None], dim=-1))
    return torch.cat(out, dim=-1)


def errors(got, ref):
    err = (got.double() - ref).abs()
    return {"max_abs": float(err.max()), "max_rel": float((err / ref.abs()).max()),
            "mean_abs": float(err.mean())}
"""

PREP = COMMON + r"""
path, b, n, g = sys.argv[1], *map(int, sys.argv[2:5])
sets = {"table": table_inputs(b, n, n, g, 101)}
gen = torch.Generator().manual_seed(202)
particles = (torch.randn(b, n, 2, generator=gen) * 20).cuda()
probs = torch.softmax(torch.randn(b, n, generator=gen), -1).cuda()
_, _, _, iters, pot = sc.ot_resample_streaming(particles, probs, return_potentials=True)
# K1's input at the loop's last iteration, as _ot_resample hands it over
x = particles - particles.mean(1, keepdim=True)
from nfdpf_torch.ops.sinkhorn import diameter
x = x / (diameter(particles, particles)[:, None, None] * math.sqrt(2))
eps = torch.full((b,), 0.1, device="cuda")
logw = torch.log(probs)
fs = sc._k1_input(logw, torch.full_like(logw, -math.log(n)), pot[:, 0], pot[:, 1], eps)
sets["firing"] = [t.contiguous() for t in (eps, x, x, fs[:, :g])]
torch.save({k: [t.cpu() for t in v] for k, v in sets.items()}, path)
print("PREP " + json.dumps({"firing_iters": iters}))
"""

TURN = COMMON + r"""
from nfdpf_torch.ops.cuda import build
cases, acc_path = json.loads(sys.argv[1]), sys.argv[2]
iters_by_n = {int(k): v for k, v in json.loads(sys.argv[3]).items()}
sc._library()
out = {"ms": {}, "bits": {}, "errors": {}, "lib": str(build.build("sinkhorn")),
       "ptxas": build.build_log["sinkhorn"]["ptxas"]}
for b, n, m, g in cases:
    eps, x, y, fs = table_inputs(b, n, m, g, 1000 + b + n + m + g)
    res = torch.empty(b, g, n, device="cuda")
    launch = lambda: sc._launch_lse(eps, x, y, fs, res)
    name = f"B{b}_N{n}_M{m}_G{g}"
    out["ms"][name] = graph_ms(launch, iters_by_n[n], REPLAYS)
    torch.cuda.synchronize()
    out["bits"][name] = hashlib.sha256(res.cpu().numpy().tobytes()).hexdigest()[:16]
for key, (eps, x, y, fs) in torch.load(acc_path).items():
    eps, x, y, fs = (t.cuda() for t in (eps, x, y, fs))
    ref = lse64(eps, x, y, fs)
    got = sc.streaming_lse_multi(eps, x, y, fs)
    out["errors"][key] = errors(got, ref)
    plain = torch.cat([sc.lse_multi_plain(eps, x[:, i:i + 512], y, fs)
                       for i in range(0, x.shape[1], 512)], dim=-1)
    out["errors"][key + "_plain"] = errors(plain, ref)
print("TURN " + json.dumps(out))
"""

SWEEP_TURN = COMMON + r"""
import ctypes
lib_paths, shapes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
iters_by_n = {int(k): v for k, v in json.loads(sys.argv[3]).items()}
ref_lib = sc._library()
out = {}
for label, path in lib_paths.items():
    lib = ctypes.CDLL(path)
    fn = lib.nfdpf_sinkhorn_lse
    fn.argtypes, fn.restype = sc._SIGNATURES["nfdpf_sinkhorn_lse"], ctypes.c_int
    row = {}
    for (b, n, m), g in [(shape, g) for shape in shapes for g in (1, 2)]:
        eps, x, y, fs = table_inputs(b, n, m, g, 1000 + b + n + m + g)
        res = torch.empty(b, g, n, device="cuda")
        ref = sc.streaming_lse_multi(eps, x, y, fs)
        def launch():
            rc = fn(eps.data_ptr(), x.data_ptr(), y.data_ptr(), fs.data_ptr(), res.data_ptr(),
                    b, n, m, g, torch.cuda.current_stream().cuda_stream)
            sc.check_launch(rc, "sinkhorn_lse")
        launch()
        torch.cuda.synchronize()
        torch.testing.assert_close(res, ref, rtol=1e-5, atol=1e-5)
        row[f"B{b}_N{n}_M{m}_G{g}"] = graph_ms(launch, iters_by_n.get(n, 20), REPLAYS)
    out[label] = row
print("SWEEP " + json.dumps(out))
"""

FLOAT_KINDS = ("FFMA", "FADD", "FMUL", "FMNMX", "MUFU", "LDS")
INTEGER = ("IMAD", "IADD", "IADD3", "SHF", "SHL", "LEA", "LOP3", "ISETP", "SEL", "IABS",
           "IMNMX", "PRMT", "MOV", "S2R", "CS2R", "ULDC", "UIADD3", "UMOV", "ULEA", "USHF",
           "UISETP", "ULOP3", "UIMAD", "USEL", "R2UR", "S2UR")
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def sass_functions(text: str) -> dict:
    """{mangled name: [(address, opcode, operands)]} of a ``cuobjdump -sass`` listing."""
    funcs, cur = {}, None
    labels, pending = {}, []
    for ln in text.splitlines():
        hit = re.search(r"Function\s*:\s*(\S+)", ln)
        if hit:
            cur = funcs.setdefault(hit.group(1), [])
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", ln)
        if lab:
            pending.append(lab.group(1))
            continue
        hit = LINE.search(ln)
        if hit and cur is not None:
            addr = int(hit.group(1), 16)
            for name in pending:
                labels[(id(cur), name)] = addr
            pending = []
            cur.append((addr, hit.group(2), hit.group(3)))
    # resolve branch targets given as labels
    out = {}
    for name, instrs in funcs.items():
        resolved = []
        for addr, op, args in instrs:
            target = None
            if op.startswith("BRA"):
                lab = re.search(r"(\.L_x_\d+)", args)
                num = re.search(r"0x([0-9a-f]+)", args)
                if lab and (id(instrs), lab.group(1)) in labels:
                    target = labels[(id(instrs), lab.group(1))]
                elif num:
                    target = int(num.group(1), 16)
            resolved.append((addr, op, target))
        out[name] = resolved
    return out


def kind_of(op: str) -> str:
    base = op.split(".")[0]
    if base in FLOAT_KINDS:
        return base
    if base in INTEGER:
        return "integer"
    return "other"


def count_kinds(instrs) -> dict:
    counts = {}
    for _, op, _ in instrs:
        key = "MUFU.EX2" if op.startswith("MUFU.EX2") else kind_of(op)
        counts[key] = counts.get(key, 0) + 1
    return counts


def lse_sass_counts(text: str) -> dict:
    """Instructions by kind per pair of each K1 instantiation's sweep: the
    largest basic block of the kernel (branch-free: every loop over the
    tile's pairs is unrolled), over the R·C pairs a lane takes in a tile;
    the many-tile path also with its whole tile loop (the widest backward
    branch: the sweep, the next tile's staging and the barrier, all of its
    code whether a tile runs it or not)."""
    out = {}
    for name, instrs in sass_functions(text).items():
        hit = re.search(r"lse_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])E", name)
        if not hit:
            continue
        g, r, rg, cs, c, one = map(int, hit.groups())
        targets = {t for _, _, t in instrs if t is not None}
        blocks, cur = [], []
        for ins in instrs:
            if ins[0] in targets and cur:
                blocks.append(cur)
                cur = []
            cur.append(ins)
            if ins[1].startswith(("BRA", "EXIT", "BAR")):
                blocks.append(cur)
                cur = []
        blocks.append(cur)
        pairs = r * c
        sweep = count_kinds(max(blocks, key=len))
        label = f"lse_kernel<{g}, {r}, {rg}, {cs}, {c}, {'true' if one else 'false'}>"
        out[label] = {"pairs": pairs,
                      "sweep_per_pair": {k: round(v / pairs, 3) for k, v in sorted(sweep.items())},
                      "sweep_slots_per_pair": round(sum(sweep.values()) / pairs, 3)}
        loops = [(t, a) for a, _, t in instrs if t is not None and t < a]
        if not one and loops:
            lo, hi = max(loops, key=lambda t: t[1] - t[0])
            loop = count_kinds([ins for ins in instrs if lo <= ins[0] <= hi])
            out[label]["tile_loop_slots_per_pair"] = round(sum(loop.values()) / pairs, 3)
    return out


def ptxas_lse(text: str) -> dict:
    out, name = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            hit = re.search(r"lse_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])E", ln)
            name = None
            if hit:
                g, r, rg, cs, c, one = hit.groups()
                name = f"lse_kernel<{g}, {r}, {rg}, {cs}, {c}, {'true' if one == '1' else 'false'}>"
                out[name] = {}
        elif name is not None and "spill stores" in ln:
            words = ln.replace(",", "").split()
            out[name]["spill_bytes"] = (int(words[words.index("spill") - 2])
                                        + int(words[words.index("loads") - 3]))
        elif name is not None and "Used" in ln and "registers" in ln:
            words = ln.replace(",", "").split()
            out[name]["registers"] = int(words[words.index("registers") - 1])
            name = None
    return out


def find_nvcc() -> str:
    sys.path.insert(0, HERE)
    from nfdpf_torch.ops.cuda import build

    return build.find_nvcc()


def run_py(code: str, root: str, args, tag: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", f"REPLAYS = {REPLAYS}\n" + code, *args],
                          cwd=root, capture_output=True, text=True)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith(tag)), None)
    if proc.returncode != 0 or line is None:
        raise RuntimeError(f"{tag.strip()} in {root} failed (rc {proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    return json.loads(line[len(tag):])


def sweep_libraries(build_dir: str) -> dict:
    """One copy of csrc/ a SWEEP entry, K1's tile constants rewritten, each
    built with the port's flags (in parallel): ({label: library path},
    {label: ptxas's K1 counts})."""
    from nfdpf_torch.ops.cuda import build

    nvcc = find_nvcc()
    procs = {}
    for r, c, warps in SWEEP:
        label = f"R{r}_C{c}_W{warps}"
        src_dir = os.path.join(build_dir, label)
        shutil.copytree(build.CSRC, src_dir, dirs_exist_ok=True)
        src = os.path.join(src_dir, "sinkhorn.cu")
        text = open(src).read()
        for name, value in (("kLseR", r), ("kLseC", c), ("kLseWarps", warps)):
            line = re.compile(rf"constexpr int {name} = \d+;")
            if not line.search(text):
                raise RuntimeError(f"no {name} line in {src}")
            text = line.sub(f"constexpr int {name} = {value};", text)
        open(src, "w").write(text)
        lib = os.path.join(src_dir, "libsinkhorn.so")
        procs[label] = (lib, subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", lib, src],
                                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                              text=True))
    libs, ptxas = {}, {}
    for label, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            ptxas[label] = {"build_failed": err[-2000:]}
            continue
        libs[label] = lib
        ptxas[label] = ptxas_lse(err)
    return libs, ptxas


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="root of the other tree")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--sass", help="directory for each tree's cuobjdump -sass listing")
    parser.add_argument("--out", help="also write the JSON line to this file")
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "no nvidia-smi", flush=True)
    trees = {"other": os.path.abspath(args.other), "this": HERE}
    work = tempfile.mkdtemp(prefix="k1_ab_")
    acc_path = os.path.join(work, "accuracy.pt")
    result = {"card": card.strip(), "prep": run_py(PREP, HERE, [acc_path, *map(str, ACCURACY)],
                                                   "PREP ")}
    cases = json.dumps(CASES)
    iters = json.dumps(ITERS)
    turns = []
    for tree in ["other", "this", "this", "other"] * args.rounds:
        turn = run_py(TURN, trees[tree], [cases, acc_path, iters], "TURN ")
        turn["tree"] = tree
        turns.append(turn)
        print(json.dumps({"tree": tree, "ms": turn["ms"]}), flush=True)
    summary = {}
    for tree in trees:
        mine = [t for t in turns if t["tree"] == tree]
        summary[tree] = {
            "ms": {k: statistics.median(t["ms"][k] for t in mine) for k in mine[0]["ms"]},
            "bits_equal_across_turns": all(t["bits"] == mine[0]["bits"] for t in mine),
            "errors": mine[0]["errors"],
            "ptxas": ptxas_lse(mine[0]["ptxas"]),
        }
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            dump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
            text = subprocess.run([dump, "-sass", mine[0]["lib"]], capture_output=True,
                                  text=True).stdout
            with open(os.path.join(args.sass, f"{tree}.sass"), "w") as fh:
                fh.write(text)
            summary[tree]["sass"] = lse_sass_counts(text)
    summary["ratio_this_over_other"] = {k: summary["this"]["ms"][k] / summary["other"]["ms"][k]
                                        for k in summary["this"]["ms"]}
    result.update(summary=summary, turns=[{"tree": t["tree"], "ms": t["ms"]} for t in turns])
    if args.sweep:
        libs, ptxas = sweep_libraries(os.path.join(work, "sweep"))
        result["sweep_ptxas"] = ptxas
        result["sweep"] = run_py(SWEEP_TURN, HERE, [json.dumps(libs), json.dumps(SWEEP_SHAPES),
                                                    iters], "SWEEP ")
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
