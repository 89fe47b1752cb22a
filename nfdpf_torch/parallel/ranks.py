"""Run work on several ranks from one process, and the per-rank jobs that
check a mesh against the unsharded port.

``spawn(world, jobs)`` starts ``world`` fresh processes (``spawn``, so each
imports torch and this package only), joins them in one process group on
``localhost`` and runs every job on every rank in order; a job builds its
mesh (``make_mesh``, over all ranks or a subset) and returns what its
first rank gathered.  A rank that fails fails the whole call with its
traceback.  The tests run the jobs on the CPU over gloo; ``chip_smoke.py``
runs them with every rank on the one card (gloo through the host).

The jobs take and return numpy arrays only, so a caller may hold JAX
results beside them; the draws are the global ones (``DPF``'s convention).
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import queue
import socket
import statistics
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from nfdpf_torch import main as entry
from nfdpf_torch.bridge import load_jax_variables
from nfdpf_torch.config import DPFConfig
from nfdpf_torch.models.dpf import DPF
from nfdpf_torch.models.nets import FlaxBatchNorm
from nfdpf_torch.ops import sinkhorn as dense
from nfdpf_torch.ops.cuda import coupling_cuda as cc
from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc
from nfdpf_torch.ops.resampling import soft_systematic_resample
from nfdpf_torch.parallel.distributed import initialize, shutdown
from nfdpf_torch.parallel.mesh import (
    COLLECTIVES,
    DATA_AXIS,
    PARTICLE_AXIS,
    all_gather,
    average_gradients,
    local_slice,
    make_mesh,
    reset_collectives,
)
from nfdpf_torch.train import Trainer

Job = Tuple[Callable, dict]


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _numerics() -> tuple:
    """The caller's settings that change a CUDA result's bits."""
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)


def _rank_main(rank: int, world: int, port: int, backend: str, threads: int,
               numerics: tuple, jobs: Sequence[Job], results) -> None:
    torch.set_num_threads(threads)
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = numerics
    try:
        initialize(backend, rank, world, f"tcp://127.0.0.1:{port}")
        try:
            out = [fn(**kwargs) for fn, kwargs in jobs]
        finally:
            shutdown()
        results.put((rank, True, out))
    except BaseException:   # reported to the caller, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(world: int, jobs: Sequence[Job], backend: str = "gloo", threads: int = 1,
          timeout: float = 900.0) -> List[list]:
    """Run ``jobs`` on ``world`` new ranks, each with ``threads`` CPU
    threads and the caller's TF32 and cuDNN-determinism settings; returns,
    per job, every rank's return value in rank order.  Raises if a rank
    fails or the ranks do not finish within ``timeout`` seconds; every
    process is ended either way."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, threads, _numerics(), list(jobs),
                               results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(got)} of {world} ranks did not finish "
                                   f"in {timeout:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 5.0))
            except queue.Empty:        # look for ranks that died
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]}") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [[got[r][j] for r in range(world)] for j in range(len(jobs))]


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------


def _mesh(shape, ranks):
    return make_mesh(shape[0], shape[1], ranks)


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(device)


def _whole(x: torch.Tensor, mesh, data_dim: Optional[int] = 0,
           particle_dim: Optional[int] = None) -> np.ndarray:
    """A rank's block gathered back into the global array, on the host."""
    with torch.no_grad():
        if particle_dim is not None:
            x = all_gather(x, mesh, PARTICLE_AXIS, particle_dim)
        if data_dim is not None:
            x = all_gather(x, mesh, DATA_AXIS, data_dim)
    return x.detach().cpu().numpy()


def _launches() -> dict:
    return {**sc.LAUNCHES, **cc.LAUNCHES}


def _reset_launches() -> None:
    """The launch, collective and streaming-loop counters set to 0."""
    sc.reset_launches()
    cc.reset_launches()
    sc.reset_streaming_loop()
    reset_collectives()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def resample_job(shape, particles, probs, kw: dict, ranks=None, warm=None,
                 device="cpu", times: int = 0, plain: bool = False):
    """OT resampling of the global (B, N, 2) ``particles`` on a (data,
    particle) mesh: the particle-sharded driver (K6) when the particle axis
    is over 1, else the streaming one (K3); with ``plain`` the driver's
    plain version.  ``warm``: (global potentials, valid).  Returns, on the
    mesh's first rank, the transported particles, the potentials, the
    indices (global), the iterations, the gradient of Σ transported² to the
    particles, and the forward call's launches, collectives and streaming
    loop counts (set to 0 just before it, read just after); with ``times``
    the median ms a call of the driver (``ms``) and of its plain version
    (``plain_ms``) over that many calls each, in turns (driver, plain,
    plain, driver, ...; each call synchronised), and every call's ms
    (``calls_ms``)."""
    mesh = _mesh(shape, ranks)
    if mesh is None:
        return None

    def block(a, dims):
        t = _tensor(a, device)
        for axis, dim in zip((DATA_AXIS, PARTICLE_AXIS), dims):
            t = local_slice(t, mesh, axis, dim)
        return t

    x = block(particles, (0, 1)).requires_grad_()
    w = block(probs, (0, 1))
    sharded = shape[1] > 1
    fns = {"ms": sc.ot_resample_streaming_sharded if sharded else sc.ot_resample_streaming,
           "plain_ms": (sc.ot_resample_streaming_sharded_plain if sharded
                        else sc.ot_resample_streaming_plain)}
    fn = fns["plain_ms" if plain else "ms"]
    kwargs = dict(kw, mesh=mesh, return_potentials=True)
    if warm is not None:
        kwargs["warm_start"] = (block(warm[0], (0, 2)), bool(warm[1]))
    _reset_launches()
    out, _, idx, iters, pots = fn(x, w, **kwargs)
    counts = {"launches": _launches(), "collectives": dict(COLLECTIVES),
              "loop": dict(sc.STREAMING_LOOP)}
    # each rank's share of Σ transported²: their sum is the global loss
    (grad,) = torch.autograd.grad(torch.sum(out**2), [x])
    calls = {}
    if times:
        with torch.no_grad():
            for name in fns:
                fns[name](x, w, **kwargs)
            for turn in range(times):
                for name in (("ms", "plain_ms") if turn % 2 == 0 else ("plain_ms", "ms")):
                    _sync(device)
                    t0 = time.perf_counter()
                    fns[name](x, w, **kwargs)
                    _sync(device)
                    calls.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
    res = {"particles": _whole(out, mesh, 0, 1), "potentials": _whole(pots, mesh, 0, 2),
           "idx": _whole(idx, mesh, 0, 1), "iters": iters, "grad": _whole(grad, mesh, 0, 1),
           **counts, **{k: statistics.median(calls[k]) if calls else None for k in fns},
           "calls_ms": calls}
    return res if (mesh.data_index, mesh.particle_index) == (0, 0) else {"iters": iters}


class LargestTensor(TorchDispatchMode):
    """While active, the most elements of any tensor an operation returned."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def firing(particles: torch.Tensor, probs: torch.Tensor, resampler: str, kw: dict,
           offset: Optional[torch.Tensor] = None, mesh=None) -> dict:
    """One firing of the dense OT (``resampler="dense"``, ``kw`` its
    settings) or the soft resampler (``"soft"``, ``kw`` holds ``alpha``) on
    this rank's blocks, and the gradient of Σ resampled² + Σ w'·c (c the
    weights' global position, so that the weights' gradient is not zero) to
    the particles and the weights.  Returns the outputs, the gradients, the
    forward call's collectives and dense loop counts (set to 0 just before,
    read just after) and the most elements of any tensor the forward and
    the backward made."""
    x = particles.detach().clone().requires_grad_()
    w = probs.detach().clone().requires_grad_()
    reset_collectives()
    dense.reset_dense_loop()
    with LargestTensor() as largest:
        if resampler == "dense":
            out, new_w, idx = dense.ot_resample(x, w, mesh=mesh, **kw)
        else:
            out, new_w, idx = soft_systematic_resample(x, w, offset=offset, mesh=mesh, **kw)
        counts = {"collectives": dict(COLLECTIVES), "loop": dict(dense.DENSE_LOOP)}
        where = idx.to(new_w.dtype) + 1.0
        loss = torch.sum(out**2) + torch.sum(new_w * where)
        x_grad, w_grad = torch.autograd.grad(loss, [x, w], allow_unused=True)
    return {"particles": out.detach(), "weights": new_w.detach(), "idx": idx,
            "x_grad": x_grad, "w_grad": w_grad, "largest": largest.numel, **counts}


def firing_job(shape, particles, probs, resampler: str, kw: dict, offset=None, ranks=None):
    """``firing`` of the global (B, N, 2) ``particles`` and (B, N)
    ``probs`` (and the global (B, 1) ``offset``) on a (data, particle)
    mesh on the CPU.  Returns, on the mesh's first rank, the outputs and
    the gradients gathered (each rank's loss is its share of the global
    one, so its gradient is its block of the global gradient), the counts
    and every rank's largest tensor."""
    mesh = _mesh(shape, ranks)
    if mesh is None:
        return None

    def block(a, dims):
        t = _tensor(a, "cpu")
        for axis, dim in zip((DATA_AXIS, PARTICLE_AXIS), dims):
            t = local_slice(t, mesh, axis, dim)
        return t

    res = firing(block(particles, (0, 1)), block(probs, (0, 1)), resampler, kw,
                 None if offset is None else block(offset, (0,)), mesh)
    largest = _whole(torch.tensor([res["largest"]]), mesh, 0, 0)
    out = {k: _whole(res[k], mesh, 0, 1) for k in ("particles", "weights", "idx")}
    for k in ("x_grad", "w_grad"):
        out[k] = None if res[k] is None else _whole(res[k], mesh, 0, 1)
    out.update(collectives=res["collectives"], loop=res["loop"], largest=largest.tolist())
    return out if (mesh.data_index, mesh.particle_index) == (0, 0) else None


def _trainer(settings: dict, shape, ranks, variables, device):
    mesh = _mesh(shape, ranks)
    if mesh is None:
        return None
    trainer = Trainer(DPFConfig(**settings), device, mesh)
    if variables is not None:
        load_jax_variables(trainer.engine, variables, mesh)
    return trainer


@torch.no_grad()
def draw_cglow(engine: DPF, std: float, seed: int = 7) -> None:
    """Draw the CGLOW measurement's parameters from N(0, std²) (on the CPU,
    from ``seed``), but for the nets that make its 1×1 convolution's
    weights: at init its likelihood does not depend on the particle, and
    its gradients are rounding residue."""
    draw = torch.Generator().manual_seed(seed)
    for name, p in engine.measurement.cglow.named_parameters():
        if ".invconv." not in name:
            p.copy_(torch.randn(p.shape, generator=draw) * std)


def train_step_job(settings: dict, shape, batch: dict, noise: dict, ranks=None,
                   variables: Optional[dict] = None, device="cpu", cglow_std: float = 0.0):
    """One ``Trainer.train_step`` of a global ``batch`` with the global
    ``noise`` on a (data, particle) mesh, from the JAX package's
    ``variables`` (through the bridge; the seed's init when None), with
    ``cglow_std`` the CGLOW's parameters drawn (``draw_cglow``).  Returns,
    on every rank of the mesh, the metrics, every parameter's (averaged)
    gradient, the launches and the step's seconds."""
    trainer = _trainer(settings, shape, ranks, variables, device)
    if trainer is None:
        return None
    if cglow_std:
        draw_cglow(trainer.engine, cglow_std)
    return step_result(trainer, batch, noise, device)


def step_result(trainer, batch: dict, noise: dict, device) -> dict:
    """``trainer.train_step`` of ``batch`` with ``noise`` (numpy, global),
    the launch and collective counters set to 0 just before it and read
    just after: the metrics, each parameter's gradient, the launches, the
    collectives, the dense Sinkhorn loop's iterations, the seconds and, on
    a card, the step's peak memory in GiB."""
    noise = {k: _tensor(v, device) for k, v in noise.items()}
    cuda = torch.device(device).type == "cuda"
    _reset_launches()
    dense.reset_dense_loop()
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = trainer.train_step(batch, noise=noise)
    _sync(device)
    seconds = time.perf_counter() - t0
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.detach().cpu().numpy()
                      for k, p in trainer.engine.named_parameters() if p.grad is not None},
            "launches": _launches(), "collectives": dict(COLLECTIVES),
            "dense_iters": dense.DENSE_LOOP["iters"], "s": seconds,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None}


def settings_steps_job(cases: dict, shape, batch: dict, noise: dict, ranks=None,
                       device="cpu"):
    """``step_result`` of one train step for each of ``cases`` (name →
    settings, each from the seed's init) on one (data, particle) mesh,
    built once.  Returns, on the mesh's first rank, the results by name."""
    mesh = _mesh(shape, ranks)
    if mesh is None:
        return None
    out = {name: step_result(Trainer(DPFConfig(**settings), device, mesh), batch, noise, device)
           for name, settings in cases.items()}
    return out if (mesh.data_index, mesh.particle_index) == (0, 0) else None


def float64_step(settings: dict, batch: dict, noise: dict,
                 variables: Optional[dict] = None, mesh=None) -> dict:
    """The loss and gradients of one train step in float64 on the CPU
    (parameters, compute and draws), from the seed's init or the JAX
    package's ``variables``, on the float32 runs' inputs (uint8 frames
    scaled as the trainer scales them), unsharded or on ``mesh`` (the
    gradients averaged over it): the exact step that float32 runs are read
    against, and on a mesh the proof that it computes the unsharded step's
    function.  Returns the loss and every parameter's gradient."""
    trainer = Trainer(DPFConfig(**settings), "cpu", mesh)
    if variables is not None:
        load_jax_variables(trainer.engine, variables, mesh)
    images = np.asarray(batch["image"])
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / np.float32(255.0)
    batch = {k: np.asarray(v, dtype=np.float64) for k, v in dict(batch, image=images).items()}
    torch.set_default_dtype(torch.float64)
    try:
        engine = trainer.engine.double()
        engine.encoder.compute_dtype = engine.decoder.compute_dtype = torch.float64
        loss, _ = trainer._loss(batch, True, {k: _tensor(v, "cpu").double()
                                              for k, v in noise.items()})
        loss.backward()
        average_gradients(engine.parameters(), mesh)
    finally:
        torch.set_default_dtype(torch.float32)
    return {"loss": loss.item(),
            "grads": {k: p.grad.numpy() for k, p in engine.named_parameters()
                      if p.grad is not None}}


def float64_step_job(cases: dict, shape, batch: dict, noise: dict, ranks=None,
                     variables: Optional[dict] = None):
    """``float64_step`` for each of ``cases`` (name → settings, each from
    the seed's init or the JAX package's ``variables``) on one (data,
    particle) mesh, built once.  Returns, on the mesh's first rank, the
    results by name."""
    mesh = _mesh(shape, ranks)
    if mesh is None:
        return None
    out = {name: float64_step(settings, batch, noise, variables, mesh)
           for name, settings in cases.items()}
    return out if (mesh.data_index, mesh.particle_index) == (0, 0) else None


def filter_job(settings: dict, shape, batch: dict, noise: dict, ranks=None,
               variables: Optional[dict] = None, device="cpu"):
    """The eval-mode filter (``DPF.filter``) of a global ``batch`` with the
    global ``noise`` on a mesh.  Returns, on the mesh's first rank, the
    gathered particles, weights and ancestor indices, (B, T, N, ...), and
    the per-step Sinkhorn iterations."""
    trainer = _trainer(settings, shape, ranks, variables, device)
    if trainer is None:
        return None
    engine, mesh = trainer.engine, trainer.mesh
    engine.eval()
    local = trainer._batch(batch)
    with torch.no_grad():
        out, _ = engine.filter(local["image"], local["start_state"], local["state"][..., 2:],
                               {k: _tensor(v, device) for k, v in noise.items()})
    res = {"particles": _whole(out.particles, mesh, 0, 2),
           "weights": _whole(out.weights, mesh, 0, 2),
           "indices": _whole(out.indices, mesh, 0, 2),
           "sinkhorn_iters": out.sinkhorn_iters.numpy()}
    return res if (mesh.data_index, mesh.particle_index) == (0, 0) else None


def _perturbed(tree, shift: float):
    if isinstance(tree, dict):
        return {k: _perturbed(v, shift) for k, v in tree.items()}
    return np.asarray(tree) + np.asarray(shift, dtype=np.asarray(tree).dtype)


def replicate_job(settings: dict, variables: dict, device="cpu"):
    """The JAX package's ``variables`` through the bridge onto a 1×world
    mesh's ranks, each rank's copy first perturbed by its rank (as if the
    ranks had loaded different files): returns each rank's digest of every
    parameter's and buffer's bytes afterwards."""
    mesh = make_mesh()
    engine = DPF(DPFConfig(**settings), device, mesh)
    shift = float(dist.get_rank())
    own = {k: _perturbed(v, shift) for k, v in variables.items()}
    load_jax_variables(engine, own, mesh)
    digest = hashlib.sha256()
    for name, t in engine.state_dict().items():
        digest.update(name.encode())
        digest.update(t.detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def mesh_shapes_job(cases: Sequence[dict]):
    """``make_mesh(**case)`` for each case: its shape, or the ValueError's
    message."""
    out = []
    for case in cases:
        try:
            out.append(make_mesh(**case).shape)
        except ValueError as err:
            out.append(f"ValueError: {err}")
    return out


def batchnorm_job(shape, x, g, ranks=None, device="cpu"):
    """``FlaxBatchNorm`` in train mode on a global (B, C, H, W) ``x`` with
    its batch sharded over a mesh's data axis: the gathered output, the
    running statistics after the update and the gradients of Σ out·g (to
    the input, gathered, and to scale and bias, summed over the mesh: each
    rank's Σ over its rows is its share of the global sum)."""
    mesh = _mesh(shape, ranks)
    if mesh is None:
        return None
    bn = FlaxBatchNorm(x.shape[1], mesh=mesh).to(device)
    xl = local_slice(_tensor(x, device), mesh, DATA_AXIS, 0).requires_grad_()
    out = bn(xl)
    torch.sum(out * local_slice(_tensor(g, device), mesh, DATA_AXIS, 0)).backward()
    average_gradients(bn.parameters(), mesh)
    return {"out": _whole(out, mesh), "x_grad": _whole(xl.grad, mesh),
            "running_mean": bn.running_mean.cpu().numpy(),
            "running_var": bn.running_var.cpu().numpy(),
            "weight_grad": bn.weight.grad.cpu().numpy() * mesh.size,
            "bias_grad": bn.bias.grad.cpu().numpy() * mesh.size}


def main_job(argv: Sequence[str], workdir: str, device="cpu", rank: Optional[int] = None):
    """``nfdpf_torch.main.main(argv)`` on every rank, or on ``rank`` alone
    (the one-process run), from ``workdir`` (the ranks already form the
    process group a mesh run would join).  Returns the files under
    ``workdir/logs`` this rank sees afterwards."""
    if rank is not None and dist.get_rank() != rank:
        return None
    home = os.getcwd()
    os.chdir(workdir)
    try:
        entry.main(list(argv), device=device)
    finally:
        os.chdir(home)
    return sorted(os.path.relpath(os.path.join(d, f), workdir)
                  for d, _, files in os.walk(os.path.join(workdir, "logs")) for f in files)
