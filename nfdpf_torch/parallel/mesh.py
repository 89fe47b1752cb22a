"""The ('data', 'particle') mesh over ``torch.distributed`` ranks, and the
collectives the filter, the losses and the trainer run on it.

Counterpart of ``nfdpf_tpu/parallel/mesh.py``.  JAX's GSPMD places the
collectives from sharding annotations; here they are explicit:

* the batch is sharded over ``data``: each data rank holds B/D sequences,
  and batch means (the ESS gate, BatchNorm's statistics, the losses, the
  Sinkhorn stop test) are all-reduced over the data group;
* the particle axis is sharded over ``particle``: each particle rank holds
  N/P particles, and the reductions over particles (weight normalisation,
  the ESS, the estimates, the measurement's row maximum, the flows'
  contexts) are all-reduced over the particle group; what resampling and
  the pseudo-likelihood's ancestor walk read across ranks is all-gathered
  (K6 ``ot_resample_streaming_sharded``, the dense Sinkhorn's row blocks,
  the soft resampler's weights and particles, the walk's inputs);
* parameters and the optimizer state are replicated.

Rank r sits at (r // P, r % P), as JAX lays the devices out
(``np.array(devices).reshape(data, particle)``).  The collectives in the
autograd graph have their true adjoints: an all-reduce's backward is an
all-reduce of the gradient, a tiled all-gather's is the all-reduced
gradient's local slice, the maximum's sends the summed gradient to the
entries that attain it (shared between ties, as ``jnp.max``).  Each rank
then computes the global (replicated) loss, and the mean over all D·P ranks
of each rank's parameter gradients is the global gradient
(``average_gradients``).  They are built on ``all_reduce`` and
``all_gather`` only, which gloo runs on CPU and CUDA tensors.

Every function takes ``mesh=None`` (or an axis of size 1) as the identity,
so that unsharded code runs through the same lines.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
PARTICLE_AXIS = "particle"

# collectives issued since the last reset, by operation (forward and
# backward alike), so a run can count what crosses between ranks
COLLECTIVES = {"all_gather": 0, "all_reduce": 0, "broadcast": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data × particle) grid of ranks.  ``data_index``/``particle_index``
    place this process in it; the groups are None on an axis of size 1
    (and everywhere on a 1×1 mesh)."""

    data: int
    particle: int
    ranks: tuple
    data_index: int
    particle_index: int
    data_group: Optional[object] = None
    particle_group: Optional[object] = None
    group: Optional[object] = None          # every rank of the mesh

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, PARTICLE_AXIS: self.particle}

    @property
    def size(self) -> int:
        return self.data * self.particle

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.data_index if axis == DATA_AXIS else self.particle_index

    def axis_group(self, axis: str):
        return self.data_group if axis == DATA_AXIS else self.particle_group


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(data: Optional[int] = None, particle: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """The (data, particle) mesh over ``ranks`` (default: every rank of the
    initialised group, or the one process).  ``data=None`` takes every rank
    the particle axis leaves.  Raises ``ValueError`` as the JAX package does
    when the sizes do not tile the ranks.

    Every rank of the group calls this, with the same arguments (it creates
    process groups); a rank outside ``ranks`` gets None."""
    world = _world()
    ranks = tuple(range(world)) if ranks is None else tuple(sorted(ranks))
    n = len(ranks)
    if n % particle != 0:
        raise ValueError(f"{n} ranks not divisible by particle={particle}")
    if data is None:
        data = n // particle
    if data * particle != n:
        raise ValueError(f"mesh {data}x{particle} != {n} ranks; pass matching sizes")
    if any(r < 0 or r >= world for r in ranks) or len(set(ranks)) != n:
        raise ValueError(f"ranks {ranks} are not distinct ranks of a world of {world}")
    me = dist.get_rank() if world > 1 else 0
    groups = {}
    if n > 1:
        # every rank creates every group, in one order (new_group's contract)
        mesh_group = dist.group.WORLD if n == world else dist.new_group(list(ranks))
        groups["group"] = mesh_group
        for d in range(data):
            row = [ranks[d * particle + p] for p in range(particle)]
            g = dist.new_group(row) if particle > 1 else None
            if me in row:
                groups["particle_group"] = g
        for p in range(particle):
            col = [ranks[d * particle + p] for d in range(data)]
            g = dist.new_group(col) if data > 1 else None
            if me in col:
                groups["data_group"] = g
    if me not in ranks:
        return None
    k = ranks.index(me)
    return Mesh(data, particle, ranks, k // particle, k % particle, **groups)


def axis_size(mesh: Optional[Mesh], axis: str) -> int:
    return 1 if mesh is None else mesh.axis_size(axis)


def axis_index(mesh: Optional[Mesh], axis: str) -> int:
    return 0 if mesh is None else mesh.axis_index(axis)


def _group(mesh: Optional[Mesh], axis: str):
    return None if mesh is None or mesh.axis_size(axis) == 1 else mesh.axis_group(axis)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def local_slice(x: torch.Tensor, mesh: Optional[Mesh], axis: str, dim: int) -> torch.Tensor:
    """This rank's block of a global tensor along ``dim``, split over
    ``axis`` (the size must divide)."""
    size = axis_size(mesh, axis)
    if size == 1:
        return x
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"{axis} axis of size {size} does not divide dim {dim} of "
                         f"shape {tuple(x.shape)}")
    block = n // size
    return x.narrow(dim, axis_index(mesh, axis) * block, block)


def shard_batch(batch: dict, mesh: Optional[Mesh]) -> dict:
    """Each data rank's slice of the leading (batch) axis of every entry."""
    return {k: local_slice(v, mesh, DATA_AXIS, 0) for k, v in batch.items()}


def constrain(x: torch.Tensor, mesh: Optional[Mesh], *spec) -> torch.Tensor:
    """``x`` as it is.  JAX's counterpart pins a layout with a sharding
    constraint, which never changes values; here each rank holds its shard
    explicitly, so there is no layout to pin."""
    return x


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Broadcast every parameter and buffer of ``module`` from the mesh's
    first rank, in place: afterwards every rank holds the same bits."""
    if mesh is None or mesh.size == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=mesh.ranks[0], group=mesh.group)
        COLLECTIVES["broadcast"] += 1


def average_gradients(params, mesh: Optional[Mesh]) -> None:
    """Replace each gradient by its mean over every rank of the mesh (one
    all-reduce of the gradients flattened together).  Parameters without a
    gradient are skipped: every rank runs the same graph, so they are the
    same ones everywhere."""
    if mesh is None or mesh.size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    COLLECTIVES["all_reduce"] += 1
    flat /= mesh.size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


# ---------------------------------------------------------------------------
# collectives with their adjoints
# ---------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        COLLECTIVES["all_reduce"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        COLLECTIVES["all_reduce"] += 1
        return g, None


class _RowMax(torch.autograd.Function):
    """max over the last dim, across the group: the summed gradient goes to
    the entries equal to the maximum, shared evenly between all of them on
    every rank."""

    @staticmethod
    def forward(ctx, x, group):
        m = torch.amax(x, dim=-1, keepdim=True).contiguous()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        COLLECTIVES["all_reduce"] += 1
        ctx.group = group
        ctx.save_for_backward(x, m)
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        hit = (x == m).to(x.dtype)
        both = torch.cat([g, torch.sum(hit, dim=-1, keepdim=True)], dim=-1).contiguous()
        dist.all_reduce(both, group=ctx.group)
        COLLECTIVES["all_reduce"] += 1
        g_sum, count = both[..., :1], both[..., 1:]
        return hit * (g_sum / count), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.index, ctx.block = dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        COLLECTIVES["all_gather"] += 1
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        COLLECTIVES["all_reduce"] += 1
        return g.narrow(ctx.dim, ctx.index * ctx.block, ctx.block), None, None


def psum(x: torch.Tensor, mesh: Optional[Mesh], *axes: str) -> torch.Tensor:
    """Sum over the ranks of each of ``axes`` (differentiable)."""
    for axis in axes:
        group = _group(mesh, axis)
        if group is not None:
            x = _AllReduceSum.apply(x, group)
    return x


def row_max(x: torch.Tensor, mesh: Optional[Mesh], axis: str = PARTICLE_AXIS) -> torch.Tensor:
    """The maximum over the last dim of a tensor whose last dim is sharded
    over ``axis``, keepdim, differentiable as ``torch.amax`` (the gradient
    to the maximal entries, shared between ties)."""
    group = _group(mesh, axis)
    if group is None:
        return torch.amax(x, dim=-1, keepdim=True)
    return _RowMax.apply(x, group)


def all_gather(x: torch.Tensor, mesh: Optional[Mesh], axis: str, dim: int) -> torch.Tensor:
    """The blocks of every rank of ``axis`` concatenated along ``dim`` in
    rank order (tiled; differentiable)."""
    group = _group(mesh, axis)
    if group is None:
        return x
    return _AllGather.apply(x, group, dim)


def pmax(x: torch.Tensor, mesh: Optional[Mesh], axis: str) -> torch.Tensor:
    """Elementwise maximum over the ranks of ``axis`` (not differentiable:
    for detached stop tests)."""
    group = _group(mesh, axis)
    if group is None:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    COLLECTIVES["all_reduce"] += 1
    return y


def gather_into(out: torch.Tensor, x: torch.Tensor, mesh: Optional[Mesh], axis: str) -> None:
    """Every rank's contiguous block ``x`` of ``axis`` written into ``out``,
    (ranks, *x.shape) in rank order, contiguous and allocated once by the
    caller: one all-gather, no concatenation (not differentiable)."""
    group = _group(mesh, axis)
    if group is None:
        out.view_as(x).copy_(x)
        return
    # torch ≥ 2.12 names it all_gather_single
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out.flatten(0, 1), x, group=group)
    COLLECTIVES["all_gather"] += 1


def agree(flag: torch.Tensor, mesh: Optional[Mesh], axis: str, how: str = "all") -> bool:
    """A host bool that every rank of ``axis`` reads alike: the ``all`` or
    ``any`` of the local scalar ``flag`` over the group.  One device sync."""
    group = _group(mesh, axis)
    if group is None:
        return bool(flag)
    v = flag.reshape(1).to(torch.int32)
    op = dist.ReduceOp.MIN if how == "all" else dist.ReduceOp.MAX
    dist.all_reduce(v, op=op, group=group)
    COLLECTIVES["all_reduce"] += 1
    return bool(v)
