"""Streaming-Sinkhorn OT resampling on hand-written CUDA kernels.

Counterpart of ``nfdpf_tpu/ops/pallas/sinkhorn_pallas.py``.  Two kernels
(``csrc/sinkhorn.cu``) stream the cost ``C_ij = ½‖x_i − y_j‖²`` from the
(B, N, 2) coordinates instead of materialising (B, N, M) matrices:

* ``streaming_lse_multi``  out[b,g,i] = logsumexp_j(f[b,g,j] − C_ij/ε_b)
  (replaces ``_lse_kernel``, ``sinkhorn_pallas.py:78``);
* ``transport_apply_rc``   out = T @ v with T_ij = exp(r_i + c_j − C_ij/ε_b)
  (replaces ``_apply_kernel``, ``sinkhorn_pallas.py:180``); a
  ``torch.autograd.Function`` whose backward is the same kernel with rows
  and columns swapped (Tᵀg), for ``values`` only.

Each wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors; anything else raises.  ``LAUNCHES``
counts the kernel launches, so a run can show which path it took.

In both kernels a warp owns a few rows and its lanes stride the columns of
a tile staged in shared memory; how many rows, warps and column splits a
launch takes is chosen in ``csrc/sinkhorn.cu`` from (B, N, M).

``ot_resample_streaming`` is the driver (``ot_resample_pallas``,
``sinkhorn_pallas.py:291-454``, "K3"), cold or warm started, its stop test
taken over the data axis of a mesh.  Each Sinkhorn iteration is K1 and one
more kernel, ``sinkhorn_update`` (``csrc/sinkhorn.cu``: the rest of the
iteration, the loop counter and a done flag that freezes the state on the
loop's own last iteration); on the card ``loop_chunk(N)`` iterations of the
two are captured once in a CUDA graph and replayed, with one host read of
the flag per replay.  ``ot_resample_streaming_plain`` is the driver's plain
version: the eager loop on every kernel's plain version, one host read per
iteration.  ``ot_resample_streaming_sharded`` ("K6",
``ot_resample_pallas_sharded``, ``sinkhorn_pallas.py:462-632``) runs it with
the particle axis sharded over ranks, on the same kernels: an iteration is
K1 on the rank's rows against every rank's columns, one all-gather of its
output, and the update over all N on every rank;
``ot_resample_streaming_sharded_plain`` is its plain version, the JAX body's
eager loop.

Under a profiler the loop's host side is in spans (``utils/profiling.py``):
``ot.loop`` around a firing's loop, ``ot.replay`` around each chunk of
iterations (a graph replay on the card), ``ot.stop_read`` around each host
read of the stop flag and ``ot.capture`` around building a graph; none
inside a captured region.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from nfdpf_torch.ops.cuda._common import check_launch, kernel_args, on_cpu, read_launch_note
from nfdpf_torch.ops.sinkhorn import diameter, max_min
from nfdpf_torch.parallel.mesh import (
    DATA_AXIS,
    PARTICLE_AXIS,
    Mesh,
    agree,
    all_gather,
    axis_index,
    axis_size,
    gather_into,
    pmax,
)
from nfdpf_torch.utils.profiling import span

# kernel launches since the last reset, by kernel; "streaming_resample" and
# "sharded_resample" count the calls on the card of the drivers K3 and K6,
# which launch K1, the update and K2
LAUNCHES = {"sinkhorn_lse": 0, "sinkhorn_update": 0, "transport_apply": 0,
            "transport_apply_bwd": 0, "streaming_resample": 0, "sharded_resample": 0}

# Sinkhorn iterations between two host reads of the loop's stop flag: on the
# card LOOP_CHUNK × (K1, update) are one CUDA-graph replay.  A replay after
# the loop has stopped runs its iterations frozen (K1 launches, the update
# writes nothing), and above LOOP_CHUNK_MAX_N particles a frozen K1 costs
# more than the host read it saves (0.53 ms at B=4, N=10,240 on an H100), so
# there a replay holds one iteration.  From timing chunks of 1-16 at (32,
# 100), (10, 100), (4, 4,097) and (4, 10,240) on an H100 (PERF.md §6).
LOOP_CHUNK = 8
LOOP_CHUNK_MAX_N = 1024

# the update kernels' plan: up to UPDATE_BATCH_ROWS rows of up to
# UPDATE_BATCH_COLS columns in one block (up to UPDATE_ONE_BLOCK_ROWS rows)
# or one cluster of up to UPDATE_CLUSTER blocks of about
# UPDATE_CLUSTER_ROWS rows, a warp a row; else blocks of at
# most UPDATE_THREADS threads, a thread a column per pass, a row of more
# columns split into pieces of UPDATE_THREADS until the grid holds
# UPDATE_BLOCKS_PER_SM blocks per SM
UPDATE_BATCH_ROWS = 64
UPDATE_BATCH_COLS = 256
UPDATE_ONE_BLOCK_ROWS = 16
UPDATE_CLUSTER = 8
UPDATE_CLUSTER_ROWS = 4
UPDATE_THREADS = 256
UPDATE_BLOCKS_PER_SM = 2
H100_SMS = 132

# the streaming loop (K3's, card or CPU) since the last reset: firings,
# iterations (the raw count) and host reads of its stop test
STREAMING_LOOP = {"calls": 0, "iters": 0, "host_reads": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "nfdpf_sinkhorn_lse": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "nfdpf_transport_apply": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "nfdpf_sinkhorn_update": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _F, _F, _F, _I, _I, _I, _P],
    "nfdpf_empty_launch": [_I, _I, _P],
    "nfdpf_sinkhorn_launch_note": [_P, _P, _I],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reset_streaming_loop() -> None:
    for k in STREAMING_LOOP:
        STREAMING_LOOP[k] = 0


def _library():
    from nfdpf_torch.ops.cuda.build import load

    return load("sinkhorn", _SIGNATURES)


def update_launch_note() -> dict:
    """The update kernel's last launch: ``read_launch_note``'s record."""
    return read_launch_note(_library().nfdpf_sinkhorn_launch_note)


def empty_launch(blocks: int = 1, threads: int = 32) -> None:
    """Launch a kernel that returns at once on the current CUDA stream, the
    way the wrappers below launch theirs: its device time is the floor under
    every kernel's.  Counted nowhere."""
    rc = _library().nfdpf_empty_launch(blocks, threads,
                                       torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "empty")


def _pair_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """½‖x_i − y_j‖² from coordinate differences, (B, N, M) — the kernels'
    own arithmetic (not the x²+y²−2xy expansion of ``sinkhorn.cost``)."""
    diff = x[:, :, None, :] - y[:, None, :, :]
    return 0.5 * torch.sum(diff * diff, dim=-1)


# ---------------------------------------------------------------------------
# K1: streaming logsumexp
# ---------------------------------------------------------------------------


def lse_multi_plain(eps: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    fs: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 over the materialised cost: (B,G,M) → (B,G,N)."""
    neg_cost = -_pair_cost(x, y) / eps[:, None, None]          # (B, N, M)
    return torch.logsumexp(fs[:, :, None, :] + neg_cost[:, None], dim=-1)


def streaming_lse_multi(eps: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                        fs: torch.Tensor) -> torch.Tensor:
    """out[b,g,i] = logsumexp_j(fs[b,g,j] − ‖x_i−y_j‖²/(2ε_b)).

    eps: (B,); x: (B, N, 2); y: (B, M, 2); fs: (B, G, M), G ∈ {1, 2} → (B, G, N).
    """
    b, n, d = x.shape
    g, m = fs.shape[1], fs.shape[2]
    if (d != 2 or y.shape != (b, m, 2) or fs.shape[0] != b
            or eps.shape != (b,) or n == 0 or m == 0):
        raise ValueError(f"bad shapes eps{tuple(eps.shape)} x{tuple(x.shape)} "
                         f"y{tuple(y.shape)} fs{tuple(fs.shape)}")
    if on_cpu(eps, x, y, fs):
        return lse_multi_plain(eps, x, y, fs)
    if g not in (1, 2) or b > 65535:
        raise ValueError(f"K1 takes G in (1, 2) and B <= 65535, got G={g}, B={b}")
    eps, x, y, fs = kernel_args(eps, x, y, fs)
    out = torch.empty((b, g, n), device=x.device, dtype=torch.float32)
    _launch_lse(eps, x, y, fs, out)
    LAUNCHES["sinkhorn_lse"] += 1
    return out


def _launch_lse(eps, x, y, fs, out) -> None:
    """K1 on float32 CUDA tensors that are contiguous and checked, into
    ``out``; the callers count the launch."""
    b, n, _ = x.shape
    rc = _library().nfdpf_sinkhorn_lse(
        eps.data_ptr(), x.data_ptr(), y.data_ptr(), fs.data_ptr(), out.data_ptr(),
        b, n, y.shape[1], fs.shape[1], torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(rc, "sinkhorn_lse")


def streaming_lse(eps, x, y, f) -> torch.Tensor:
    """Single-potential wrapper: (B, M) → (B, N)."""
    return streaming_lse_multi(eps, x, y, f[:, None, :])[:, 0]


def streaming_softmin(eps, x, y, f) -> torch.Tensor:
    """−ε·logsumexp(f − C/ε): the Sinkhorn softmin."""
    return -eps[:, None] * streaming_lse(eps, x, y, f)


def streaming_softmin_multi(eps, x, y, fs) -> torch.Tensor:
    """Fused G-potential softmin: fs (B, G, M) → (B, G, N)."""
    return -eps[:, None, None] * streaming_lse_multi(eps, x, y, fs)


# ---------------------------------------------------------------------------
# K2: streaming transport apply
# ---------------------------------------------------------------------------


def transport_apply_plain(values, eps, x_rows, y_cols, r, c) -> torch.Tensor:
    """Plain version of K2: ``einsum("bij,bjd->bid", T, values)`` over the
    materialised T_ij = exp(r_i + c_j − C_ij/ε).  Differentiable in every
    input by ordinary autograd."""
    t = torch.exp(r[:, :, None] + c[:, None, :]
                  - _pair_cost(x_rows, y_cols) / eps[:, None, None])
    return torch.einsum("bij,bjd->bid", t, values)


def _apply(eps, x_rows, y_cols, values, r, c, counter: str) -> torch.Tensor:
    b, n, d = x_rows.shape
    m = y_cols.shape[1]
    if (d != 2 or y_cols.shape != (b, m, 2) or values.shape != (b, m, 2)
            or r.shape != (b, n) or c.shape != (b, m) or eps.shape != (b,)
            or n == 0 or m == 0):
        raise ValueError(
            f"bad shapes eps{tuple(eps.shape)} x{tuple(x_rows.shape)} "
            f"y{tuple(y_cols.shape)} v{tuple(values.shape)} r{tuple(r.shape)} "
            f"c{tuple(c.shape)}")
    if on_cpu(eps, x_rows, y_cols, values, r, c):
        return transport_apply_plain(values, eps, x_rows, y_cols, r, c)
    if b > 65535:
        raise ValueError(f"K2 takes B <= 65535, got {b}")
    eps, x_rows, y_cols, values, r, c = kernel_args(eps, x_rows, y_cols, values, r, c)
    out = torch.empty((b, n, 2), device=x_rows.device, dtype=torch.float32)
    rc = _library().nfdpf_transport_apply(
        eps.data_ptr(), x_rows.data_ptr(), y_cols.data_ptr(), values.data_ptr(),
        r.data_ptr(), c.data_ptr(), out.data_ptr(), b, n, m,
        torch.cuda.current_stream(x_rows.device).cuda_stream)
    check_launch(rc, counter)
    LAUNCHES[counter] += 1
    return out


class TransportApplyRC(torch.autograd.Function):
    """out = T @ values, differentiable in ``values`` only (grad = Tᵀg):
    the transport plan is a constant, as in the original resampler."""

    @staticmethod
    def forward(ctx, values, eps, x_rows, y_cols, r, c):
        ctx.save_for_backward(eps, x_rows, y_cols, r, c)
        return _apply(eps, x_rows, y_cols, values, r, c, "transport_apply")

    @staticmethod
    def backward(ctx, g):
        eps, x_rows, y_cols, r, c = ctx.saved_tensors
        # (Tᵀg)_j = Σ_i exp(c_j + r_i − C_ij/ε) g_i: same kernel, roles swapped
        grad_values = _apply(eps, y_cols, x_rows, g, c, r, "transport_apply_bwd")
        return grad_values, None, None, None, None, None


def transport_apply_rc(values, eps, x_rows, y_cols, r, c) -> torch.Tensor:
    """T @ values with implicit T_ij = exp(r_i + c_j − ½‖x_i − y_j‖²/ε),
    separate row and column point sets; gradient to ``values`` only."""
    return TransportApplyRC.apply(values, eps, x_rows, y_cols, r, c)


def streaming_transport_apply(values, eps, scaled_x, r, c) -> torch.Tensor:
    """Self-transport wrapper (rows = columns = scaled_x)."""
    return transport_apply_rc(values, eps, scaled_x, scaled_x, r, c)


# ---------------------------------------------------------------------------
# the resampler
# ---------------------------------------------------------------------------


def loop_chunk(n: int) -> int:
    """Iterations per host read of the stop flag for N = ``n`` particles."""
    return LOOP_CHUNK if n <= LOOP_CHUNK_MAX_N else 1


def _k1_input(logw, uniform_logw, a_y, b_x, eps_run) -> torch.Tensor:
    """K1's input for the loop's next iteration, (B, 2, N)."""
    eps_col = eps_run[:, None]
    return torch.stack([logw + b_x / eps_col, uniform_logw + a_y / eps_col], dim=1)


def update_plan(b: int, n: int, sms: int = H100_SMS) -> dict:
    """How the update kernels cover a (``b``, ``n``) batch on a card of
    ``sms`` SMs.  With ``batch`` (at most ``UPDATE_BATCH_ROWS`` rows of at
    most ``UPDATE_BATCH_COLS`` columns): one block of a warp a row (up to
    ``UPDATE_ONE_BLOCK_ROWS`` rows), else one cluster of ``blocks`` blocks
    (a power of two, at most ``UPDATE_CLUSTER``, about
    ``UPDATE_CLUSTER_ROWS`` rows a block) of ``rows_a_block`` warps, warp w
    of block k taking row k·rows_a_block + w, lane l its columns l + 32·j
    for j < ``cols_per_lane``.  Else ``splits`` blocks a row (grid
    b·splits, block row·splits + piece), each of ``threads`` threads over
    ``cols`` consecutive columns: a row of at most ``UPDATE_THREADS``
    columns is one block of whole warps; a longer one is cut into pieces of
    ``UPDATE_THREADS`` columns, as many as the grid needs to reach
    ``UPDATE_BLOCKS_PER_SM`` blocks per SM (more columns a piece beyond
    that)."""
    if b <= UPDATE_BATCH_ROWS and n <= UPDATE_BATCH_COLS:
        lanes = -(-n // 32)
        blocks = (1 if b <= UPDATE_ONE_BLOCK_ROWS else
                  min(UPDATE_CLUSTER, 1 << (-(-b // UPDATE_CLUSTER_ROWS) - 1).bit_length()))
        rows = -(-b // blocks)
        return {"batch": True, "blocks": blocks, "rows_a_block": rows, "threads": 32 * rows,
                "grid": blocks, "cols_per_lane": next(k for k in (1, 2, 4, 8) if k >= lanes)}
    if n <= UPDATE_THREADS:
        return {"batch": False, "splits": 1, "cols": n, "threads": -(-n // 32) * 32, "grid": b}
    want = max(1, -(-UPDATE_BLOCKS_PER_SM * sms // b))
    splits = min(-(-n // UPDATE_THREADS), want)
    cols = -(-n // splits)
    cols = -(-cols // 32) * 32
    splits = -(-n // cols)
    return {"batch": False, "splits": splits, "cols": cols, "threads": UPDATE_THREADS,
            "grid": b * splits}


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def sinkhorn_update_plain(lse, a_y, b_x, running, eps_run, eps_target, logw, uniform_logw,
                          threshold: float, scaling_factor: float):
    """Plain version of the update kernel: the rest of one Sinkhorn iteration
    after K1, whose logsumexps ``lse`` (B, 2, N) were taken of
    ``_k1_input(...)`` at ``eps_run``.  Returns the new (a_y, b_x, running,
    eps_run) and the next iteration's K1 input (B, 2, N)."""
    outs = -eps_run[:, None, None] * lse
    run = running[:, None]
    at_y = torch.where(run, outs[:, 0], a_y)
    bt_x = torch.where(run, outs[:, 1], b_x)
    a_y_new, b_x_new = (a_y + at_y) / 2, (b_x + bt_x) / 2
    a_diff = torch.amax(torch.abs(a_y_new - a_y), dim=1)
    b_diff = torch.amax(torch.abs(b_x_new - b_x), dim=1)
    local = (a_diff > threshold) | (b_diff > threshold)
    new_eps = torch.maximum(eps_run * scaling_factor, eps_target)
    running = (new_eps < eps_run) | local
    return (a_y_new, b_x_new, running, new_eps,
            _k1_input(logw, uniform_logw, a_y_new, b_x_new, new_eps))


class _Loop:
    """The Sinkhorn loop's state in buffers of fixed address, (B, N) on one
    device, in the inputs' dtype (float32 on the card): the scaled particles, log-weights, ε target and running ε, the
    potentials (a_y, b_x), the running flags, K1's input ``fs`` and output
    ``lse`` (B, 2, N), ``state`` (done, iterations, the batch's
    aggregate of the running flags, the update's arrival count) and
    ``row_max`` (the update kernel's per-row maxima, 2 a row, 0 between
    launches).  On the card a chunk of iterations is a CUDA graph over these
    buffers, captured
    at the first chunk and replayed after; on the CPU the same chunk runs
    on the plain versions."""

    def __init__(self, b: int, n: int, device, params, dtype=torch.float32):
        like = dict(dtype=dtype, device=device)
        self.x = torch.zeros(b, n, 2, **like)
        self.logw = torch.zeros(b, n, **like)
        self.uniform = torch.full((b, n), -math.log(n), **like)
        self.eps_target = torch.zeros(b, **like)
        self.eps_run = torch.zeros(b, **like)
        self.a_y = torch.zeros(b, n, **like)
        self.b_x = torch.zeros(b, n, **like)
        self.running = torch.ones(b, dtype=torch.bool, device=device)
        self.fs = torch.zeros(b, 2, n, **like)
        self.lse = torch.zeros(b, 2, n, **like)
        self.state = torch.zeros(4, dtype=torch.int32, device=device)
        self.row_max = torch.zeros(2 * b, dtype=torch.int32, device=device)
        self.plan = update_plan(b, n, _sm_count(device) if self.x.is_cuda else H100_SMS)
        # (threshold, scaling², max_iter, convergence): kernel arguments a
        # graph keeps
        self.params = params
        self.graph = None

    def load(self, x, logw, eps_target, eps_run, a_y, b_x) -> None:
        """A firing's inputs into the buffers; the loop state reset."""
        for dst, src in ((self.x, x), (self.logw, logw), (self.eps_target, eps_target),
                         (self.eps_run, eps_run), (self.a_y, a_y), (self.b_x, b_x)):
            dst.copy_(src)
        self.running.fill_(True)
        self.state.zero_()
        self.fs.copy_(_k1_input(logw, self.uniform, a_y, b_x, eps_run))

    def iteration(self, freeze: bool) -> None:
        """K1, then the update (neither counted here)."""
        if self.x.is_cuda:
            _launch_lse(self.eps_run, self.x, self.x, self.fs, self.lse)
        else:
            self.lse.copy_(lse_multi_plain(self.eps_run, self.x, self.x, self.fs))
        self.update(freeze)

    def update(self, freeze: bool) -> None:
        """The rest of the iteration from K1's output in ``lse``: the update
        kernel on the card, its plain version on the CPU.  With ``freeze`` it
        leaves the state as it is once the done flag is set."""
        threshold, scaling_factor, max_iter, convergence = self.params
        if self.x.is_cuda:
            b, n = self.logw.shape
            plan = self.plan
            # the batch kernel takes its cluster's blocks and rows a block
            # where the other takes its pieces and columns a piece
            pieces, width = ((plan["blocks"], plan["rows_a_block"]) if plan["batch"]
                             else (plan["splits"], plan["cols"]))
            rc = _library().nfdpf_sinkhorn_update(
                self.lse.data_ptr(), self.a_y.data_ptr(), self.b_x.data_ptr(),
                self.running.data_ptr(), self.eps_run.data_ptr(), self.eps_target.data_ptr(),
                self.logw.data_ptr(), self.fs.data_ptr(), self.state.data_ptr(),
                self.row_max.data_ptr(), b, n, int(plan["batch"]), pieces, width, plan["threads"],
                -math.log(n), threshold, scaling_factor, max_iter, int(convergence == "any"),
                int(freeze), torch.cuda.current_stream(self.x.device).cuda_stream)
            check_launch(rc, "sinkhorn_update")
            return
        if freeze and bool(self.state[0]):
            return
        new = sinkhorn_update_plain(self.lse, self.a_y, self.b_x, self.running, self.eps_run,
                                    self.eps_target, self.logw, self.uniform, threshold,
                                    scaling_factor)
        for dst, src in zip((self.a_y, self.b_x, self.running, self.eps_run, self.fs), new):
            dst.copy_(src)
        agg = bool(torch.all(new[2]) if convergence == "all" else torch.any(new[2]))
        it = int(self.state[1]) + 1
        self.state[:3] = torch.tensor([int(not (it < max_iter - 1 and agg)), it, int(agg)])

    def chunk(self, k: int) -> None:
        """k iterations, frozen once done: one graph replay on the card."""
        if not self.x.is_cuda:
            for _ in range(k):
                self.iteration(freeze=True)
            return
        if self.graph is None:
            self._capture(k)
        self.graph.replay()
        LAUNCHES["sinkhorn_lse"] += k
        LAUNCHES["sinkhorn_update"] += k

    def _capture(self, k: int) -> None:
        """Capture k iterations in a CUDA graph, after one warm-up chunk on
        a side stream (which loads the kernels; the caller loads the firing
        again).  Under no_grad, never inside a replay."""
        dev = self.x.device
        with torch.no_grad(), span("ot.capture"):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(k):
                    self.iteration(freeze=True)
            torch.cuda.current_stream(dev).wait_stream(side)
            LAUNCHES["sinkhorn_lse"] += k
            LAUNCHES["sinkhorn_update"] += k
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                for _ in range(k):
                    self.iteration(freeze=True)
        self.graph = graph


class _ShardedLoop(_Loop):
    """K6's loop: ``_Loop``'s buffers over all N particles, the same bits on
    every rank of the particle group, and this rank's N/P rows ``rows``
    (B, N/P, 2).  An iteration is K1 on those rows against all N columns
    into ``lse_rows`` (B, 2, N/P), one all-gather of that block into
    ``lse_ranks`` (P, B, 2, N/P), one copy into ``lse`` (B, 2, N), and the
    update over all N.  Every rank then holds the potentials, maxima, ε,
    flags and done flag that K3's update makes from the same ``lse``, so
    the stop test needs no collective.  Never captured in a CUDA graph (the
    all-gather is a host call under gloo)."""

    def __init__(self, b: int, n: int, device, params, dtype, mesh: Mesh):
        super().__init__(b, n, device, params, dtype)
        shards = axis_size(mesh, PARTICLE_AXIS)
        rows = n // shards
        like = dict(dtype=dtype, device=device)
        self.mesh = mesh
        self.lo = axis_index(mesh, PARTICLE_AXIS) * rows
        self.rows = torch.zeros(b, rows, 2, **like)
        self.lse_rows = torch.zeros(b, 2, rows, **like)
        self.lse_ranks = torch.zeros(shards, b, 2, rows, **like)

    def load(self, x, logw, eps_target, eps_run, a_y, b_x) -> None:
        super().load(x, logw, eps_target, eps_run, a_y, b_x)
        self.rows.copy_(x[:, self.lo:self.lo + self.rows.shape[1]])

    def iteration(self, freeze: bool) -> None:
        """K1 on this rank's rows, the all-gather, then the update (no
        launch counted here)."""
        if self.x.is_cuda:
            _launch_lse(self.eps_run, self.rows, self.x, self.fs, self.lse_rows)
        else:
            self.lse_rows.copy_(lse_multi_plain(self.eps_run, self.rows, self.x, self.fs))
        gather_into(self.lse_ranks, self.lse_rows, self.mesh, PARTICLE_AXIS)
        shards, b, _, rows = self.lse_ranks.shape
        self.lse.view(b, 2, shards, rows).copy_(self.lse_ranks.permute(1, 2, 0, 3))
        self.update(freeze)

    def chunk(self, k: int) -> None:
        """k iterations, frozen once done, launched one by one."""
        for _ in range(k):
            self.iteration(freeze=True)
        if self.x.is_cuda:
            LAUNCHES["sinkhorn_lse"] += k
            LAUNCHES["sinkhorn_update"] += k


# one loop (and its graph) per (device, B, N, chunk, loop constants)
_LOOPS: dict = {}


def _iterate(loop: _Loop, k: int, max_iter: int, convergence: str, mesh) -> int:
    """Run a loaded ``loop`` until it stops; returns the raw iteration
    count.  ``k`` iterations (``chunk``) between two host reads of the done
    flag.  With a data axis of several ranks the stop test is taken on the
    host over the data group after every iteration (a collective a graph
    cannot hold); the update then never freezes, so each rank's state
    follows the group's decision."""
    if axis_size(mesh, DATA_AXIS) == 1:
        while True:
            with span("ot.replay"):
                loop.chunk(k)
            with span("ot.stop_read"):
                done, i = loop.state[:2].tolist()        # the one host read of a chunk
            STREAMING_LOOP["host_reads"] += 1
            if done:
                return i
    i = 0
    while True:
        with span("ot.replay"):
            loop.iteration(freeze=False)
        if loop.x.is_cuda:
            LAUNCHES["sinkhorn_lse"] += 1
            LAUNCHES["sinkhorn_update"] += 1
        i += 1
        if not i < max_iter - 1:
            return i
        STREAMING_LOOP["host_reads"] += 1
        with span("ot.stop_read"):
            running = agree(loop.state[2] != 0, mesh, DATA_AXIS, convergence)
        if not running:
            return i


def _run_loop(scaled_x, logw, eps_target, eps_run, a_y, b_x, threshold, scaling_factor,
              max_iter, convergence, mesh):
    """The annealed loop from (a_y, b_x) at ``eps_run``: (a_y, b_x, the raw
    iteration count).  Without a data axis the loop of a shape is kept,
    with its CUDA graph of ``loop_chunk(N)`` iterations on the card."""
    b, n = logw.shape
    dev = scaled_x.device
    params = (float(threshold), float(scaling_factor), int(max_iter), convergence)
    STREAMING_LOOP["calls"] += 1
    if max_iter <= 1:
        return a_y, b_x, 0
    inputs = (scaled_x, logw, eps_target, eps_run, a_y, b_x)
    k = loop_chunk(n)
    cached = dev.type == "cuda" and axis_size(mesh, DATA_AXIS) == 1
    key = (dev, b, n, k, params)
    loop = _LOOPS.get(key) if cached else None
    if loop is None:
        loop = _Loop(b, n, dev, params, logw.dtype)
        if cached:
            _LOOPS[key] = loop
    with span("ot.loop"):
        loop.load(*inputs)
        if cached and loop.graph is None:
            loop._capture(k)
            loop.load(*inputs)
        i = _iterate(loop, k, max_iter, convergence, mesh)
    STREAMING_LOOP["iters"] += i
    return loop.a_y.clone(), loop.b_x.clone(), i


def _eager_loop(scaled_x, logw, uniform_logw, eps_target, eps_run, a_y, b_x, threshold,
                scaling_factor, max_iter, convergence, mesh):
    """The loop of the driver's plain version: one iteration at a time on the
    plain K1 and update, the stop test read on the host before each."""
    running = torch.ones(logw.shape[0], dtype=torch.bool, device=logw.device)
    agg = torch.all if convergence == "all" else torch.any
    STREAMING_LOOP["calls"] += 1
    i = 0
    while i < max_iter - 1:
        STREAMING_LOOP["host_reads"] += 1
        if not agree(agg(running), mesh, DATA_AXIS, convergence):
            break
        lse = lse_multi_plain(eps_run, scaled_x, scaled_x,
                              _k1_input(logw, uniform_logw, a_y, b_x, eps_run))
        a_y, b_x, running, eps_run, _ = sinkhorn_update_plain(
            lse, a_y, b_x, running, eps_run, eps_target, logw, uniform_logw, threshold,
            scaling_factor)
        i += 1
    STREAMING_LOOP["iters"] += i
    return a_y, b_x, i


def ot_resample_streaming(
    particles: torch.Tensor,
    probs: torch.Tensor,
    eps: float = 0.1,
    scaling: float = 0.75,
    threshold: float = 1e-3,
    max_iter: int = 100,
    convergence: str = "all",
    warm_start: Optional[Tuple[torch.Tensor, bool]] = None,
    warm_eps_factor: float = 16.0,
    return_potentials: bool = False,
    mesh: Optional[Mesh] = None,
):
    """ε-annealed OT resampling on the streaming kernels.

    The whole Sinkhorn loop runs on detached inputs; the gradient reaches
    ``particles`` only through the values operand of T @ particles, and
    ``probs`` gets none.  Returns ``(particles', uniform probs, identity
    indices, iters)`` with ``iters`` the raw loop count (a host int), and
    with ``return_potentials`` the loop's final (a_y, b_x) as a fifth item,
    (B, 2, N).

    ``warm_start=(potentials, valid)``: with ``valid`` (a host bool) the loop
    starts from the (B, 2, N) ``potentials`` of the previous firing instead
    of the cold softmin, and anneals only a short tail, from
    max(min(ε₀, ``warm_eps_factor``·ε), ε) per row; without it the start is
    cold.  Only the iteration count can change: the loop is detached.

    The loop runs ``loop_chunk(N)`` iterations between two host reads of its
    stop flag: on the card one replay of a CUDA graph of (K1, update) pairs
    (captured at the first call of a shape), on the CPU the same chunk on
    the plain versions.  The update freezes the state on the loop's own last
    iteration, so the potentials and ``iters`` are those of a loop that
    tests after every iteration.  With a ``mesh`` whose data axis shards the
    batch, the test is taken over the whole batch (an all-reduce over the
    data group, JAX's ``axis_name``) after every iteration, so every data
    rank runs the unsharded batch's iterations.
    """
    if not on_cpu(particles, probs):
        LAUNCHES["streaming_resample"] += 1
    return _ot_resample(particles, probs, eps, scaling, threshold, max_iter, convergence,
                        warm_start, warm_eps_factor, return_potentials, mesh, plain=False)


def ot_resample_streaming_plain(
    particles: torch.Tensor,
    probs: torch.Tensor,
    eps: float = 0.1,
    scaling: float = 0.75,
    threshold: float = 1e-3,
    max_iter: int = 100,
    convergence: str = "all",
    warm_start: Optional[Tuple[torch.Tensor, bool]] = None,
    warm_eps_factor: float = 16.0,
    return_potentials: bool = False,
    mesh: Optional[Mesh] = None,
):
    """Plain version of ``ot_resample_streaming``: the same function on
    every kernel's plain version (K1, K2, the update), one iteration at a
    time with the stop test read on the host before each, on any device.
    On the CPU it is ``ot_resample_streaming`` bit for bit."""
    return _ot_resample(particles, probs, eps, scaling, threshold, max_iter, convergence,
                        warm_start, warm_eps_factor, return_potentials, mesh, plain=True)


def _ot_resample(particles, probs, eps, scaling, threshold, max_iter, convergence,
                 warm_start, warm_eps_factor, return_potentials, mesh, plain: bool):
    if convergence not in ("all", "any"):
        raise ValueError(f"convergence must be 'all' or 'any', got {convergence!r}")
    b, n, d = particles.shape
    dev = particles.device
    x_sg = particles.detach()
    logw_sg = torch.log(probs.detach())
    centered = x_sg - torch.mean(x_sg, dim=1, keepdim=True)
    diam = diameter(x_sg, x_sg)
    scaled_x = centered / (diam[:, None, None] * math.sqrt(d))
    uniform_logw = torch.full_like(logw_sg, -math.log(n))

    # a device fill, not a host→device copy (which would sync each firing)
    eps_b = torch.full((b,), eps, dtype=torch.float32, device=dev)
    scaling_factor = scaling**2
    lse = lse_multi_plain if plain else streaming_lse_multi

    def sm2(e, fvecs):
        return -e[:, None, None] * lse(e, scaled_x, scaled_x, fvecs)

    # Only (a_y, b_x) are live: the self-transport (a_x, b_y) of the
    # symmetric loop never feed them, the stopping test or the plan.
    eps_run = max_min(scaled_x, scaled_x) ** 2
    if warm_start is not None and warm_start[1]:
        # a warm firing skips the cold softmin pass altogether
        potentials = warm_start[0].detach()
        if potentials.shape != (b, 2, n):
            raise ValueError(f"warm-start potentials {tuple(potentials.shape)}, "
                             f"expected {(b, 2, n)}")
        a_y, b_x = potentials[:, 0], potentials[:, 1]
        eps_run = torch.maximum(torch.minimum(eps_run, eps_b * warm_eps_factor), eps_b)
    else:
        init = sm2(eps_run, torch.stack([logw_sg, uniform_logw], dim=1))
        a_y, b_x = init[:, 0], init[:, 1]

    if plain:
        a_y, b_x, i = _eager_loop(scaled_x, logw_sg, uniform_logw, eps_b, eps_run, a_y, b_x,
                                  threshold, scaling_factor, max_iter, convergence, mesh)
    else:
        a_y, b_x, i = _run_loop(scaled_x, logw_sg, eps_b, eps_run, a_y, b_x, threshold,
                                scaling_factor, max_iter, convergence, mesh)

    finals = sm2(eps_b, torch.stack([logw_sg + b_x / eps_b[:, None],
                                     uniform_logw + a_y / eps_b[:, None]], dim=1))
    final_f, final_g = finals[:, 0], finals[:, 1]

    # T_ij = exp((f_i + g_j − C_ij)/ε − colnorm_j + log n + logw_j), with
    # colnorm_j = g_j/ε + logsumexp_i(f_i/ε − C_ij/ε) since C is symmetric
    lse_col = lse(eps_b, scaled_x, scaled_x, (final_f / eps_b[:, None])[:, None])[:, 0]
    colnorm = final_g / eps_b[:, None] + lse_col
    r = final_f / eps_b[:, None]
    c = final_g / eps_b[:, None] - colnorm + math.log(n) + logw_sg

    # T is applied to the RAW particles; the geometry stays scaled
    if plain:
        transported = transport_apply_plain(particles, eps_b, scaled_x, scaled_x, r, c)
    else:
        transported = streaming_transport_apply(particles, eps_b, scaled_x, r, c)
    uniform = torch.full_like(probs, 1.0 / n)
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    if return_potentials:
        return transported, uniform, idx, i, torch.stack([a_y, b_x], dim=1)
    return transported, uniform, idx, i


# ---------------------------------------------------------------------------
# K6: the resampler with the particle axis sharded over ranks
# ---------------------------------------------------------------------------


def ot_resample_streaming_sharded(
    particles: torch.Tensor,
    probs: torch.Tensor,
    mesh: Mesh,
    eps: float = 0.1,
    scaling: float = 0.75,
    threshold: float = 1e-3,
    max_iter: int = 100,
    convergence: str = "all",
    warm_start: Optional[Tuple[torch.Tensor, bool]] = None,
    warm_eps_factor: float = 16.0,
    return_potentials: bool = False,
):
    """``ot_resample_streaming`` with the particle axis sharded over the
    particle group of ``mesh``: ``particles`` (B, N/P, 2) and ``probs``
    (B, N/P) are this rank's block of the N particles.

    The (B, N, N) cost never exists anywhere; what crosses between ranks is
    O(N·d) per iteration:

    * the detached coordinates and log-weights are all-gathered once, and
      the global scaling built from them; each rank runs K1 on its N/P rows
      against all N columns;
    * the start's row potentials (the cold softmin's or the warm carry) are
      all-gathered once into (B, N) potentials that every rank holds;
    * each iteration all-gathers K1's (B, 2, N/P) logsumexps into the
      (B, 2, N) that K3's K1 makes, and every rank runs K3's update kernel
      over all N: the same potentials, max|Δ| over all N, ε and stop flag
      on every rank, so the iteration count (and the numerics) are the
      unsharded call's, with no other collective; with a data axis the
      stop test is also taken over the data group (one all-reduce an
      iteration, as K3);
    * the loop reads its done flag on the host every ``loop_chunk(N)``
      iterations, as K3 does (no CUDA graph: the gather is a host call);
    * the column normaliser comes from the gathered final ``f`` (the cost is
      symmetric, so rows and columns swap roles);
    * K2 applies the local rows of the plan to the RAW particles gathered
      differentiably: its backward is each rank's Tᵀg over its rows, summed
      over the group and sliced (the all-gather's adjoint).

    Returns ``(particles', uniform probs, global ancestor indices, iters)``
    and, with ``return_potentials``, this rank's rows of (a_y, b_x),
    (B, 2, N/P), the warm start's carry.
    """
    if not on_cpu(particles, probs):
        LAUNCHES["sharded_resample"] += 1
    return _ot_resample_sharded(particles, probs, mesh, eps, scaling, threshold, max_iter,
                                convergence, warm_start, warm_eps_factor, return_potentials,
                                plain=False)


def ot_resample_streaming_sharded_plain(
    particles: torch.Tensor,
    probs: torch.Tensor,
    mesh: Mesh,
    eps: float = 0.1,
    scaling: float = 0.75,
    threshold: float = 1e-3,
    max_iter: int = 100,
    convergence: str = "all",
    warm_start: Optional[Tuple[torch.Tensor, bool]] = None,
    warm_eps_factor: float = 16.0,
    return_potentials: bool = False,
):
    """Plain version of ``ot_resample_streaming_sharded``, the JAX body's
    order on every kernel's plain version (K1, K2, the update), on any
    device: each iteration all-gathers the row potentials, runs the plain
    K1 on the local rows and the eager update on them, and takes max|Δ|
    over the particle group (an all-reduce), with the stop test read on the
    host before each iteration; the potentials are gathered once more after
    the loop.  On the CPU it is ``ot_resample_streaming_sharded`` bit for
    bit."""
    return _ot_resample_sharded(particles, probs, mesh, eps, scaling, threshold, max_iter,
                                convergence, warm_start, warm_eps_factor, return_potentials,
                                plain=True)


def _eager_sharded_loop(scaled_loc, scaled_all, logw_all, uniform_all, eps_target, eps_run,
                        a_y, b_x, threshold, scaling_factor, max_iter, convergence, mesh):
    """The loop of K6's plain version from this rank's row potentials:
    the gathered (a_y, b_x) over all N and the raw iteration count."""
    def gather(t):
        return all_gather(t, mesh, PARTICLE_AXIS, 2)

    running = torch.ones(logw_all.shape[0], dtype=torch.bool, device=logw_all.device)
    agg = torch.all if convergence == "all" else torch.any
    STREAMING_LOOP["calls"] += 1
    i = 0
    while i < max_iter - 1:
        STREAMING_LOOP["host_reads"] += 1
        if not agree(agg(running), mesh, DATA_AXIS, convergence):
            break
        pots = gather(torch.stack([a_y, b_x], dim=1))         # (B, 2, N)
        eps_col = eps_run[:, None]
        run = running[:, None]
        outs = -eps_run[:, None, None] * lse_multi_plain(
            eps_run, scaled_loc, scaled_all,
            torch.stack([logw_all + pots[:, 1] / eps_col, uniform_all + pots[:, 0] / eps_col],
                        dim=1))
        at_y = torch.where(run, outs[:, 0], a_y)
        bt_x = torch.where(run, outs[:, 1], b_x)
        a_y_new, b_x_new = (a_y + at_y) / 2, (b_x + bt_x) / 2
        # max|Δ| over the full potential vectors: local, then over the group
        diffs = pmax(torch.stack([torch.amax(torch.abs(a_y_new - a_y), dim=1),
                                  torch.amax(torch.abs(b_x_new - b_x), dim=1)]),
                     mesh, PARTICLE_AXIS)
        local = (diffs[0] > threshold) | (diffs[1] > threshold)
        new_eps = torch.maximum(eps_run * scaling_factor, eps_target)
        running = (new_eps < eps_run) | local
        a_y, b_x, eps_run = a_y_new, b_x_new, new_eps
        i += 1
    STREAMING_LOOP["iters"] += i
    pots = gather(torch.stack([a_y, b_x], dim=1))
    return pots[:, 0], pots[:, 1], i


def _sharded_loop(scaled_all, logw_all, eps_target, eps_run, a_y, b_x, threshold,
                  scaling_factor, max_iter, convergence, mesh):
    """K6's loop from this rank's row potentials (B, N/P): gathered once,
    then ``_ShardedLoop``'s iterations.  Returns (a_y, b_x) over all N and
    the raw iteration count."""
    b, n = logw_all.shape
    STREAMING_LOOP["calls"] += 1
    pots = all_gather(torch.stack([a_y, b_x], dim=1), mesh, PARTICLE_AXIS, 2)
    if max_iter <= 1:
        return pots[:, 0], pots[:, 1], 0
    params = (float(threshold), float(scaling_factor), int(max_iter), convergence)
    loop = _ShardedLoop(b, n, scaled_all.device, params, logw_all.dtype, mesh)
    with span("ot.loop"):
        loop.load(scaled_all, logw_all, eps_target, eps_run, pots[:, 0], pots[:, 1])
        i = _iterate(loop, loop_chunk(n), max_iter, convergence, mesh)
    STREAMING_LOOP["iters"] += i
    return loop.a_y, loop.b_x, i


def _ot_resample_sharded(particles, probs, mesh, eps, scaling, threshold, max_iter,
                         convergence, warm_start, warm_eps_factor, return_potentials,
                         plain: bool):
    if convergence not in ("all", "any"):
        raise ValueError(f"convergence must be 'all' or 'any', got {convergence!r}")
    b, n_loc, d = particles.shape
    n = n_loc * axis_size(mesh, PARTICLE_AXIS)
    lo = axis_index(mesh, PARTICLE_AXIS) * n_loc
    dev = particles.device

    def gather(t, dim):
        return all_gather(t, mesh, PARTICLE_AXIS, dim)

    # the detached global geometry, gathered once
    x_all = gather(particles.detach(), 1)                        # (B, N, d)
    logw_all = torch.log(gather(probs.detach(), 1))              # (B, N)
    centered = x_all - torch.mean(x_all, dim=1, keepdim=True)
    diam = diameter(x_all, x_all)
    scaled_all = centered / (diam[:, None, None] * math.sqrt(d))
    scaled_loc = scaled_all[:, lo:lo + n_loc]
    uniform_all = torch.full_like(logw_all, -math.log(n))

    eps_b = torch.full((b,), eps, dtype=torch.float32, device=dev)
    scaling_factor = scaling**2
    lse = lse_multi_plain if plain else streaming_lse_multi

    def sm2(e, fs_all):
        return -e[:, None, None] * lse(e, scaled_loc, scaled_all, fs_all)

    eps_run = max_min(scaled_all, scaled_all) ** 2
    if warm_start is not None and warm_start[1]:
        potentials = warm_start[0].detach()
        if potentials.shape != (b, 2, n_loc):
            raise ValueError(f"warm-start potentials {tuple(potentials.shape)}, "
                             f"expected this rank's rows {(b, 2, n_loc)}")
        a_y, b_x = potentials[:, 0], potentials[:, 1]
        eps_run = torch.maximum(torch.minimum(eps_run, eps_b * warm_eps_factor), eps_b)
    else:
        init = sm2(eps_run, torch.stack([logw_all, uniform_all], dim=1))
        a_y, b_x = init[:, 0], init[:, 1]                        # (B, N/P) rows

    if plain:
        a_y, b_x, i = _eager_sharded_loop(scaled_loc, scaled_all, logw_all, uniform_all, eps_b,
                                          eps_run, a_y, b_x, threshold, scaling_factor,
                                          max_iter, convergence, mesh)
    else:
        a_y, b_x, i = _sharded_loop(scaled_all, logw_all, eps_b, eps_run, a_y, b_x, threshold,
                                    scaling_factor, max_iter, convergence, mesh)

    # every rank holds (a_y, b_x) over all N
    finals = sm2(eps_b, torch.stack([logw_all + b_x / eps_b[:, None],
                                     uniform_all + a_y / eps_b[:, None]], dim=1))
    final_f, final_g = finals[:, 0], finals[:, 1]                # (B, N/P) rows

    # colnorm of the local columns needs every row: C is symmetric, so the
    # streaming lse over the gathered f swaps rows and columns for free
    f_all = gather(final_f, 1)
    lse_col = lse(eps_b, scaled_loc, scaled_all, (f_all / eps_b[:, None])[:, None])[:, 0]
    colnorm = final_g / eps_b[:, None] + lse_col
    r_loc = final_f / eps_b[:, None]
    logw_loc = torch.log(probs.detach())
    c_all = gather(final_g / eps_b[:, None] - colnorm + math.log(n) + logw_loc, 1)

    # the RAW particles, gathered differentiably
    values_all = gather(particles, 1)
    apply = transport_apply_plain if plain else transport_apply_rc
    transported = apply(values_all, eps_b, scaled_loc, scaled_all, r_loc, c_all)
    uniform = torch.full_like(probs, 1.0 / n)
    idx = (lo + torch.arange(n_loc, dtype=torch.int32, device=dev)).expand(b, n_loc)
    if return_potentials:
        return (transported, uniform, idx, i,
                torch.stack([a_y[:, lo:lo + n_loc], b_x[:, lo:lo + n_loc]], dim=1))
    return transported, uniform, idx, i
