"""The port's CUDA kernels (streaming Sinkhorn K1/K2, coupling chain K4/K5)
against their plain PyTorch versions, on a GPU.

Marked ``cuda``: each test skips where no CUDA device is present.  This
file imports no JAX, so it also runs where JAX is not installed; there,
skip the repository's conftest (which sets JAX up for the other tests):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from nfdpf_torch.ops.cuda import coupling_cuda as cc
from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and launch the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, n, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, n, 2, generator=gen) * 0.5
    v = torch.randn(b, n, 2, generator=gen) * 30
    r = torch.randn(b, n, generator=gen) * 0.1
    c = torch.randn(b, n, generator=gen) * 0.1 - math.log(n)
    probe = torch.randn(b, n, 2, generator=gen)
    return x, v, r, c, probe, gen


def _lse_plain_by_rows(eps, x, y, fs, rows=1024):
    """``lse_multi_plain`` a block of ``rows`` rows at a time: each row's
    logsumexp is its own, and the whole (B, G, N, M) matrix of a large shape
    would not fit."""
    return torch.cat([sc.lse_multi_plain(eps, x[:, i:i + rows], y, fs)
                      for i in range(0, x.shape[1], rows)], dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(32, 100), (4, 4097), (8, 10240)])
@pytest.mark.parametrize("groups", [1, 2])
def test_lse_kernel_matches_plain(cuda, b, n, groups):
    """K1 to rtol/atol 1e-5 at the filter's shape (one staged tile, a
    two-pass logsumexp), a ragged large one (33 tiles, running maxima) and
    the benchmark cell's (B=8, N=10,240: 80 tiles)."""
    x, _, _, _, _, gen = _inputs(b, n, b + n)
    fs = torch.randn(b, groups, n, generator=gen).to(cuda)
    x = x.to(cuda)
    eps = torch.linspace(0.1, 2.0, b).to(cuda)
    sc.reset_launches()
    got = sc.streaming_lse_multi(eps, x, x, fs)
    torch.cuda.synchronize()
    assert sc.LAUNCHES["sinkhorn_lse"] == 1
    torch.testing.assert_close(got, _lse_plain_by_rows(eps, x, x, fs), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(4, 100, 100), (2, 100, 37), (3, 50, 5000), (2, 4097, 4097)])
@pytest.mark.parametrize("groups", [1, 2])
def test_lse_kernel_where_most_terms_underflow(cuda, b, n, m, groups):
    """Points ~60 apart and a small ε, as the resampler's raw particles at
    its target ε would be: most of a row's terms lie below 2^-126 of its
    largest, which K1 flushes to zero (they are below the ulp of a sum
    holding 1).  K1 to rtol/atol 1e-5 all the same, on one tile and on
    many."""
    gen = torch.Generator().manual_seed(29 * b + n + m)
    x = (torch.randn(b, n, 2, generator=gen) * 20).to(cuda)
    y = x[:, :m].contiguous() if m <= n else (torch.randn(b, m, 2, generator=gen) * 20).to(cuda)
    fs = torch.randn(b, groups, m, generator=gen).to(cuda)
    eps = torch.linspace(0.01, 0.1, b).to(cuda)
    ref = _lse_plain_by_rows(eps, x, y, fs)
    # the share of terms more than 126 binades below their row's largest
    terms = torch.cat([fs[:, :, None, :] - sc._pair_cost(x[:, i:i + 1024], y)[:, None]
                       / eps[:, None, None, None] for i in range(0, n, 1024)], dim=2)
    below = terms - terms.amax(-1, keepdim=True) < -126 * math.log(2)
    assert float(below.double().mean()) > 0.9
    got = sc.streaming_lse_multi(eps, x, y, fs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(32, 100), (4, 4097)])
def test_apply_kernel_forward_and_backward_match_plain(cuda, b, n):
    """K2 forward and its VJP (the same kernel, roles swapped) to 1e-4
    relative to the output's scale."""
    x, v, r, c, probe, _ = (t.to(cuda) if torch.is_tensor(t) else t
                            for t in _inputs(b, n, 7 * b + n))
    eps = torch.linspace(0.1, 2.0, b).to(cuda)
    v = v.requires_grad_()
    sc.reset_launches()
    out = sc.transport_apply_rc(v, eps, x, x, r, c)
    ref = sc.transport_apply_plain(v, eps, x, x, r, c)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * float(ref.detach().abs().max()))
    (g_k,) = torch.autograd.grad(torch.sum(out * probe), [v])
    (g_p,) = torch.autograd.grad(torch.sum(ref * probe), [v])
    torch.cuda.synchronize()
    assert sc.LAUNCHES["transport_apply"] == 1 and sc.LAUNCHES["transport_apply_bwd"] == 1
    torch.testing.assert_close(g_k, g_p, rtol=1e-4, atol=1e-4 * float(g_p.abs().max()))


# (B, rows N, columns M) that the kernels' decomposition makes ragged: N != M,
# a single row or column, M around the 128-column tile and its multiples, N
# that no rows-per-warp count divides, one batch row with few rows against
# many columns (several warps then split the columns of a row group), and
# batches that do not fill the card
RAGGED = [(32, 100, 37), (4, 37, 4097), (2, 1, 100), (2, 100, 1), (1, 1, 1),
          (3, 50, 127), (3, 50, 128), (3, 50, 129), (3, 7, 257), (5, 1030, 513),
          (1, 700, 700), (1, 3, 5000), (1, 4097, 4097)]


def _ragged_inputs(b, n, m, seed, device):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, n, 2, generator=gen) * 0.5
    y = torch.randn(b, m, 2, generator=gen) * 0.5
    v = torch.randn(b, m, 2, generator=gen) * 30
    r = torch.randn(b, n, generator=gen) * 0.1
    c = torch.randn(b, m, generator=gen) * 0.1 - math.log(m)
    fs = torch.randn(b, 2, m, generator=gen)
    probe = torch.randn(b, n, 2, generator=gen)
    eps = torch.linspace(0.1, 2.0, b)
    return tuple(t.to(device) for t in (eps, x, y, v, r, c, fs, probe))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", RAGGED)
@pytest.mark.parametrize("groups", [1, 2])
def test_lse_kernel_ragged_shapes(cuda, b, n, m, groups):
    """K1 to rtol/atol 1e-5 where rows, columns and tiles do not line up."""
    eps, x, y, _, _, _, fs, _ = _ragged_inputs(b, n, m, 3 * b + n + m, cuda)
    fs = fs[:, :groups].contiguous()
    got = sc.streaming_lse_multi(eps, x, y, fs)
    torch.cuda.synchronize()
    assert got.shape == (b, groups, n)
    torch.testing.assert_close(got, sc.lse_multi_plain(eps, x, y, fs), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", RAGGED)
def test_apply_kernel_ragged_shapes(cuda, b, n, m):
    """K2 forward and its VJP (rows and columns swapped: the M columns become
    the rows) to 1e-4 relative to the output's scale."""
    eps, x, y, v, r, c, _, probe = _ragged_inputs(b, n, m, 5 * b + n + m, cuda)
    v = v.requires_grad_()
    out = sc.transport_apply_rc(v, eps, x, y, r, c)
    ref = sc.transport_apply_plain(v, eps, x, y, r, c)
    assert out.shape == (b, n, 2)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * float(ref.detach().abs().max()))
    (g_k,) = torch.autograd.grad(torch.sum(out * probe), [v])
    (g_p,) = torch.autograd.grad(torch.sum(ref * probe), [v])
    torch.cuda.synchronize()
    torch.testing.assert_close(g_k, g_p, rtol=1e-4, atol=1e-4 * float(g_p.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(4, 100, 100), (2, 40, 300), (1, 3, 5000)])
def test_lse_kernel_takes_minus_infinity(cuda, b, n, m):
    """Columns whose potential is −inf add nothing; a potential that is −inf
    everywhere gives −inf, not NaN (no inf − inf in the running maximum)."""
    eps, x, y, _, _, _, fs, _ = _ragged_inputs(b, n, m, 17, cuda)
    fs[:, :, 3] = -math.inf
    fs[:, 1, m // 2:] = -math.inf
    fs[0, 0] = -math.inf
    got = sc.streaming_lse_multi(eps, x, y, fs)
    ref = sc.lse_multi_plain(eps, x, y, fs)
    assert bool(torch.isneginf(got[0, 0]).all()) and not bool(torch.isnan(got).any())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(4, 100, 100), (2, 40, 300), (1, 3, 5000)])
def test_apply_kernel_takes_very_negative_rows_and_columns(cuda, b, n, m):
    """A row whose r is −1e30 comes out as exact zeros; a column whose c is
    −inf adds nothing."""
    eps, x, y, v, r, c, _, _ = _ragged_inputs(b, n, m, 19, cuda)
    r[:, n // 2] = -1e30
    c[:, 1] = -math.inf
    got = sc.transport_apply_rc(v, eps, x, y, r, c)
    ref = sc.transport_apply_plain(v, eps, x, y, r, c)
    assert float(got[:, n // 2].abs().max()) == 0.0 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(32, 100, 100), (4, 4097, 4097), (1, 700, 700)])
def test_sinkhorn_kernels_repeat_bitwise(cuda, b, n, m):
    """Every reduction has a fixed order (no float atomics): K1, K2 and K2's
    backward give the same bits on a second launch."""
    eps, x, y, v, r, c, fs, probe = _ragged_inputs(b, n, m, 23, cuda)

    def run():
        leaf = v.clone().requires_grad_()
        out = sc.transport_apply_rc(leaf, eps, x, y, r, c)
        (grad,) = torch.autograd.grad(out, [leaf], probe)
        return sc.streaming_lse_multi(eps, x, y, fs), out.detach(), grad

    for first, second in zip(run(), run()):
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("convergence", ["all", "any"])
@pytest.mark.parametrize("b,n", [(8, 100), (2, 4097)])
def test_ot_resample_matches_plain_driver_on_card(cuda, b, n, convergence):
    """The resampler on the kernels against its plain version on the card
    (the eager loop on torch's logsumexp): the same iteration count, the
    particles within rtol 1e-4 / atol 1e-3 (magnitude 60); at N=4,097 K1
    takes many tiles."""
    x, probs = _loop_inputs(b, n, 31 * b + n, cuda)
    got = sc.ot_resample_streaming(x, probs, convergence=convergence)
    plain = sc.ot_resample_streaming_plain(x, probs, convergence=convergence)
    assert got[3] == plain[3] > 0
    torch.testing.assert_close(got[0], plain[0], rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_ot_resample_on_kernels_matches_cpu(cuda):
    """The resampler on the kernels against the same on the CPU's plain
    versions: same iteration count, particles within atol 1e-3 (magnitude 60)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 100, 2, generator=gen) * 20
    probs = torch.softmax(torch.randn(8, 100, generator=gen), dim=-1)
    p_cpu, _, _, it_cpu = sc.ot_resample_streaming(x, probs)
    p_gpu, _, _, it_gpu = sc.ot_resample_streaming(x.to(cuda), probs.to(cuda))
    assert it_gpu == it_cpu > 0
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-5, atol=1e-3)


def _loop_inputs(b, n, seed, device):
    """A firing's loop inputs as the driver makes them, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, n, 2, generator=gen) * 20
    probs = torch.softmax(torch.randn(b, n, generator=gen), dim=-1)
    return x.to(device), probs.to(device)


UPDATE_SHAPES = [(32, 100), (4, 4097), (4, 10240), (65, 100)]


def _update_loop(cuda, b, n, convergence, state, seed):
    """A loop at (b, n) loaded as a firing would be, with K1 run on its
    input: ``state`` "stopped" (every third row's flag down, ε from 0.05 to
    3: some rows anneal, some do not), "running" (every row running and
    annealing, the filter's usual state) or "nan" (as "running", with a NaN
    in row 1's K1 output).  Returns the loop and the update's inputs."""
    gen = torch.Generator().manual_seed(seed)
    loop = sc._Loop(b, n, cuda, (1e-3, 0.75**2, 100, convergence))
    x = (torch.randn(b, n, 2, generator=gen) * 0.5).to(cuda)
    logw = torch.log_softmax(torch.randn(b, n, generator=gen), -1).to(cuda)
    eps_b = torch.full((b,), 0.1, device=cuda)
    eps_run = torch.linspace(0.05 if state == "stopped" else 0.2, 3.0, b).to(cuda)
    a_y, b_x = ((torch.randn(b, n, generator=gen) * 0.1).to(cuda) for _ in range(2))
    loop.load(x, logw, eps_b, eps_run, a_y, b_x)
    if state == "stopped":
        loop.running[::3] = False
    sc._launch_lse(loop.eps_run, loop.x, loop.x, loop.fs, loop.lse)
    if state == "nan":
        loop.lse[1, 0, n // 2] = float("nan")
    return loop, (loop.lse.clone(), a_y, b_x, loop.running.clone(), eps_run, eps_b, logw)


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["stopped", "running", "nan"])
@pytest.mark.parametrize("convergence", ["all", "any"])
@pytest.mark.parametrize("b,n", UPDATE_SHAPES)
def test_sinkhorn_update_kernel_matches_plain(cuda, b, n, convergence, state):
    """The fused update against its plain version (torch's own ops on the
    card) on the same K1 output: potentials, flags, ε and the next K1 input
    bit for bit (a NaN in K1's output too), the loop counter, the batch's
    all or any and the done flag set, and the arrival count and the
    per-row maxima back at 0."""
    loop, (lse, a_y, b_x, running, eps_run, eps_b, logw) = _update_loop(
        cuda, b, n, convergence, state, b + n)
    loop.update(freeze=True)
    torch.cuda.synchronize()
    ref = sc.sinkhorn_update_plain(lse, a_y, b_x, running, eps_run, eps_b, logw,
                                   loop.uniform, 1e-3, 0.75**2)
    for got, want in zip((loop.a_y, loop.b_x, loop.running, loop.eps_run, loop.fs), ref):
        if got.is_floating_point():     # a NaN where the plain version has one
            assert torch.equal(got.isnan(), want.isnan())
            got, want = torch.nan_to_num(got), torch.nan_to_num(want)
        assert torch.equal(got, want)
    if state == "nan":
        assert bool(loop.a_y[1].isnan().any())
    agg = int(bool(ref[2].all() if convergence == "all" else ref[2].any()))
    done, iters, agg_got, arrived = loop.state.tolist()
    assert (iters, agg_got, arrived) == (1, agg, 0) and done == 1 - agg
    assert not bool(loop.row_max.any())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", UPDATE_SHAPES)
def test_sinkhorn_update_kernel_freezes_and_repeats(cuda, b, n):
    """With ``freeze`` and the done flag set the update writes nothing; two
    launches on the same inputs, back to back with no synchronisation
    between, give the same bits and leave the arrival count and the
    per-row maxima at 0."""
    loop, (_, a_y, b_x, _, eps_run, eps_b, logw) = _update_loop(cuda, b, n, "all", "running",
                                                                3 * b + n)
    x = loop.x.clone()
    loop.state[0] = 1
    buffers = lambda: (loop.a_y, loop.b_x, loop.running, loop.eps_run, loop.fs,  # noqa: E731
                       loop.state, loop.row_max)
    before = [t.clone() for t in buffers()]
    loop.update(freeze=True)
    torch.cuda.synchronize()
    assert all(torch.equal(got, want) for got, want in zip(buffers(), before))
    runs = []
    for _ in range(2):
        loop.load(x, logw, eps_b, eps_run, a_y, b_x)
        sc._launch_lse(loop.eps_run, loop.x, loop.x, loop.fs, loop.lse)
        loop.update(freeze=False)
        runs.append([t.clone() for t in buffers()])
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    assert runs[0][5].tolist()[1:] == [1, 1, 0]
    assert not bool(runs[0][6].any())


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("convergence", ["all", "any"])
@pytest.mark.parametrize("b,n,max_iter", [(32, 100, 100), (10, 100, 100), (4, 4097, 100),
                                          (2, 4097, 100),
                                          (32, 100, 9), (32, 100, 2), (32, 100, 1)])
def test_ot_resample_graph_matches_one_iteration_chunks(cuda, monkeypatch, b, n, max_iter,
                                                        convergence, warm):
    """K3 on the card replays ``LOOP_CHUNK`` iterations a graph (here at
    every N); against chunks of one iteration: the same iterations and the
    same bits
    (potentials, particles), with one host read per replay, and the same
    iterations as the driver's plain version on the CPU, particles within
    rtol 1e-4 / atol 1e-3 (magnitude 60; at max_iter 1 the plan is the
    unconverged start's, where the card's and the CPU's rounding of K1 part
    by 2.7e-5 relative)."""
    x, probs = _loop_inputs(b, n, b + n + max_iter, cuda)
    kw = dict(max_iter=max_iter, convergence=convergence, return_potentials=True)
    if warm:
        kw["warm_start"] = (sc.ot_resample_streaming(x, probs, **kw)[4], True)
    runs = {}
    monkeypatch.setattr(sc, "LOOP_CHUNK_MAX_N", 1 << 30)
    for k in (1, sc.LOOP_CHUNK):
        monkeypatch.setattr(sc, "LOOP_CHUNK", k)
        sc.reset_streaming_loop()
        runs[k] = sc.ot_resample_streaming(x, probs, **kw), dict(sc.STREAMING_LOOP)
    (one, loop1), (graph, loop_k) = runs[1], runs[sc.LOOP_CHUNK]
    assert graph[3] == one[3] == loop_k["iters"] == loop1["iters"]
    # the done flag is set in the loop's last iteration: ⌈iters / k⌉ replays
    assert loop_k["host_reads"] == -(-one[3] // sc.LOOP_CHUNK)
    assert torch.equal(graph[4], one[4]) and torch.equal(graph[0], one[0])
    cpu_kw = dict(kw, warm_start=(kw["warm_start"][0].cpu(), True)) if warm else kw
    plain = sc.ot_resample_streaming_plain(x.cpu(), probs.cpu(), **cpu_kw)
    assert plain[3] == one[3]
    torch.testing.assert_close(one[0].cpu(), plain[0], rtol=1e-4, atol=1e-3)


def _chain_case(b, n, ctx_dim, seed, broadcast_ctx=False, n_blocks=2, hidden=8,
                fan_in=False):
    """Packed chain parameters at std 0.3 (layout of ``pack_chain_params``:
    only the rows and columns the chain reads are filled) and inputs; with
    ``fan_in`` a layer's std is 0.3·√(8 / its inputs) where it has more
    than 8, so that a wide or deep chain keeps the pre-activations and the
    scales of a hidden-8 chain (at 0.3 a 256-wide chain saturates every tanh
    and its exp(s) reach e^15, where float32 rounding alone moves outputs by
    1e-3 of their size)."""
    gen = torch.Generator().manual_seed(seed)
    in_dim, max_in = 1 + ctx_dim, max(1 + ctx_dim, hidden)

    def std(inputs):
        return 0.3 * math.sqrt(8 / inputs) if fan_in and inputs > 8 else 0.3

    w = torch.zeros(n_blocks, 4, 3, max_in, hidden)
    w[:, :, 0, :in_dim] = torch.randn(n_blocks, 4, in_dim, hidden, generator=gen) * std(in_dim)
    w[:, :, 1, :hidden] = torch.randn(n_blocks, 4, hidden, hidden, generator=gen) * std(hidden)
    w[:, :, 2, :hidden, 0] = torch.randn(n_blocks, 4, hidden, generator=gen) * std(hidden)
    bias = torch.randn(n_blocks, 4, 3, hidden, generator=gen) * 0.1
    bias[:, :, 2, 1:] = 0.0
    x = torch.randn(b, n, 2, generator=gen)
    ctx = None
    if ctx_dim:
        ctx = torch.randn(b, 1 if broadcast_ctx else n, ctx_dim, generator=gen)
    gy = torch.randn(b, n, 2, generator=gen)
    gld = torch.randn(b, n, generator=gen)
    return x, ctx, w, bias, gy, gld


CHAIN_SHAPES = [(32, 100, 4, True), (32, 100, 36, True), (4, 4097, 36, False),
                (4, 4097, 0, False), (3, 33, 4, False)]


@pytest.mark.cuda
def test_coupling_chain_other_hidden_width(cuda):
    """Each hidden width is a library of its own, built at first use: width
    4 against the plain version (rtol/atol 1e-5, gradients 1e-4 of scale)."""
    x, ctx, w, bias, gy, gld = (t.to(cuda) for t in _chain_case(3, 70, 5, 2, n_blocks=3,
                                                                hidden=4))
    outs = []
    for fn in (cc.fused_coupling_chain, cc.chain_apply_packed_plain):
        leaves = [t.clone().requires_grad_() for t in (x, ctx, w, bias)]
        y, ld = fn(*leaves, True)
        outs.append((y, ld) + torch.autograd.grad([y, ld], leaves, [gy, gld]))
    for got, ref in zip(*outs):
        got, ref = got.detach(), ref.detach()
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("b,n,ctx_dim,broadcast", CHAIN_SHAPES)
def test_coupling_chain_kernels_match_plain(cuda, b, n, ctx_dim, broadcast, inverse):
    """K4 and K5 against the plain version and its autograd at the filter's
    shapes (context broadcast over the particles, as the filter passes it),
    a ragged large one and a tiny one: outputs to rtol/atol 1e-5, gradients
    to 1e-4 of each gradient's scale (weight gradients sum over all rows in
    another order than autograd's matrix products)."""
    x, ctx, w, bias, gy, gld = (t.to(cuda) if t is not None else None
                                for t in _chain_case(b, n, ctx_dim, 11 * b + n + ctx_dim,
                                                     broadcast))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        c = None if ctx is None else ctx.clone().requires_grad_()
        c_in = None if c is None else c.expand(b, n, ctx_dim)
        y, ld = fn(leaves[0], c_in, leaves[1], leaves[2], inverse)
        wanted = leaves + ([] if c is None else [c])
        grads = torch.autograd.grad([y, ld], wanted, [gy, gld])
        return y, ld, grads

    cc.reset_launches()
    y, ld, grads = run(cc.fused_coupling_chain)
    torch.cuda.synchronize()
    fwd = "coupling_chain_inverse" if inverse else "coupling_chain"
    assert cc.LAUNCHES[fwd] == 1 and cc.LAUNCHES["coupling_chain_bwd"] == 1
    y_ref, ld_ref, grads_ref = run(cc.chain_apply_packed_plain)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ld, ld_ref, rtol=1e-5, atol=1e-5)
    for got, ref in zip(grads, grads_ref):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
def test_coupling_chain_backward_repeats_bitwise_and_skips_unasked_ctx(cuda):
    """The backward sums its partials in a fixed order (no float atomics):
    two runs give the same bits.  A context that asks for no gradient gets
    none and the other gradients do not change."""
    x, ctx, w, bias, gy, gld = (t.to(cuda) for t in _chain_case(32, 100, 36, 5))

    def grads(ctx_grad):
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        c = ctx.clone().requires_grad_(ctx_grad)
        y, ld = cc.fused_coupling_chain(leaves[0], c, leaves[1], leaves[2], True)
        return torch.autograd.grad([y, ld], leaves + ([c] if ctx_grad else []), [gy, gld])

    first, second, no_ctx = grads(True), grads(True), grads(False)
    for a, b_, c in zip(first, second, no_ctx):
        assert torch.equal(a, b_) and torch.equal(a, c)


# shapes that meet the backward's decomposition at its edges, as (B, N, C,
# blocks, hidden), each context one row per batch element broadcast over
# the particles with stride 0: particle counts that no tile divides (tiles
# straddle batch rows), one particle per batch row, one batch row over many
# thread blocks, one and eight coupling blocks, hidden widths 4, 6 and 3
# (the forward's rows take 4, 2 and 1 lanes per net at widths 8 and 4, 6,
# and 3)
CHAIN_BWD_SHAPES = [(5, 33, 4, 2, 8), (2, 300, 36, 2, 8), (40, 1, 4, 2, 8), (1, 5000, 4, 2, 8),
                    (3, 70, 5, 1, 8), (3, 70, 5, 8, 8), (5, 33, 4, 2, 4), (5, 33, 36, 2, 6),
                    (3, 70, 5, 2, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("b,n,ctx_dim,n_blocks,hidden", CHAIN_BWD_SHAPES)
def test_coupling_chain_backward_tiles(cuda, b, n, ctx_dim, n_blocks, hidden, inverse):
    """K5 where its row tiles, runs of rows that share a context row and grid
    meet awkward shapes: outputs to rtol/atol 1e-5, every gradient (the
    context's too) to 1e-4 of its scale against the plain version's
    autograd, and a second launch gives the same bits."""
    x, ctx, w, bias, gy, gld = (t.to(cuda) for t in _chain_case(
        b, n, ctx_dim, 13 * b + n + n_blocks, True, n_blocks, hidden))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (x, ctx, w, bias)]
        c_in = torch.as_strided(leaves[1], (b, n, ctx_dim), (ctx_dim, 0, 1))
        y, ld = fn(leaves[0], c_in, leaves[2], leaves[3], inverse)
        return [y, ld] + list(torch.autograd.grad([y, ld], leaves, [gy, gld]))

    cc.reset_launches()
    got, again = run(cc.fused_coupling_chain), run(cc.fused_coupling_chain)
    torch.cuda.synchronize()
    assert cc.LAUNCHES["coupling_chain_bwd"] == 2
    ref = run(cc.chain_apply_packed_plain)
    for k, (a, a2, r) in enumerate(zip(got, again, ref)):
        a, a2, r = a.detach(), a2.detach(), r.detach()
        assert torch.equal(a, a2)
        if k < 2:
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


# the forward kernel alone: the backward's edge shapes, each context broadcast
# over the particles, and a dense context given as a non-contiguous view
CHAIN_FWD_SHAPES = [shape + (True,) for shape in CHAIN_BWD_SHAPES] + [(3, 70, 36, 2, 8, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("b,n,ctx_dim,n_blocks,hidden,broadcast", CHAIN_FWD_SHAPES)
def test_coupling_chain_forward_kernel(cuda, b, n, ctx_dim, n_blocks, hidden, broadcast,
                                       inverse):
    """K4 as the eval route calls it (no autograd), where its blocks, lanes
    and runs of rows that share a context row meet awkward shapes: outputs
    to rtol/atol 1e-5 against the plain version, one launch of K4 and one of
    the context-share kernel per call, and a second launch gives the same
    bits."""
    x, ctx, w, bias, _, _ = (t.to(cuda) for t in _chain_case(
        b, n, ctx_dim, 17 * b + n + n_blocks, broadcast, n_blocks, hidden))
    if broadcast:
        ctx = torch.as_strided(ctx, (b, n, ctx_dim), (ctx_dim, 0, 1))
    else:
        wide = torch.zeros(b, n, ctx_dim + 3, device=cuda)
        wide[..., 1:ctx_dim + 1] = ctx
        ctx = wide[..., 1:ctx_dim + 1]   # particle stride ctx_dim + 3
        assert not ctx.is_contiguous() and ctx.stride(1) == ctx_dim + 3

    cc.reset_launches()
    with torch.no_grad():
        got = cc.fused_coupling_chain(x, ctx, w, bias, inverse)
        again = cc.fused_coupling_chain(x, ctx, w, bias, inverse)
    torch.cuda.synchronize()
    fwd = "coupling_chain_inverse" if inverse else "coupling_chain"
    assert cc.LAUNCHES[fwd] == 2 and cc.LAUNCHES["coupling_ctx_share"] == 2
    assert sum(cc.LAUNCHES.values()) == 4
    ref = cc.chain_apply_packed_plain(x, ctx, w, bias, inverse)
    for a, a2, r in zip(got, again, ref):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


# hidden widths above 8, as (B, N, C, context broadcast, hidden): 16, the
# kernels' widest build, at the filter's shapes and a ragged large one, and
# 12 and 9, which the wrapper pads to 16
CHAIN_WIDE_SHAPES = [(32, 100, 4, True, 16), (32, 100, 36, True, 16), (4, 4097, 36, False, 16),
                     (4, 4097, 0, False, 16), (5, 33, 4, True, 12), (3, 70, 36, True, 12),
                     (2, 40, 5, False, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("b,n,ctx_dim,broadcast,hidden", CHAIN_WIDE_SHAPES)
def test_coupling_chain_wide_hidden(cuda, b, n, ctx_dim, broadcast, hidden, inverse):
    """K4 and K5 at hidden widths 9-16 against the plain version of the
    unpadded chain and its autograd: outputs to rtol/atol 1e-5, gradients
    of x, the context and the unpadded weights and biases to 1e-4 of each
    gradient's scale, one launch of each kernel per call and the same bits
    from a second call."""
    x, ctx, w, bias, gy, gld = (None if t is None else t.to(cuda) for t in _chain_case(
        b, n, ctx_dim, 19 * b + n + hidden, broadcast, hidden=hidden))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        c = None if ctx is None else ctx.clone().requires_grad_()
        c_in = None if c is None else c.expand(b, n, ctx_dim)
        y, ld = fn(leaves[0], c_in, leaves[1], leaves[2], inverse)
        wanted = leaves + ([] if c is None else [c])
        return [y, ld] + list(torch.autograd.grad([y, ld], wanted, [gy, gld]))

    cc.reset_launches()
    got, again = run(cc.fused_coupling_chain), run(cc.fused_coupling_chain)
    torch.cuda.synchronize()
    fwd = "coupling_chain_inverse" if inverse else "coupling_chain"
    assert cc.LAUNCHES[fwd] == 2 and cc.LAUNCHES["coupling_chain_bwd"] == 2
    ref = run(cc.chain_apply_packed_plain)
    for k, (a, a2, r) in enumerate(zip(got, again, ref)):
        a, a2, r = a.detach(), a2.detach(), r.detach()
        assert a.shape == r.shape and torch.equal(a, a2)
        if k < 2:
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


@pytest.mark.cuda
def test_bf16_cnf_train_step_matches_cpu(cuda):
    """One CNF-DPF train step computing its encoder and decoder in bfloat16
    (B=2, N=16, T=5, flows ×10, every step resampled) on the card against
    the CPU from the same parameters and noise.  The two devices round the
    convolutions differently (cuDNN, the CPU), which can move the Sinkhorn
    loop's stopping test (275 against 276 iterations seen): the firings are
    equal, the loss within rtol 1e-3, and each group's gradient (encoder,
    decoder, measurement, each chain, as one vector) within twice the
    distance bfloat16 itself puts between a float32 and a bfloat16 run on
    the CPU, at least 1e-2, as ``chip_smoke.py``'s ``parity_bf16`` holds
    it; the parameters stay float32."""
    from nfdpf_torch.config import DPFConfig
    from nfdpf_torch.train import Trainer

    b, n, t = 2, 16, 5
    settings = dict(num_particles=n, sequence_length=t, batch_size=b, ess_threshold=1.01,
                    use_pallas=True, nf_dyn=True, nf_cond=True, pallas_coupling=True)
    gen = torch.Generator().manual_seed(6)
    batch = {"image": torch.rand(b, t, 128, 128, 3, generator=gen),
             "state": torch.randn(b, t, 4, generator=gen) * 10,
             "start_state": torch.randn(b, 4, generator=gen) * 10}
    noise = {"init": torch.rand(b, n, 2, generator=gen) * 128 - 64,
             "motion": torch.randn(t, b, n, 2, generator=gen),
             "vel": torch.randn(b, t, 2, generator=gen),
             "mask": torch.ones(b, t)}
    runs = {}
    for device, dtype in (("cpu", "bfloat16"), ("cuda", "bfloat16"), ("cpu", "float32")):
        trainer = Trainer(DPFConfig(**settings, compute_dtype=dtype), device=device)
        with torch.no_grad():
            for p in list(trainer.engine.nf_dyn.parameters()) + list(
                    trainer.engine.cond_model.parameters()):
                p.mul_(10.0)
        loss, aux = trainer._loss({k: v.to(device) for k, v in batch.items()}, True,
                                  {k: v.to(device) for k, v in noise.items()})
        loss.backward()
        assert all(p.dtype == torch.float32 for p in trainer.engine.parameters())
        runs[device, dtype] = (float(loss.detach()), aux["resample_count"],
                               {k: p.grad.cpu() for k, p in trainer.engine.named_parameters()
                                if p.grad is not None})
    (l_cpu, r_cpu, g_cpu), (l_gpu, r_gpu, g_gpu) = runs["cpu", "bfloat16"], runs["cuda", "bfloat16"]
    g_f32 = runs["cpu", "float32"][2]
    assert r_gpu == r_cpu == t
    assert abs(l_gpu - l_cpu) <= 1e-3 * abs(l_cpu)
    assert set(g_gpu) == set(g_cpu) == set(g_f32)

    def flat(grads, group):
        return torch.cat([g.ravel() for k, g in sorted(grads.items())
                          if k.split(".")[0] == group])

    for group in ("encoder", "decoder", "measurement", "nf_dyn", "cond_model"):
        ref = flat(g_cpu, group)
        gap = float((flat(g_gpu, group) - ref).norm() / ref.norm())
        bf16_effect = float((flat(g_f32, group) - ref).norm() / ref.norm())
        assert gap <= max(2.0 * bf16_effect, 1e-2), (group, gap, bf16_effect)


@pytest.mark.cuda
def test_coupling_chain_backward_refuses_what_its_shared_memory_cannot_hold(cuda):
    """A chain whose narrow backward's shared memory (twice the parameters of
    a chain without context plus its factor tile) passes a block's, four
    blocks at hidden 16, is not refused: both directions run on the wide
    pair, whose backward keeps no factor tile, and match the plain version
    (outputs to rtol/atol 1e-5, gradients to 1e-4 of their scale)."""
    x, ctx, w, bias, gy, gld = (t.to(cuda) for t in _chain_case(2, 10, 4, 3, n_blocks=4,
                                                                hidden=16))
    assert cc.bwd_smem_bytes(4, 16) > cc.MAX_SMEM_BYTES >= cc.fwd_smem_bytes(4, 16, 2)
    assert not cc.narrow_pair_takes(4, 16)
    outs = []
    cc.reset_launches()
    for fn in (cc.fused_coupling_chain, cc.chain_apply_packed_plain):
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        y, ld = fn(leaves[0], ctx, leaves[1], leaves[2])
        outs.append([y, ld] + list(torch.autograd.grad([y, ld], leaves, [gy, gld])))
    torch.cuda.synchronize()
    assert cc.LAUNCHES["coupling_chain_wide"] == 1 and cc.LAUNCHES["coupling_chain_bwd_wide"] == 1
    assert cc.LAUNCHES["coupling_chain"] == cc.LAUNCHES["coupling_chain_bwd"] == 0
    for k, (got, ref) in enumerate(zip(*outs)):
        got, ref = got.detach(), ref.detach()
        tol = (1e-5, 1e-5) if k < 2 else (1e-4, 1e-4 * float(ref.abs().max()))
        torch.testing.assert_close(got, ref, rtol=tol[0], atol=tol[1])


@pytest.mark.cuda
def test_coupling_chain_refuses_what_the_kernels_do_not_take(cuda):
    """On CUDA tensors the wrapper launches or raises: no plain fallback.
    Hidden 17 and nine blocks run (on the wide pair); a width past
    ``WIDE_MAX_HIDDEN`` and tensors on two devices raise."""
    for kwargs in (dict(hidden=17), dict(n_blocks=9)):
        x, ctx, w, bias, _, _ = (t.to(cuda) for t in _chain_case(2, 10, 4, 1, **kwargs))
        y, ld = cc.fused_coupling_chain(x, ctx, w, bias)
        y_ref, ld_ref = cc.chain_apply_packed_plain(x, ctx, w, bias)
        torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ld, ld_ref, rtol=1e-5, atol=1e-5)
    x, ctx, w, bias, _, _ = (t.to(cuda) for t in _chain_case(
        1, 3, 1, 1, n_blocks=1, hidden=cc.WIDE_MAX_HIDDEN + 1))
    with pytest.raises(ValueError, match="hidden"):
        cc.fused_coupling_chain(x, ctx, w, bias)
    with pytest.raises(ValueError, match="several devices"):
        cc.fused_coupling_chain(x.cpu(), ctx, w, bias)


# chains the narrow pair does not take, as (B, N, C, context broadcast,
# blocks, hidden): four blocks at 12 (the narrow backward's tile), 17, 32 at
# 4 and 9 blocks, 64 at 12 and 256 (layer 1 read from global memory), each at
# the filter's (32, 100); a dense context at a ragged large N, no context,
# ragged tiles, 300 and 1,024 wide on few rows, and 512 and 1,024 at the
# filter's (32, 100) (at 1,024 the partials' cap leaves fewer blocks than
# tiles: a block adds its later tiles into its partial)
WIDE_CHAINS = [(32, 100, 4, True, 4, 12), (32, 100, 36, True, 2, 17),
               (32, 100, 196, True, 4, 32), (32, 100, 36, True, 9, 32),
               (32, 100, 4, True, 12, 64), (32, 100, 36, True, 2, 256),
               (4, 4097, 36, False, 4, 32), (4, 4097, 0, False, 4, 32),
               (3, 33, 5, True, 9, 12), (5, 7, 3, False, 3, 33),
               (2, 33, 4, True, 1, 300), (1, 24, 4, True, 1, 1024),
               (32, 100, 36, True, 2, 512), (32, 100, 36, True, 2, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("b,n,ctx_dim,broadcast,n_blocks,hidden", WIDE_CHAINS)
def test_coupling_chain_wide_pair_matches_plain(cuda, b, n, ctx_dim, broadcast, n_blocks,
                                                hidden, inverse):
    """The wide pair with the wide library's context kernels against the
    plain version's autograd, weights scaled to their fan-in (``_chain_case``):
    outputs to rtol/atol 1e-5, every gradient (x,
    the context, weights, biases) to 1e-4 of its scale; the same bits from a
    second call; each wide kernel launched once a call and the narrow pair
    never."""
    x, ctx, w, bias, gy, gld = (t.to(cuda) if t is not None else None for t in _chain_case(
        b, n, ctx_dim, 37 * b + n + hidden, broadcast, n_blocks, hidden, fan_in=True))
    assert not cc.narrow_pair_takes(n_blocks, hidden)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        c = None if ctx is None else ctx.clone().requires_grad_()
        c_in = None if c is None else c.expand(b, n, ctx_dim)
        y, ld = fn(leaves[0], c_in, leaves[1], leaves[2], inverse)
        wanted = leaves + ([] if c is None else [c])
        return [y, ld] + list(torch.autograd.grad([y, ld], wanted, [gy, gld]))

    cc.reset_launches()
    got, again = run(cc.fused_coupling_chain), run(cc.fused_coupling_chain)
    torch.cuda.synchronize()
    fwd = "coupling_chain_wide_inverse" if inverse else "coupling_chain_wide"
    want = {fwd: 2, "coupling_chain_bwd_wide": 2, "coupling_ctx_share": 2}
    if ctx_dim:
        groups = len(cc.ctx_grad_groups(4 * n_blocks * hidden))
        want.update(coupling_ctx_grad_rows=2 * groups, coupling_ctx_weight_grad=2 * groups,
                    coupling_ctx_input_grad=2)
    assert {k: v for k, v in cc.LAUNCHES.items() if v} == want
    ref = run(cc.chain_apply_packed_plain)
    for k, (a, a2, r) in enumerate(zip(got, again, ref)):
        a, a2, r = a.detach(), a2.detach(), r.detach()
        assert torch.equal(a, a2)
        if k < 2:
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


# the wide backward's repeats: the slice's chain, a 256-wide one (a block a
# tile) and a 1,024-wide one (blocks that add their later tiles)
WIDE_REPEATS = [(32, 100, 36, 4, 32), (32, 100, 36, 2, 256), (32, 100, 36, 2, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("b,n,ctx_dim,n_blocks,hidden", WIDE_REPEATS)
def test_coupling_chain_wide_backward_repeats_bit_for_bit(cuda, b, n, ctx_dim, n_blocks, hidden,
                                                          inverse):
    """The wide backward kernel launched twice on the same inputs gives the
    same bits: gx, g1 and every block's partial of the weight and bias
    gradients (no atomics: each entry summed in a fixed order)."""
    x, ctx, w, bias, gy, gld = (t.to(cuda) for t in _chain_case(
        b, n, ctx_dim, 43 * b + n + hidden, True, n_blocks, hidden, fan_in=True))
    p, mode = cc._launch_ctx_share(cc._library(cc.WIDE_BUILD), ctx.expand(b, n, ctx_dim), w,
                                   bias)
    plan = cc.wide_bwd_plan(b * n, n_blocks, hidden)
    first = cc.wide_backward_parts(x, p, mode, w, bias, gy, gld, inverse, True)
    again = cc.wide_backward_parts(x, p, mode, w, bias, gy, gld, inverse, True)
    torch.cuda.synchronize()
    assert first[2].shape == (plan["grid"], n_blocks, 4, cc.wide_part_floats(hidden))
    assert bool(torch.isfinite(first[2]).all())
    for a, a2 in zip(first, again):
        assert torch.equal(a, a2)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_coupling_chain_wide_pair_agrees_with_the_narrow_pair(cuda, inverse):
    """At hidden 8 and two blocks, a chain both pairs take, the wide pair's
    launchers against the narrow pair's on the same P: outputs to rtol/atol
    1e-5, gx, g1 and the weight and bias gradients to 1e-4 of their
    scale."""
    x, ctx, w, bias, gy, gld = (t.to(cuda) for t in _chain_case(32, 100, 36, 41, True))
    ctx = ctx.expand(32, 100, 36)
    p, mode = cc._launch_ctx_share(cc._library(8), ctx, w, bias)
    p_wide, mode_wide = cc._launch_ctx_share(cc._library(cc.WIDE_BUILD), ctx, w, bias)
    assert mode_wide == mode and torch.equal(p_wide, p)
    narrow = cc._launch_forward(x, p, mode, w, bias, inverse)
    wide = cc._launch_forward_wide(x, p, mode, w, bias, inverse)
    for a, r in zip(wide, narrow):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
    gx, g1, gw_plain, gb = cc._launch_backward(x, p, mode, w, bias, gy, gld, inverse, True)
    gw = torch.zeros_like(w)
    gw[:, :, :, :8] = gw_plain
    for a, r in zip(cc._launch_backward_wide(x, p, mode, w, bias, gy, gld, inverse, True),
                    (gx, g1, gw, gb)):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


# contexts wider than the kernels' shared memory held before the context's
# share left them, as (B, N, C, context broadcast, blocks): the CGLOW
# proposal's 196 at the filter's (32, 100) and main_cli's eval batch, dense
# at a ragged large shape, and wider still at more blocks
CHAIN_WIDE_CONTEXTS = [(32, 100, 196, True, 2), (10, 100, 196, True, 2),
                       (4, 4097, 196, False, 2), (2, 300, 250, True, 2), (3, 70, 400, False, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("b,n,ctx_dim,broadcast,n_blocks", CHAIN_WIDE_CONTEXTS)
def test_coupling_chain_takes_wide_contexts(cuda, b, n, ctx_dim, broadcast, n_blocks, inverse):
    """K4/K5 with the context kernels at context widths up to 400: outputs
    to rtol/atol 1e-5 and every gradient (x, the context, weights, biases)
    to 1e-4 of its scale against the plain version's autograd, the same
    bits from a second call, and each kernel launched once a call (the
    context's gradient kernel only where the context asks for one)."""
    x, ctx, w, bias, gy, gld = (t.to(cuda) for t in _chain_case(
        b, n, ctx_dim, 29 * b + n + ctx_dim, broadcast, n_blocks))

    def run(fn, ctx_grad=True):
        leaves = [t.clone().requires_grad_() for t in (x, ctx, w, bias)]
        leaves[1].requires_grad_(ctx_grad)
        y, ld = fn(leaves[0], leaves[1].expand(b, n, ctx_dim), leaves[2], leaves[3], inverse)
        wanted = [t for t in leaves if t.requires_grad]
        return [y, ld] + list(torch.autograd.grad([y, ld], wanted, [gy, gld]))

    cc.reset_launches()
    got, again = run(cc.fused_coupling_chain), run(cc.fused_coupling_chain)
    torch.cuda.synchronize()
    fwd = "coupling_chain_inverse" if inverse else "coupling_chain"
    assert {k: v for k, v in cc.LAUNCHES.items() if v} == {
        fwd: 2, "coupling_chain_bwd": 2, "coupling_ctx_share": 2, "coupling_ctx_grad_rows": 2,
        "coupling_ctx_weight_grad": 2, "coupling_ctx_input_grad": 2}
    no_ctx = run(cc.fused_coupling_chain, ctx_grad=False)
    assert cc.LAUNCHES["coupling_ctx_input_grad"] == 2
    ref = run(cc.chain_apply_packed_plain)
    for k, (a, a2, r) in enumerate(zip(got, again, ref)):
        a, a2, r = a.detach(), a2.detach(), r.detach()
        assert torch.equal(a, a2)
        if k < 2:
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))
    for a, c in zip(got[:3] + got[4:], no_ctx):
        assert torch.equal(a, c)


# the context kernels' cases as (B, N, C, context broadcast, blocks, hidden,
# dense context read through a strided view): the filter's heaviest, a
# dense large one, ragged row counts, C = 1 and 197 on both routes of the
# weight gradient, the widest rows of g1 (4K·H = 256 and 192), a broadcast
# over too few particles for the segment sums, a strided dense view
CONTEXT_CASES = [(32, 100, 196, True, 2, 8, False), (4, 4097, 36, False, 2, 8, False),
                 (3, 33, 5, True, 2, 8, False), (3, 1037, 36, False, 2, 8, False),
                 (32, 100, 1, True, 2, 8, False), (32, 100, 197, True, 2, 8, False),
                 (3, 1037, 1, False, 2, 8, False), (3, 1037, 197, False, 2, 8, False),
                 (32, 100, 36, True, 8, 8, False), (3, 1037, 36, False, 8, 8, False),
                 (32, 100, 196, True, 3, 16, False), (3, 1037, 36, False, 3, 16, False),
                 (64, 5, 36, True, 2, 8, False), (3, 1037, 36, False, 2, 8, True),
                 # the input gradient's tile edges: C at 4 / 16 / 64 and one past,
                 # rows ragged against its 64-row tiles, a hidden width that is
                 # no multiple of 4 (the weights staged 4 bytes at a time)
                 (32, 100, 4, True, 2, 8, False), (3, 33, 16, True, 2, 8, False),
                 (3, 1037, 17, False, 2, 8, False), (32, 100, 63, True, 2, 8, False),
                 (3, 1037, 64, False, 2, 8, False), (3, 33, 65, True, 8, 8, False),
                 (3, 1037, 65, False, 2, 6, False), (1, 7, 197, True, 3, 16, False)]


def _context_case(cuda, b, n, ctx_dim, broadcast, n_blocks, hidden, view):
    """(ctx (B, N, C) on the card, weights, biases, g1 (B·N, 4K·H)); with
    ``view`` the context is entries 5..5+C of a transposed (N, B, C + 9)
    tensor."""
    _, ctx, w, bias, _, _ = (t.to(cuda) if t is not None else None for t in _chain_case(
        b, n, ctx_dim, 31 * b + n + ctx_dim, broadcast, n_blocks, hidden))
    gen = torch.Generator().manual_seed(b + ctx_dim)
    if view:
        ctx = torch.randn(n, b, ctx_dim + 9, generator=gen).to(cuda).permute(1, 0, 2)
        ctx = ctx[..., 5:5 + ctx_dim]
    g1 = torch.randn(b * n, 4 * n_blocks * hidden, generator=gen).to(cuda)
    return ctx.expand(b, n, ctx_dim), w, bias, g1


def _context_kernels(ctx, w, bias, g1):
    return [cc.ctx_share(ctx, w, bias), cc.ctx_weight_grad(g1, ctx, w),
            cc.ctx_input_grad(g1, w, ctx.shape[-1]), cc.ctx_grad_rows(g1, ctx, w)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,ctx_dim,broadcast,n_blocks,hidden,view", CONTEXT_CASES)
def test_context_kernels_match_plain(cuda, b, n, ctx_dim, broadcast, n_blocks, hidden, view):
    """The context kernels alone against their plain versions: the share to
    rtol/atol 1e-5, the two gradients and the weight gradient's first
    kernel (its parts) to 1e-4 of their scale; second launches give the
    same bits."""
    ctx, w, bias, g1 = _context_case(cuda, b, n, ctx_dim, broadcast, n_blocks, hidden, view)
    assert view == (not ctx.is_contiguous() and ctx.stride(1) != 0)
    got, again = _context_kernels(ctx, w, bias, g1), _context_kernels(ctx, w, bias, g1)
    ref = [cc.ctx_share_plain(ctx, w, bias), cc.ctx_weight_grad_plain(g1, ctx, w),
           cc.ctx_input_grad_plain(g1, w, ctx_dim), cc.ctx_grad_rows_plain(g1, ctx, w)]
    torch.cuda.synchronize()
    for k, (a, a2, r) in enumerate(zip(got, again, ref)):
        assert torch.equal(a, a2)
        if k == 0:
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


@pytest.mark.cuda
def test_context_kernels_back_to_back(cuda):
    """Every case of the context kernels launched back to back, with no
    synchronisation between, gives the bits of its own launch: the weight
    gradient's arrival counters and partials carry nothing from one shape
    to the next."""
    cases = [_context_case(cuda, *case) for case in CONTEXT_CASES]
    alone = []
    for case in cases:
        alone.append(_context_kernels(*case))
        torch.cuda.synchronize()
    together = [_context_kernels(*case) for case in cases]
    torch.cuda.synchronize()
    for a, t in zip(alone, together):
        assert all(torch.equal(x, y) for x, y in zip(a, t))


# ---------------------------------------------------------------------------
# the paths around the kernels: dense OT, the warm start, soft resampling and
# the measurement models, on the card against the CPU
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("transport_grad", [False, True], ids=["detached", "transport_grad"])
def test_dense_ot_resample_matches_cpu(cuda, transport_grad):
    """Dense OT over materialised costs at the filter's (32, 100): the same
    loop iterations, particles within atol 1e-3 (magnitude 60), the
    gradient against the particles (and, with transport_grad, the weights)
    within ‖Δ‖/‖g‖ 1e-3, the card's gradient limit against the CPU
    (``PERF.md`` §2); no kernel launches."""
    from nfdpf_torch.ops import sinkhorn as ts

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(32, 100, 2, generator=gen) * 20
    probs = torch.softmax(torch.randn(32, 100, generator=gen), dim=-1)
    probe = torch.randn(32, 100, 2, generator=gen)
    runs = {}
    for dev in ("cpu", cuda):
        tx, tw = x.to(dev).requires_grad_(), probs.to(dev).requires_grad_()
        ts.reset_dense_loop()
        sc.reset_launches()
        out, _, _ = ts.ot_resample(tx, tw, transport_grad=transport_grad)
        grads = torch.autograd.grad(torch.sum(out * probe.to(dev)), [tx, tw], allow_unused=True)
        runs[str(dev)] = (out.detach().cpu(), [g if g is None else g.cpu() for g in grads],
                          dict(ts.DENSE_LOOP))
        assert not any(sc.LAUNCHES.values())
    (p_cpu, g_cpu, loop_cpu), (p_gpu, g_gpu, loop_gpu) = runs["cpu"], runs["cuda"]
    assert loop_gpu == loop_cpu and loop_cpu["iters"] > 2
    torch.testing.assert_close(p_gpu, p_cpu, rtol=1e-5, atol=1e-3)
    for got, ref in zip(g_gpu, g_cpu):
        if ref is None:
            assert got is None and not transport_grad
        else:
            assert float((got - ref).norm() / ref.norm()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_warm_start_on_kernels_matches_plain(cuda, warm):
    """The streaming resampler's second firing, warm-started from the first
    one's potentials or cold, on the kernels against the plain versions:
    the same iterations, particles within atol 1e-3, potentials within
    atol 1e-4; the warm firing takes fewer iterations than the cold."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(32, 100, 2, generator=gen) * 20
    probs = torch.softmax(torch.randn(32, 100, generator=gen), dim=-1)
    x2 = x + 0.5 * torch.randn(32, 100, 2, generator=gen)
    probs2 = torch.softmax(torch.log(probs) * 1.1, dim=-1)
    runs = {}
    for dev in ("cpu", cuda):
        *_, pots = sc.ot_resample_streaming(x.to(dev), probs.to(dev), return_potentials=True)
        start = (pots, True) if warm else None
        out, _, _, iters, pots2 = sc.ot_resample_streaming(
            x2.to(dev), probs2.to(dev), warm_start=start, return_potentials=True)
        runs[str(dev)] = (out.cpu(), iters, pots2.cpu())
    (p_cpu, it_cpu, pot_cpu), (p_gpu, it_gpu, pot_gpu) = runs["cpu"], runs["cuda"]
    assert it_gpu == it_cpu > 0
    torch.testing.assert_close(p_gpu, p_cpu, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(pot_gpu, pot_cpu, rtol=1e-5, atol=1e-4)
    if warm:
        _, _, _, cold_iters = sc.ot_resample_streaming(x2, probs2)
        assert it_cpu < cold_iters


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["NN", "gaussian", "CRNVP"])
def test_measurement_models_match_cpu(cuda, kind):
    """Each measurement model at the filter's (32, 100) on the card against
    the CPU from the same parameters (the CRNVP flow's scaled ×10 from its
    init): log-likelihoods within rtol 1e-5 / atol 1e-4, the gradient
    against the encodings, the particles and every parameter within
    ‖Δ‖/‖g‖ 1e-4."""
    from nfdpf_torch.config import DPFConfig
    from nfdpf_torch.models.measurement import build_measurement_model
    from nfdpf_torch.models.nets import flax_init_

    model = build_measurement_model(DPFConfig(measurement=kind))
    flax_init_(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("cnf."):
                p.mul_(10.0)
    gen = torch.Generator().manual_seed(3)
    enc = torch.randn(32, 32, generator=gen)
    particles = torch.randn(32, 100, 2, generator=gen) * 40
    probe = torch.randn(32, 100, generator=gen)
    runs = {}
    for dev in ("cpu", cuda):
        model.to(dev)
        te, tp = enc.to(dev).requires_grad_(), particles.to(dev).requires_grad_()
        lik = model(te, tp)
        wanted = [te, tp] + list(model.parameters())
        grads = torch.autograd.grad(torch.sum(lik * probe.to(dev)), wanted)
        runs[str(dev)] = (lik.detach().cpu(), [g.cpu() for g in grads])
    (l_cpu, g_cpu), (l_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-5, atol=1e-4)
    for got, ref in zip(g_gpu, g_cpu):
        assert float((got - ref).norm() / ref.norm().clamp_min(1e-30)) <= 1e-4


def _tie_free_index_mismatches(idx_a, idx_b, cum, markers, tol=1e-6):
    """(positions where the indices differ and no marker lies within ``tol``
    of a cumulative boundary, positions excused as such ties)."""
    near = ((markers[:, :, None] - cum[:, None, :]).abs() <= tol).any(-1)
    differ = idx_a != idx_b
    return int((differ & ~near).sum()), int((differ & near).sum())


@pytest.mark.cuda
def test_soft_indices_match_cpu_away_from_ties(cuda):
    """The markers' grid has the CPU's bits on the card.  Systematic indices
    from the same weights and offsets at (32, 100), 50 times: the card and
    the CPU pick the same ancestor wherever the marker
    is not within 1e-6 of a cumulative boundary (``torch.cumsum`` may differ
    in its last bit between devices); the ties excused are printed."""
    from nfdpf_torch.ops.resampling import systematic_basic, systematic_indices

    for n in (100, 10240):      # the markers' grid: the same bits on both devices
        assert torch.equal(systematic_basic(n, cuda).cpu(), systematic_basic(n))
    gen = torch.Generator().manual_seed(4)
    excused = 0
    for _ in range(50):
        q = torch.softmax(torch.randn(32, 100, generator=gen) * 3, dim=-1)
        offset = torch.rand(32, 1, generator=gen) / 100
        idx_cpu = systematic_indices(q, offset)
        idx_gpu = systematic_indices(q.to(cuda), offset.to(cuda)).cpu()
        cum = torch.cumsum(q, dim=1)
        bad, ties = _tie_free_index_mismatches(idx_gpu, idx_cpu, cum,
                                               offset + systematic_basic(100)[None, :])
        assert bad == 0
        excused += ties
    print(f"soft indices: {excused} ties excused")


@pytest.mark.cuda
@pytest.mark.parametrize("overrides", [dict(use_pallas=False), dict(resampler_type="soft")],
                         ids=["dense_ot", "soft"])
def test_dense_and_soft_paths_launch_no_streaming_kernel(cuda, overrides):
    """The filter on the card, resampling every step: dense OT and soft
    resampling run no streaming kernel (the counters stay at 0), and the
    dense path runs its own loop on every firing."""
    from nfdpf_torch.config import DPFConfig
    from nfdpf_torch.models.dpf import DPF
    from nfdpf_torch.ops import sinkhorn as ts

    cfg = DPFConfig(**{"num_particles": 100, "sequence_length": 5, "batch_size": 4,
                       "ess_threshold": 1.01, "use_pallas": True, **overrides})
    engine = DPF(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    enc = torch.randn(4, 5, 32, device=cuda, generator=gen)
    start = torch.randn(4, 4, device=cuda, generator=gen) * 10
    vel = torch.randn(4, 5, 2, device=cuda, generator=gen)
    sc.reset_launches()
    ts.reset_dense_loop()
    with torch.no_grad():
        out = engine.filter_from_encodings(enc, start, vel, generator=gen)
    assert bool(out.resampled.all()) and bool(torch.isfinite(out.particles).all())
    assert not any(sc.LAUNCHES.values())
    assert ts.DENSE_LOOP["calls"] == (5 if cfg.resampler_type == "ot" else 0)


def _cglow_measurement(seed):
    """The CGLOW measurement at its default sizes with every CGLOW parameter
    drawn from N(0, 0.15²) (at init the 1×1 convolution's weight does not
    depend on the particle), and (32, 100) particles spread as the filter's."""
    from nfdpf_torch.config import DPFConfig
    from nfdpf_torch.models.measurement import build_measurement_model
    from nfdpf_torch.models.nets import flax_init_

    model = build_measurement_model(DPFConfig(measurement="CGLOW"))
    gen = torch.Generator().manual_seed(seed)
    flax_init_(model, gen)
    with torch.no_grad():
        for p in model.cglow.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.15)
    return model, torch.randn(32, 100, 2, generator=gen) * 40, gen


@pytest.mark.cuda
def test_linalg_on_cond1x1conv_weights_matches_float64(cuda):
    """``logabsdet`` and ``inv`` and their analytic gradients on the card at
    the filter's (3,200, 12, 12), on the weights the first 1×1 convolution
    makes, against float64 ``torch.linalg`` on the CPU: per matrix within
    1e-5 + 1e-6·cond(W) (log-determinant absolute, the rest ‖Δ‖/‖ref‖),
    the inverse's gradient (a product of two inverses) within
    1e-5 + 2e-6·cond(W); the CPU's float32 run stays under half of each."""
    from nfdpf_torch.ops import linalg

    model, particles, gen = _cglow_measurement(5)
    with torch.no_grad():
        e_state = model.particle_encoder(particles).reshape(3200, 8, 8, 3)
        w = model.cglow.layer_mods[0].invconv.net(e_state).reshape(3200, 12, 12)
    g_ld = torch.randn(3200, generator=gen)
    g_inv = torch.randn(3200, 12, 12, generator=gen)
    w64 = w.double().requires_grad_()
    ld64, y64 = torch.linalg.slogdet(w64)[1], torch.linalg.inv(w64)
    (gld64,) = torch.autograd.grad(torch.sum(ld64 * g_ld.double()), [w64])
    (ginv64,) = torch.autograd.grad(torch.sum(y64 * g_inv.double()), [w64])
    tol = 1e-5 + 1e-6 * torch.linalg.cond(w.double())
    wc = w.to(cuda).requires_grad_()
    ld, y = linalg.logabsdet(wc), linalg.inv(wc)
    (gld,) = torch.autograd.grad(torch.sum(ld * g_ld.to(cuda)), [wc])
    (ginv,) = torch.autograd.grad(torch.sum(y * g_inv.to(cuda)), [wc])

    def rel(a, ref):
        return (a.detach().cpu().double() - ref).norm(dim=(-2, -1)) / ref.norm(dim=(-2, -1))

    assert bool(((ld.detach().cpu().double() - ld64.detach()).abs() <= tol).all())
    for got, ref, bound in ((y, y64.detach(), tol), (gld, gld64, tol),
                            (ginv, ginv64, tol + 1e-6 * torch.linalg.cond(w.double()))):
        assert bool((rel(got, ref) <= bound).all())


@pytest.mark.cuda
def test_cglow_measurement_matches_cpu(cuda):
    """The CGLOW measurement on the card against the CPU at the filter's
    (32, 100), from the same parameters: log-likelihoods within atol 1e-4
    (bits/dim; the drawn weights' condition numbers reach ~6e4), the
    gradient against the encodings, the particles and every parameter within
    ‖Δ‖/‖g‖ 1e-3, the card-against-CPU gradient limit."""
    model, particles, gen = _cglow_measurement(6)
    enc = torch.randn(32, 192, generator=gen)
    probe = torch.randn(32, 100, generator=gen)
    runs = {}
    for dev in ("cpu", cuda):
        model.to(dev)
        te, tp = enc.to(dev).requires_grad_(), particles.to(dev).requires_grad_()
        lik = model(te, tp)
        wanted = [te, tp] + list(model.parameters())
        grads = torch.autograd.grad(torch.sum(lik * probe.to(dev)), wanted)
        runs[str(dev)] = (lik.detach().cpu(), [g.cpu() for g in grads])
    (l_cpu, g_cpu), (l_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    torch.testing.assert_close(l_gpu, l_cpu, rtol=0, atol=1e-4)
    for got, ref in zip(g_gpu, g_cpu):
        assert float((got - ref).norm() / ref.norm().clamp_min(1e-30)) <= 1e-3


@pytest.mark.cuda
def test_simulator_matches_cpu(cuda):
    """Eight 50-step, 25-distractor sequences made on the card from draws
    made there, against the same draws on the CPU: every frame, start frame
    and visible count equal, states within atol 1e-4 (the CPU test's bound
    against JAX)."""
    from nfdpf_torch.data.simulator import DiskSimulator

    sim = DiskSimulator(sequence_length=50, num_distractors=25)
    draws = sim.draw_sequence(torch.Generator(device=cuda).manual_seed(0), num=8)
    gpu = sim.sequence_from_draws(draws)
    cpu = sim.sequence_from_draws({k: v.cpu() for k, v in draws.items()})
    assert gpu["image"].is_cuda and gpu["image"].dtype == torch.uint8
    for key in ("start_image", "image", "visible", "start_state", "q"):
        assert torch.equal(gpu[key].cpu(), cpu[key]), key
    torch.testing.assert_close(gpu["state"].cpu(), cpu["state"], rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_main_one_epoch_on_cuda(cuda, tmp_path, monkeypatch):
    """``python -m nfdpf_torch.main`` with the CNF-DPF on the kernels at a
    small size, on the card (no device given): it makes the data there,
    trains one epoch, checkpoints and tests, and the coupling kernels run."""
    from nfdpf_torch.main import main
    from nfdpf_torch.ops.cuda import coupling_cuda as cc
    from nfdpf_torch.utils.checkpoint import restore_checkpoint

    monkeypatch.chdir(tmp_path)
    cc.reset_launches()
    main(["--num-epochs", "1", "--num-particles", "16", "--batchsize", "2",
          "--sequence-length", "5", "--num-examples", "8", "--NF-dyn", "--NF-cond",
          "--pallas-coupling", "--use-pallas", "--data-path", str(tmp_path / "disks")])
    (run_dir,) = list((tmp_path / "logs").iterdir())
    assert restore_checkpoint(str(run_dir / "models" / "final"))["epoch"] == 1
    assert (run_dir / "models" / "best").is_dir()
    for artifact in ("eval_loss_epoch.npy", "eval_result_best.npz", "test_loss_epoch.npy",
                     "test_result.npz"):
        assert (run_dir / "data" / artifact).is_file(), artifact
    assert cc.LAUNCHES["coupling_chain"] > 0 and cc.LAUNCHES["coupling_chain_bwd"] > 0


INVERTIBLE_FLOWS = ("maf", "actnorm", "lu", "nsf_ar", "nsf_cl", "chain")


def _flow_library():
    from nfdpf_torch.models.nets import TransitionMLP
    from nfdpf_torch.ops import flows as F

    chain = F.FlowChain([F.ActNorm(2), F.InvertibleLinear(2), F.NSFCoupling(2), F.MAF(2),
                         F.NSFAutoregressive(2)])
    return {"maf": F.MAF(2), "actnorm": F.ActNorm(2), "lu": F.InvertibleLinear(2),
            "planar": F.Planar(2), "radial": F.Radial(2), "nsf_ar": F.NSFAutoregressive(2),
            "nsf_cl": F.NSFCoupling(2), "transition_mlp": TransitionMLP(2), "chain": chain}


def _flow_run(module, x, inverse):
    """Outputs and the gradients of Σ sin(y) + Σ (log-det, log-prob)² for
    x and every parameter."""
    module.zero_grad()
    x = x.detach().clone().requires_grad_()
    out = module.inverse(x) if inverse else module(x)
    out = out if isinstance(out, tuple) else (out,)
    loss = torch.sum(torch.sin(out[0])) + sum(torch.sum(o * o) for o in out[1:])
    loss.backward()
    grads = [x.grad] + [p.grad for p in module.parameters()]
    return [o.detach().cpu().double() for o in out], [g.cpu().double() for g in grads]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["maf", "actnorm", "lu", "planar", "radial", "nsf_ar", "nsf_cl",
                                  "transition_mlp", "chain"])
def test_flow_library_on_the_card_matches_float64(cuda, name):
    """The flow library's modules (plain PyTorch, no kernel of ours) on the
    card in float32 at (32, 100, 2), forward and inverse where they have
    one, against float64 on the CPU: outputs within 1e-5 + 1e-5·|ref| (the
    chain 5e-5) and gradients within 1e-4 in relative norm, or at most
    twice as far as the CPU's own float32 run (the splines' steep bins)."""
    import copy

    from nfdpf_torch.models.nets import flax_init_

    gen = torch.Generator().manual_seed(3)
    module = _flow_library()[name]
    flax_init_(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    x = torch.randn(32, 100, 2, generator=gen) * 2.0
    tol = 5e-5 if name == "chain" else 1e-5
    card, ref = copy.deepcopy(module).to(cuda), copy.deepcopy(module).double()
    for inverse in (False, True) if name in INVERTIBLE_FLOWS else (False,):
        ref_out, ref_grads = _flow_run(ref, x.double(), inverse)
        errs = []
        for got_out, got_grads in (_flow_run(card, x.to(cuda), inverse),
                                   _flow_run(module, x, inverse)):
            errs.append((max(float(((o - r).abs() / (tol + tol * r.abs())).max())
                             for o, r in zip(got_out, ref_out)),
                         [float((g - r).norm() / r.norm()) for g, r in zip(got_grads, ref_grads)]))
        (out_card, grads_card), (out_cpu, grads_cpu) = errs
        assert out_card <= max(1.0, 2 * out_cpu), (inverse, out_card, out_cpu)
        for g, c in zip(grads_card, grads_cpu):
            assert g <= max(1e-4, 2 * c), (inverse, grads_card, grads_cpu)
