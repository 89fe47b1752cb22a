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


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(32, 100), (4, 4097)])
@pytest.mark.parametrize("groups", [1, 2])
def test_lse_kernel_matches_plain(cuda, b, n, groups):
    """K1 to rtol/atol 1e-5 at the main path's shape and a ragged one."""
    x, _, _, _, _, gen = _inputs(b, n, b + n)
    fs = torch.randn(b, groups, n, generator=gen).to(cuda)
    x = x.to(cuda)
    eps = torch.linspace(0.1, 2.0, b).to(cuda)
    sc.reset_launches()
    got = sc.streaming_lse_multi(eps, x, x, fs)
    torch.cuda.synchronize()
    assert sc.LAUNCHES["sinkhorn_lse"] == 1
    torch.testing.assert_close(got, sc.lse_multi_plain(eps, x, x, fs), rtol=1e-5, atol=1e-5)


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


def _chain_case(b, n, ctx_dim, seed, broadcast_ctx=False, n_blocks=2, hidden=8):
    """Packed chain parameters at std 0.3 (layout of ``pack_chain_params``:
    only the rows and columns the chain reads are filled) and inputs."""
    gen = torch.Generator().manual_seed(seed)
    in_dim, max_in = 1 + ctx_dim, max(1 + ctx_dim, hidden)
    w = torch.zeros(n_blocks, 4, 3, max_in, hidden)
    w[:, :, 0, :in_dim] = torch.randn(n_blocks, 4, in_dim, hidden, generator=gen) * 0.3
    w[:, :, 1, :hidden] = torch.randn(n_blocks, 4, hidden, hidden, generator=gen) * 0.3
    w[:, :, 2, :hidden, 0] = torch.randn(n_blocks, 4, hidden, generator=gen) * 0.3
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


@pytest.mark.cuda
def test_coupling_chain_refuses_what_the_kernels_do_not_take(cuda):
    """On CUDA tensors the wrapper launches or raises: no plain fallback."""
    x, ctx, w, bias, _, _ = (t.to(cuda) for t in _chain_case(2, 10, 4, 1, hidden=40))
    with pytest.raises(ValueError, match="hidden"):
        cc.fused_coupling_chain(x, ctx, w, bias)
    x, ctx, w, bias, _, _ = (t.to(cuda) for t in _chain_case(2, 10, 400, 1, n_blocks=8))
    with pytest.raises(ValueError, match="shared memory"):
        cc.fused_coupling_chain(x, ctx, w, bias)
    with pytest.raises(ValueError, match="several devices"):
        cc.fused_coupling_chain(x.cpu(), ctx, w, bias)
