"""nfdpf_torch RealNVP flows, the packed coupling chain and the NF dynamics
vs the JAX package.  Inputs come from numpy with a seed and the parameters
cross through the bridge; the JAX fused coupling kernels run in Pallas
interpret mode (as in tests/test_pallas_coupling.py), the port on the CPU
through the kernels' plain version.  The CUDA kernels themselves are held
to the plain version by tests/test_torch_cuda.py on a GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfdpf_tpu.ops.pallas.coupling_pallas as cp
from nfdpf_tpu.models import dynamics as jdyn
from nfdpf_tpu.ops.flows import realnvp_chain as jax_realnvp_chain
from nfdpf_torch.bridge import flow_chain_state_from_jax
from nfdpf_torch.models import dynamics as tdyn
from nfdpf_torch.models.nets import flax_init_
from nfdpf_torch.ops.cuda import coupling_cuda as cc
from nfdpf_torch.ops.flows import realnvp_chain

STD = 0.3   # at the filter's init std 0.01 the flow is near identity and shows nothing


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(cp, "_INTERPRET", True)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _chains(ctx_dim, seed=0, n_blocks=2, hidden=8):
    """A JAX chain with its variables (weights at std 0.3) and the port's
    chain loaded with them."""
    jchain = jax_realnvp_chain(n_blocks, 2, hidden, init_std=STD)
    x0 = jnp.zeros((1, 2, 2))
    c0 = jnp.zeros((1, 2, ctx_dim)) if ctx_dim else None
    variables = jchain.init(jax.random.PRNGKey(seed), x0, c0)
    tchain = realnvp_chain(n_blocks, 2, hidden, ctx_dim=ctx_dim)
    state = flow_chain_state_from_jax(_np_tree(variables))
    assert set(state) == set(tchain.state_dict())
    tchain.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return jchain, variables, tchain


def _inputs(seed, b, n, ctx_dim):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, 2)).astype(np.float32)
    ctx = rng.standard_normal((b, n, ctx_dim)).astype(np.float32) if ctx_dim else None
    return x, ctx


# ---------------------------------------------------------------------------
# the FlowChain modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ctx_dim", [0, 4, 36])
def test_flowchain_matches_jax(ctx_dim):
    """forward (z, prior log-prob, log-det) and inverse through the bridge,
    rtol/atol 1e-5 (float32 matrix products in another order)."""
    jchain, variables, tchain = _chains(ctx_dim)
    x, ctx = _inputs(1, 2, 50, ctx_dim)
    jctx = None if ctx is None else jnp.asarray(ctx)
    tctx = None if ctx is None else _t(ctx)
    z_ref, prior_ref, ld_ref = jchain.apply(variables, jnp.asarray(x), jctx,
                                            method=jchain.forward)
    x_ref, ldi_ref = jchain.apply(variables, jnp.asarray(x), jctx, method=jchain.inverse)
    with torch.no_grad():
        z, prior, ld = tchain(_t(x), tctx)
        x_inv, ldi = tchain.inverse(_t(x), tctx)
    for got, ref in ((z, z_ref), (prior, prior_ref), (ld, ld_ref), (x_inv, x_ref),
                     (ldi, ldi_ref)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_flowchain_roundtrip_and_sampling():
    """inverse(forward(x)) = x and the log-dets cancel (atol 1e-4);
    ``sample_with_dim`` is the inverse of a prior draw from the generator."""
    _, _, chain = _chains(4, seed=2)
    x, ctx = _inputs(3, 1, 130, 4)
    with torch.no_grad():
        z, _, ld_f = chain(_t(x), _t(ctx))
        x_rec, ld_i = chain.inverse(z, _t(ctx))
        np.testing.assert_allclose(x_rec.numpy(), x, atol=1e-4)
        np.testing.assert_allclose((ld_f + ld_i).numpy(), 0.0, atol=1e-4)
        sample = chain.sample_with_dim(torch.Generator().manual_seed(5), (1, 130), 2, _t(ctx))
        draw = torch.randn((1, 130, 2), generator=torch.Generator().manual_seed(5))
        want, _ = chain.inverse(draw, _t(ctx))
    assert torch.equal(sample, want)


def test_flow_init_is_normal_001_and_leaves_other_draws_alone():
    """``flax_init_`` draws the conditioners' weights from N(0, 0.01²) with
    zero biases, and a module initialised before the flows gets the draws
    it would get without them."""
    lin_alone = torch.nn.Linear(16, 16)
    flax_init_(lin_alone, torch.Generator().manual_seed(7))
    both = torch.nn.ModuleList([torch.nn.Linear(16, 16), realnvp_chain(2, 2, 8, 0.01, ctx_dim=36)])
    flax_init_(both, torch.Generator().manual_seed(7))
    assert torch.equal(both[0].weight, lin_alone.weight)
    state = both[1].state_dict()
    weights = torch.cat([p.flatten() for k, p in state.items() if "weight" in k])
    biases = torch.cat([p.flatten() for k, p in state.items() if "bias" in k])
    assert weights.numel() == 2 * 4 * (37 * 8 + 64 + 8)
    assert abs(float(weights.std()) - 0.01) < 1e-3 and abs(float(weights.mean())) < 1e-3
    assert float(weights.abs().max()) > 0.02          # not truncated at two std
    assert torch.count_nonzero(biases) == 0


# ---------------------------------------------------------------------------
# the packed chain: pack, plain version, gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ctx_dim", [0, 4, 36])
def test_pack_chain_params_equals_jax_pack(ctx_dim):
    """Entry for entry (a pack moves numbers, it computes none)."""
    _, variables, tchain = _chains(ctx_dim, seed=4)
    w_ref, b_ref = cp.pack_chain_params(variables, 2, ctx_dim)
    w, b = cc.pack_chain_params(tchain)
    assert w.shape == (2, 4, 3, max(1 + ctx_dim, 8), 8) and b.shape == (2, 4, 3, 8)
    np.testing.assert_array_equal(w.detach().numpy(), np.asarray(w_ref))
    np.testing.assert_array_equal(b.detach().numpy(), np.asarray(b_ref))


@pytest.mark.parametrize("n", [50, 130])
@pytest.mark.parametrize("ctx_dim", [0, 4, 36])
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_packed_chain_matches_jax_fused_kernel(ctx_dim, inverse, n):
    """The port's ``fused_coupling_chain`` (on the CPU: the plain version)
    against the JAX fused Pallas kernel, ragged row counts, rtol/atol 1e-5;
    and against the port's own FlowChain at the same tolerance."""
    _, variables, tchain = _chains(ctx_dim)
    x, ctx = _inputs(6, 2, n, ctx_dim)
    w_ref, b_ref = cp.pack_chain_params(variables, 2, ctx_dim)
    y_ref, ld_ref = cp.fused_coupling_chain(
        jnp.asarray(x), None if ctx is None else jnp.asarray(ctx), w_ref, b_ref,
        inverse=inverse)
    tctx = None if ctx is None else _t(ctx)
    with torch.no_grad():
        w, b = cc.pack_chain_params(tchain)
        y, ld = cc.fused_coupling_chain(_t(x), tctx, w, b, inverse)
        if inverse:
            y_mod, ld_mod = tchain.inverse(_t(x), tctx)
        else:
            y_mod, _, ld_mod = tchain(_t(x), tctx)
    assert y.shape == (2, n, 2) and ld.shape == (2, n)
    for got, ref in ((y, y_ref), (ld, ld_ref), (y, y_mod), (ld, ld_mod)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ctx_dim", [0, 4, 36])
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_packed_chain_gradients_match_jax_fused_backward(ctx_dim, inverse):
    """Gradients of Σ sin(y) + Σ ld² with respect to x, ctx, weights and
    biases: autograd of the port's plain version against the JAX fused
    backward kernel, N = 70 (ragged), rtol/atol 2e-5.  Packed entries the
    chain never reads (rows past 1+C, output columns past 0) get zero."""
    _, variables, _ = _chains(ctx_dim, seed=5)
    x, ctx = _inputs(7, 2, 70, ctx_dim)
    w_ref, b_ref = cp.pack_chain_params(variables, 2, ctx_dim)

    def loss_fused(x_, c_, w_, b_):
        y, ld = cp.fused_coupling_chain(x_, c_, w_, b_, inverse)
        return jnp.sum(jnp.sin(y)) + jnp.sum(ld * ld)

    if ctx is None:
        gx, gw, gb = jax.grad(lambda x_, w_, b_: loss_fused(x_, None, w_, b_),
                              argnums=(0, 1, 2))(jnp.asarray(x), w_ref, b_ref)
        gc = None
    else:
        gx, gc, gw, gb = jax.grad(loss_fused, argnums=(0, 1, 2, 3))(
            jnp.asarray(x), jnp.asarray(ctx), w_ref, b_ref)

    tx = _t(x).requires_grad_()
    tc = None if ctx is None else _t(ctx).requires_grad_()
    tw, tb = _t(w_ref).requires_grad_(), _t(b_ref).requires_grad_()
    y, ld = cc.fused_coupling_chain(tx, tc, tw, tb, inverse)
    (torch.sum(torch.sin(y)) + torch.sum(ld * ld)).backward()
    pairs = [(tx.grad, gx), (tw.grad, gw), (tb.grad, gb)]
    if ctx is not None:
        pairs.append((tc.grad, gc))
    for got, ref in pairs:
        assert float(got.abs().sum()) > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    assert torch.count_nonzero(tw.grad[:, :, 0, 1 + ctx_dim:]) == 0
    assert torch.count_nonzero(tw.grad[:, :, 2, :, 1:]) == 0


@pytest.mark.parametrize("broadcast,inverse", [(True, True), (False, False)],
                         ids=["broadcast-inverse", "dense-forward"])
def test_split_route_matches_packed_plain_and_jax(broadcast, inverse):
    """The route the CUDA kernels take with the context's share of layer 0
    split out (``chain_apply_split_plain``: P per distinct context row, then
    the chain on it) at the CGLOW proposal's 196-wide context, K = 2, H = 8,
    the context broadcast over the particles (as the filter passes it) or
    dense: outputs, log-det and the gradients of Σ sin(y) + Σ ld² with
    respect to x, the context, weights and biases against
    ``chain_apply_packed_plain`` in both directions (rtol/atol 1e-5), and in
    the case's direction against the JAX fused kernel and its fused backward
    (interpret mode; outputs rtol/atol 1e-5, gradients rtol 2e-5 and atol
    2e-5 as above, or 2e-6 of the gradient's largest magnitude where that is
    more: at C = 196 the weight gradients reach ~100 and summation order
    alone moves them by ~1e-6 of that; ``chain_apply_packed_plain`` itself
    sits 5.3e-5 from JAX on an entry of a gradient that peaks at 79).  The
    two cases take each layout and each direction to JAX once."""
    ctx_dim, b, n = 196, 2, 40
    _, variables, _ = _chains(ctx_dim, seed=8)
    x, ctx = _inputs(9, b, n, ctx_dim)
    if broadcast:
        ctx = np.ascontiguousarray(np.broadcast_to(ctx[:, :1], ctx.shape))
    w_ref, b_ref = cp.pack_chain_params(variables, 2, ctx_dim)

    def loss_fused(x_, c_, w_, b_):
        y, ld = cp.fused_coupling_chain(x_, c_, w_, b_, inverse)
        return jnp.sum(jnp.sin(y)) + jnp.sum(ld * ld), (y, ld)

    (_, (y_ref, ld_ref)), grads_ref = jax.value_and_grad(
        loss_fused, argnums=(0, 1, 2, 3), has_aux=True)(jnp.asarray(x), jnp.asarray(ctx),
                                                         w_ref, b_ref)

    def run(fn, direction):
        tx, tw, tb = (_t(a).requires_grad_() for a in (x, w_ref, b_ref))
        tc = _t(ctx[:, :1] if broadcast else ctx).requires_grad_()
        y, ld = fn(tx, tc.expand(b, n, ctx_dim), tw, tb, direction)
        grads = torch.autograd.grad(torch.sum(torch.sin(y)) + torch.sum(ld * ld),
                                    [tx, tc, tw, tb])
        return [y.detach(), ld.detach(), *grads]

    for direction in (False, True):
        split = run(cc.chain_apply_split_plain, direction)
        for got, ref in zip(split, run(cc.chain_apply_packed_plain, direction)):
            assert float(got.abs().sum()) > 0
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    split = run(cc.chain_apply_split_plain, inverse)
    jax_out = [y_ref, ld_ref, grads_ref[0],
               jnp.sum(grads_ref[1], axis=1, keepdims=True) if broadcast else grads_ref[1],
               grads_ref[2], grads_ref[3]]
    for k, (got, ref_jax) in enumerate(zip(split, jax_out)):
        ref_jax = np.asarray(ref_jax)
        if k < 2:
            np.testing.assert_allclose(got.numpy(), ref_jax, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(got.numpy(), ref_jax, rtol=2e-5,
                                       atol=max(2e-5, 2e-6 * float(np.abs(ref_jax).max())))


@pytest.mark.parametrize("broadcast,ctx_dim,b,n", [
    pytest.param(True, 36, 3, 30, id="broadcast"), pytest.param(False, 36, 3, 30, id="dense"),
    pytest.param(True, 1, 3, 30, id="broadcast-C1"), pytest.param(False, 197, 3, 30, id="dense-C197"),
    pytest.param(True, 36, 5, 37, id="broadcast-ragged"),
    pytest.param(False, 36, 5, 37, id="dense-ragged")])
def test_context_kernels_plain_versions(broadcast, ctx_dim, b, n):
    """The plain versions of the three context kernels make the context's
    share and gradients of the packed chain: P (``ctx_share_plain``) is
    layer 0's bias plus ctx · w0[1..C] per distinct context row (one per
    batch element when broadcast); from each row's g1 = ∂L/∂P (what K5
    writes) ``ctx_weight_grad_plain`` and ``ctx_input_grad_plain`` give the
    context rows of the weight gradient and the context's gradient of
    ``chain_apply_packed_plain``'s autograd (rtol/atol 1e-5); on CPU tensors
    the wrappers are the plain versions.  At C = 36, 1 and 197, and at a
    ragged (B, N)."""
    _, variables, _ = _chains(ctx_dim, seed=10)
    x, ctx = _inputs(11, b, n, ctx_dim)
    w, bias = (_t(a) for a in cp.pack_chain_params(variables, 2, ctx_dim))
    c = _t(ctx[:, :1] if broadcast else ctx)
    c_in = c.expand(b, n, ctx_dim)
    p = cc.ctx_share_plain(c_in, w, bias)
    assert p.shape == ((b if broadcast else b * n), 2 * 4 * 8)
    assert torch.equal(cc.ctx_share(c_in, w, bias), p)
    rows = c_in.reshape(b * n, ctx_dim)
    direct = bias[:, :, 0].reshape(1, -1) + (rows @ w[:, :, 0, 1:1 + ctx_dim].permute(
        2, 0, 1, 3).reshape(ctx_dim, -1))
    np.testing.assert_allclose(
        (p[:, None].expand(b, n, -1).reshape(b * n, -1) if broadcast else p).numpy(),
        direct.numpy(), rtol=1e-5, atol=1e-5)

    # g1 = ∂L/∂P of each row, through the split route's layer 0
    p_rows = p.reshape(b, 1 if broadcast else n, 2, 4, 8).expand(b, n, 2, 4, 8)
    p_rows = p_rows.detach().clone().requires_grad_()
    xt = _t(x)

    def loss(y, ld):
        return torch.sum(torch.sin(y)) + torch.sum(ld * ld)

    y, ld = cc._chain_plain(xt, w, bias, True,
                            lambda k, ni, half: half * w[k, ni, 0, 0, :] + p_rows[:, :, k, ni])
    (g1,) = torch.autograd.grad(loss(y, ld), [p_rows])
    g1 = g1.reshape(b * n, -1)
    wl, cl = w.clone().requires_grad_(), c.clone().requires_grad_()
    y, ld = cc.chain_apply_packed_plain(xt, cl.expand(b, n, ctx_dim), wl, bias, True)
    gw, gc = torch.autograd.grad(loss(y, ld), [wl, cl])
    got_w = cc.ctx_weight_grad(g1, c_in, w)
    np.testing.assert_allclose(got_w.numpy(), gw[:, :, 0, 1:1 + ctx_dim].numpy(),
                               rtol=1e-5, atol=1e-5)
    got_c = cc.ctx_input_grad(g1, w, ctx_dim).reshape(b, n, ctx_dim)
    np.testing.assert_allclose((got_c.sum(1, keepdim=True) if broadcast else got_c).numpy(),
                               gc.numpy(), rtol=1e-5, atol=1e-5)


def test_pack_carries_gradients_back_to_the_chain():
    """The pack is made of differentiable ops: a loss on the packed path
    gives the chain's parameters the gradients the module path gives them
    (rtol 1e-4 / atol 1e-6)."""
    _, _, chain = _chains(4, seed=8)
    x, ctx = _inputs(9, 2, 30, 4)

    def grads(packed):
        chain.zero_grad()
        if packed:
            y, ld = cc.fused_coupling_chain(_t(x), _t(ctx), *cc.pack_chain_params(chain), True)
        else:
            y, ld = chain.inverse(_t(x), _t(ctx))
        (torch.sum(y * y) + torch.sum(ld)).backward()
        return {k: p.grad.clone() for k, p in chain.named_parameters()}

    g_packed, g_module = grads(True), grads(False)
    for name, g in g_module.items():
        assert float(g.abs().sum()) > 0, name
        np.testing.assert_allclose(g_packed[name].numpy(), g.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_fused_chain_rejects_bad_shapes():
    _, _, chain = _chains(36)
    w, b = cc.pack_chain_params(chain)
    x, ctx = _inputs(0, 2, 10, 36)
    with pytest.raises(ValueError, match="bad shapes"):
        cc.fused_coupling_chain(_t(x), None, w, b)              # packed for ctx 36
    with pytest.raises(ValueError, match="bad shapes"):
        cc.fused_coupling_chain(_t(x)[:, :, :1], _t(ctx), w, b)
    with pytest.raises(ValueError, match="state dim"):
        cc.pack_chain_params(realnvp_chain(2, 4, 8))


# ---------------------------------------------------------------------------
# the NF dynamics and the weight bookkeeping
# ---------------------------------------------------------------------------


def _dyn_pair(seed=10):
    """Dynamics chain (ctx 4) and proposal chain (ctx 32 + 4), both packages."""
    return _chains(4, seed=seed), _chains(36, seed=seed + 1)


def _cloud(seed, b=2, n=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, 2)) * 3 + 1).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True], ids=["module", "packed"])
@pytest.mark.parametrize("given_stats", [False, True], ids=["own_stats", "given_stats"])
@pytest.mark.parametrize("forward", [False, True], ids=["inverse", "forward"])
def test_nf_dynamic_model_matches_jax(forward, given_stats, fused):
    """Both directions, with the particles' own mean/std (unbiased std) and
    with given ones, on the module and the packed route; rtol/atol 1e-5."""
    (jchain, variables, tchain), _ = _dyn_pair()
    p = _cloud(11)
    other = _cloud(12)
    mean = other.mean(1, keepdims=True) if given_stats else None
    std = other.std(1, keepdims=True, ddof=1) if given_stats else None
    jfused = cp.pack_chain_params(variables, 2, 4) if fused else None
    ref, ref_jac = jdyn.nf_dynamic_model(
        jchain, variables, jnp.asarray(p), use_nf=True, forward=forward,
        mean=None if mean is None else jnp.asarray(mean),
        std=None if std is None else jnp.asarray(std), fused=jfused)
    with torch.no_grad():
        got, jac = tdyn.nf_dynamic_model(
            tchain, _t(p), use_nf=True, forward=forward,
            mean=None if mean is None else _t(mean), std=None if std is None else _t(std),
            fused=cc.pack_chain_params(tchain) if fused else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(jac.numpy(), np.asarray(ref_jac), rtol=1e-5, atol=1e-5)


def test_nf_dynamic_model_off_is_identity():
    p = _t(_cloud(13))
    out, jac = tdyn.nf_dynamic_model(None, p, use_nf=False)
    assert out is p and torch.equal(jac, torch.zeros(2, 24))


@pytest.mark.parametrize("fused", [False, True], ids=["module", "packed"])
def test_normalising_flow_propose_matches_jax(fused):
    """Context = encoding ‖ detached mean ‖ std; rtol/atol 1e-5."""
    _, (jchain, variables, tchain) = _dyn_pair()
    p = _cloud(14)
    enc = np.random.default_rng(15).standard_normal((2, 32)).astype(np.float32)
    ref, ref_jac = jdyn.normalising_flow_propose(
        jchain, variables, jnp.asarray(p), jnp.asarray(enc),
        fused=cp.pack_chain_params(variables, 2, 36) if fused else None)
    with torch.no_grad():
        got, jac = tdyn.normalising_flow_propose(
            tchain, _t(p), _t(enc), fused=cc.pack_chain_params(tchain) if fused else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(jac.numpy(), np.asarray(ref_jac), rtol=1e-5, atol=1e-5)


def _measure(enc, particles):
    """A stand-in measurement that depends on both of its inputs."""
    return -(particles[..., 0] * enc[:, None, 0] + particles[..., 1] ** 2 * 0.01)


@pytest.mark.parametrize("fused", [False, True], ids=["module", "packed"])
@pytest.mark.parametrize("use_nf,use_nf_cond", [(False, False), (True, False),
                                                (False, True), (True, True)])
def test_proposal_likelihood_matches_jax(use_nf, use_nf_cond, fused):
    """All four switch settings: proposed particles, likelihood, prior and
    proposal log terms (rtol 1e-5 / atol 1e-4 on log densities of magnitude
    ~10)."""
    (jd, vd, td), (jc, vc, tc) = _dyn_pair()
    rng = np.random.default_rng(16)
    phys = _cloud(17)
    noise = (rng.standard_normal(phys.shape) * 2).astype(np.float32)
    enc = rng.standard_normal((2, 32)).astype(np.float32)
    jf_dyn = cp.pack_chain_params(vd, 2, 4) if fused and use_nf else None
    jf_cond = cp.pack_chain_params(vc, 2, 36) if fused and use_nf_cond else None
    dyn_ref, jac_ref = jdyn.nf_dynamic_model(jd, vd, jnp.asarray(phys), use_nf=use_nf,
                                             fused=jf_dyn)
    ref = jdyn.proposal_likelihood(
        jc, vc, jd, vd, lambda e, p: -(p[..., 0] * e[:, None, 0] + p[..., 1] ** 2 * 0.01),
        dyn_ref, jnp.asarray(phys), jnp.asarray(enc), jnp.asarray(noise), jac_ref,
        use_nf, use_nf_cond, 20.0, 20.0, fused_dyn=jf_dyn, fused_cond=jf_cond)
    with torch.no_grad():
        tf_dyn = cc.pack_chain_params(td) if fused and use_nf else None
        tf_cond = cc.pack_chain_params(tc) if fused and use_nf_cond else None
        dyn, jac = tdyn.nf_dynamic_model(td, _t(phys), use_nf=use_nf, fused=tf_dyn)
        got = tdyn.proposal_likelihood(
            tc, td, _measure, dyn, _t(phys), _t(enc), _t(noise), jac, use_nf, use_nf_cond,
            20.0, 20.0, fused_dyn=tf_dyn, fused_cond=tf_cond)
    for name, g, r in zip(("propose", "lki", "prior", "propose_log"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4,
                                   err_msg=name)
    if not use_nf_cond:
        assert torch.equal(got[2], got[3])          # prior == proposal: bootstrap update


@pytest.mark.parametrize("fused", [False, True], ids=["module", "packed"])
def test_stop_gradient_topology(fused):
    """No gradient reaches the encodings through the proposal (only through
    the measurement), and none flows through the particle mean/std: the
    gradient of the particles equals the one taken with the statistics held
    as constants (atol 1e-6)."""
    (_, _, td), (_, _, tc) = _dyn_pair()
    rng = np.random.default_rng(18)
    noise = _t((rng.standard_normal((2, 24, 2)) * 2).astype(np.float32))
    packs = (cc.pack_chain_params(td), cc.pack_chain_params(tc)) if fused else (None, None)

    def run(measure):
        phys = _t(_cloud(19)).requires_grad_()
        enc = _t(rng.standard_normal((2, 32)).astype(np.float32)).requires_grad_()
        dyn, jac = tdyn.nf_dynamic_model(td, phys, use_nf=True, fused=packs[0])
        out = tdyn.proposal_likelihood(tc, td, measure, dyn, phys, enc, noise, jac, True, True,
                                       20.0, 20.0, fused_dyn=packs[0], fused_cond=packs[1])
        return phys, enc, dyn, out

    phys, enc, _, out = run(lambda e, p: torch.zeros(p.shape[:2]))
    (out[0].sum() + out[2].sum() - out[3].sum()).backward()
    assert enc.grad is None
    assert float(phys.grad.abs().sum()) > 0
    _, enc, _, out = run(_measure)
    out[1].sum().backward()
    assert float(enc.grad.abs().sum()) > 0

    # the dynamics flow with its context computed from a constant copy
    phys = _t(_cloud(19)).requires_grad_()
    mean, std = tdyn._particle_stats(phys)
    assert not mean.requires_grad and not std.requires_grad
    dyn, _ = tdyn.nf_dynamic_model(td, phys, use_nf=True, fused=packs[0])
    dyn.sum().backward()
    phys2 = _t(_cloud(19)).requires_grad_()
    frozen = _t(_cloud(19))
    dyn2, _ = tdyn.nf_dynamic_model(td, phys2, use_nf=True, fused=packs[0],
                                    mean=frozen.mean(1, keepdim=True),
                                    std=frozen.std(1, keepdim=True))
    dyn2.sum().backward()
    np.testing.assert_allclose(phys.grad.numpy(), phys2.grad.numpy(), atol=1e-6)
