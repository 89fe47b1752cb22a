"""nfdpf_torch's flow library beyond RealNVP (the rational-quadratic spline,
MAF, ActNorm, the LU linear map, planar, radial, both neural-spline flows,
a mixed ``FlowChain``) and ``TransitionMLP`` vs the JAX package.  Inputs
come from numpy with a seed; the parameters are JAX's initial ones moved by
a seeded numpy draw (so that ActNorm is not the identity) and cross through
the bridge, and gradient trees come back through it.  Tolerances:
outputs and log-dets |Δ| ≤ 1e-5 + 1e-5·|ref|, gradients ‖Δ‖ ≤ 1e-4·‖ref‖
per tensor (float32 on both sides, ops in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfdpf_tpu.models.nets import TransitionMLP as JaxTransitionMLP
from nfdpf_tpu.ops import flows as JF
from nfdpf_tpu.ops import rqs as jrqs
from nfdpf_torch.bridge import flow_state_from_jax, mlp_state_from_jax
from nfdpf_torch.models.nets import TransitionMLP, flax_init_
from nfdpf_torch.ops import flows as TF
from nfdpf_torch.ops import rqs

TOL = 1e-5        # outputs and log-dets: |Δ| ≤ TOL + TOL·|ref|
GRAD_TOL = 1e-4   # gradients: ‖Δ‖ ≤ GRAD_TOL·‖ref‖ per tensor
SHIFT_STD = 0.1   # the numpy draw added to JAX's initial parameters
# the mixed chain's outputs and log-dets: five flows in float32, after
# which each side's log-det sits up to 2.7e-5 (port) and 1.2e-5 (JAX) from
# the port's float64 run at |ld| ≈ 2, so their gap may exceed TOL
CHAIN_TOL = 5e-5
LEAD = (4, 5)     # leading axes of every input

FLOWS = {
    "maf": (lambda d: JF.MAF(dim=d), lambda d: TF.MAF(d)),
    "actnorm": (lambda d: JF.ActNorm(dim=d), lambda d: TF.ActNorm(d)),
    "lu": (lambda d: JF.InvertibleLinear(dim=d), lambda d: TF.InvertibleLinear(d)),
    "planar": (lambda d: JF.Planar(dim=d), lambda d: TF.Planar(d)),
    "radial": (lambda d: JF.Radial(dim=d), lambda d: TF.Radial(d)),
    "nsf_ar": (lambda d: JF.NSFAutoregressive(dim=d), lambda d: TF.NSFAutoregressive(d)),
    "nsf_cl": (lambda d: JF.NSFCoupling(dim=d), lambda d: TF.NSFCoupling(d)),
}
INVERTIBLE = ("maf", "actnorm", "lu", "nsf_ar", "nsf_cl")
CASES = [(kind, dim, inverse) for kind in FLOWS for dim in (2, 3)
         for inverse in ((False, True) if kind in INVERTIBLE else (False,))]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tests run beside five other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.tensor(np.asarray(a))


def _shifted(variables, seed):
    """JAX's initial variables with N(0, SHIFT_STD²) added to every
    parameter (constants as they are), as numpy arrays."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + SHIFT_STD * rng.standard_normal(p.shape)).astype(np.float32),
        variables["params"])
    return {**jax.tree_util.tree_map(np.asarray, dict(variables)), "params": params}


def _load(tmod, state):
    assert set(state) == set(tmod.state_dict())
    tmod.load_state_dict({k: torch.tensor(v) for k, v in state.items()})


def _pair(jmod, tmod, dim, seed):
    """JAX's variables for ``jmod`` (shifted) and ``tmod`` loaded with them."""
    variables = _shifted(jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, dim))), seed)
    _load(tmod, flow_state_from_jax(tmod, variables))
    return variables


def _inputs(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=tol, atol=tol)


def _grads_close(got, ref):
    """Each gradient within GRAD_TOL of JAX's in relative norm."""
    assert set(got) == set(ref)
    for name, g in got.items():
        r = np.asarray(ref[name], np.float64)
        err = np.linalg.norm(g.detach().numpy().astype(np.float64) - r)
        assert err <= GRAD_TOL * np.linalg.norm(r), (name, err, np.linalg.norm(r))


def _loss(y, ld, xp):
    return xp.sum(xp.sin(y)) + xp.sum(ld * ld)


def _port_grads(tmod, x, run):
    """Autograd of ``_loss`` through ``run(x)``: d/dx and every parameter's."""
    tmod.zero_grad()
    tx = _t(x).requires_grad_()
    y, ld = run(tx)
    _loss(y, ld, torch).backward()
    out = {name: p.grad for name, p in tmod.named_parameters()}
    return tx.grad, y, ld, out


# ---------------------------------------------------------------------------
# the rational-quadratic spline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("unconstrained", [False, True], ids=["rqs", "unconstrained_rqs"])
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_rqs_matches_jax(inverse, unconstrained):
    """Outputs, log-dets and the gradients of every input at K = 5 over
    leading axes (4, 5, 3): the box [0, 1] for ``rqs``; tails at ±3 for
    ``unconstrained_rqs``, inputs N(0, 3²), a fifth of them outside."""
    k, bound = 5, 3.0
    lead = LEAD + (3,)
    inputs = (_inputs(lead, 1, 3.0) if unconstrained
              else np.random.default_rng(1).uniform(0.01, 0.99, lead).astype(np.float32))
    widths, heights = _inputs(lead + (k,), 2), _inputs(lead + (k,), 3)
    derivs = _inputs(lead + ((k - 1) if unconstrained else (k + 1),), 4)
    if unconstrained:
        assert 0.1 < np.mean(np.abs(inputs) > bound) < 0.5
        jfn = lambda *a: jrqs.unconstrained_rqs(*a, inverse=inverse, tail_bound=bound)  # noqa: E731
        tfn = lambda *a: rqs.unconstrained_rqs(*a, inverse=inverse, tail_bound=bound)  # noqa: E731
    else:
        jfn = lambda *a: jrqs.rqs(*a, inverse=inverse)  # noqa: E731
        tfn = lambda *a: rqs.rqs(*a, inverse=inverse)  # noqa: E731
    args = (inputs, widths, heights, derivs)

    def jloss(*a):
        y, ld = jfn(*a)
        return _loss(y, ld, jnp), (y, ld)
    ref_grads, (y_ref, ld_ref) = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *map(jnp.asarray, args))
    targs = [_t(a).requires_grad_() for a in args]
    y, ld = tfn(*targs)
    _loss(y, ld, torch).backward()
    _close(y, y_ref)
    _close(ld, ld_ref)
    _grads_close({i: a.grad for i, a in enumerate(targs)}, dict(enumerate(ref_grads)))


def test_searchsorted_counts_edges_with_eps_on_the_last():
    """The bin count is the comparison sum against the edges, the last
    raised by eps: an input on the last edge falls in the last bin."""
    edges = torch.tensor([0.0, 0.25, 0.5, 1.0])
    got = rqs._searchsorted(edges, torch.tensor([-0.1, 0.0, 0.3, 0.5, 1.0, 1.1]))
    assert got.tolist() == [-1, 0, 1, 2, 2, 3]
    ref = jrqs._searchsorted(jnp.asarray(edges.numpy()),
                             jnp.asarray([-0.1, 0.0, 0.3, 0.5, 1.0, 1.1]))
    assert got.tolist() == np.asarray(ref).tolist()


def test_softplus_is_jax_softplus_above_twenty():
    """``jax.nn.softplus`` is logaddexp(x, 0); so is the port's, where
    ``F.softplus`` turns linear above 20: within one float32 ulp of it over
    [-40, 40] (the two logaddexp differ in their last bit at one point)."""
    x = np.linspace(-40, 40, 161).astype(np.float32)
    np.testing.assert_array_max_ulp(rqs.softplus(_t(x)).numpy(),
                                    np.asarray(jax.nn.softplus(jnp.asarray(x))), maxulp=1)


# ---------------------------------------------------------------------------
# each flow
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,dim,inverse", CASES,
                         ids=[f"{k}-d{d}-{'inverse' if i else 'forward'}" for k, d, i in CASES])
def test_flow_matches_jax(kind, dim, inverse):
    """Output and log-det of ``forward`` (or ``inverse``) over (4, 5, dim),
    and the gradients of Σ sin(y) + Σ ld² for the input and every
    parameter, against JAX's; the spline flows' inputs N(0, 2²), so that
    some lie outside the tails at ±3.  Dim 3 is odd: NSFCoupling's two
    upper entries share one set of spline parameters, as in JAX."""
    jmod, tmod = FLOWS[kind][0](dim), FLOWS[kind][1](dim)
    variables = _pair(jmod, tmod, dim, seed=dim)
    x = _inputs(LEAD + (dim,), 10 + dim, 2.0)
    method = jmod.inverse if inverse else jmod.forward

    def jloss(params, x_):
        with jax.ensure_compile_time_eval():   # InvertibleLinear's setup reads its draw
            y, ld = jmod.apply({**variables, "params": params}, x_, None, method=method)
        return _loss(y, ld, jnp), (y, ld)
    (g_params, g_x), (y_ref, ld_ref) = jax.jit(jax.grad(jloss, argnums=(0, 1), has_aux=True))(
        variables["params"], jnp.asarray(x))
    run = (lambda v: tmod.inverse(v, None)) if inverse else (lambda v: tmod(v, None))
    gx, y, ld, grads = _port_grads(tmod, x, run)
    _close(y, y_ref)
    _close(ld, ld_ref)
    _grads_close({"x": gx}, {"x": g_x})
    _grads_close(grads, flow_state_from_jax(tmod, {"params": g_params}))


@pytest.mark.parametrize("kind", INVERTIBLE)
def test_flow_roundtrips(kind):
    """inverse(forward(x)) = x and the log-dets cancel, atol 2e-4, as
    tests/test_flows.py holds the JAX flows."""
    tmod = FLOWS[kind][1](2)
    flax_init_(tmod, torch.Generator().manual_seed(2))
    x = _t(_inputs((16, 2), 2))
    with torch.no_grad():
        z, ld_f = tmod(x)
        x_rec, ld_i = tmod.inverse(z)
    np.testing.assert_allclose(x_rec.numpy(), x.numpy(), atol=2e-4)
    np.testing.assert_allclose((ld_f + ld_i).numpy(), 0.0, atol=2e-4)


@pytest.mark.parametrize("kind", ["planar", "radial"])
def test_planar_radial_logdet_autodiff(kind):
    """The analytic log-det against log|det| of the Jacobian by
    ``torch.func.jacrev``, atol 1e-3 as tests/test_flows.py (the planar
    log-det adds 1e-4 inside its log)."""
    tmod = FLOWS[kind][1](2)
    flax_init_(tmod, torch.Generator().manual_seed(3))
    x = _t(_inputs((4, 2), 4, 2.0 if kind == "radial" else 1.0))
    _, ld = tmod(x)
    for i in range(4):
        jac = torch.func.jacrev(lambda v: tmod(v[None, :])[0][0])(x[i])
        _, ld_auto = torch.linalg.slogdet(jac)
        np.testing.assert_allclose(float(ld[i].detach()), float(ld_auto.detach()), atol=1e-3)


def test_forward_only_flows():
    """Planar raises for ``inverse``; Radial has none, as in JAX."""
    with pytest.raises(NotImplementedError):
        TF.Planar(2).inverse(torch.zeros(1, 2))
    assert not hasattr(TF.Radial(2), "inverse") and not hasattr(JF.Radial, "inverse")


def test_invertible_linear_structure():
    """P a permutation, L unit lower triangular, W = P L (U + diag S)
    orthogonal at construction, the same structure for every module and
    left alone by ``flax_init_``; ``inverse`` inverts W at each call."""
    a, b = TF.InvertibleLinear(3), TF.InvertibleLinear(3)
    flax_init_(b, torch.Generator().manual_seed(9))
    for name, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[name]), name
    assert torch.equal(a.P.sum(0), torch.ones(3)) and torch.equal(a.P.sum(1), torch.ones(3))
    assert torch.equal(torch.diagonal(a.L), torch.ones(3))
    assert torch.count_nonzero(torch.triu(a.L, 1)) == 0
    w = a._w().detach().double()
    np.testing.assert_allclose((w @ w.T).numpy(), np.eye(3), atol=1e-6)
    with torch.no_grad():
        a.S.mul_(2.0)
        x = torch.randn(5, 3, generator=torch.Generator().manual_seed(1))
        np.testing.assert_allclose(a.inverse(a(x)[0])[0].numpy(), x.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# a mixed chain, the transition MLP, the initial draws
# ---------------------------------------------------------------------------


def test_mixed_flowchain_matches_jax():
    """``FlowChain`` of ActNorm, InvertibleLinear, NSFCoupling, MAF and
    NSFAutoregressive against JAX's: forward (z, prior log-prob, log-det)
    and inverse within CHAIN_TOL, and the gradients through both; each flow
    is given a context and ignores it."""
    dim = 2
    kinds = ("actnorm", "lu", "nsf_cl", "maf", "nsf_ar")
    jchain = JF.FlowChain(flows=[FLOWS[k][0](dim) for k in kinds], prior_std=1.5)
    tchain = TF.FlowChain([FLOWS[k][1](dim) for k in kinds], prior_std=1.5)
    variables = _pair(jchain, tchain, dim, seed=7)
    x = _inputs(LEAD + (dim,), 8, 2.0)
    ctx = _inputs(LEAD + (3,), 9)

    for inverse in (False, True):
        def jloss(params, x_):
            with jax.ensure_compile_time_eval():
                out = jchain.apply({**variables, "params": params}, x_, jnp.asarray(ctx),
                                   method=jchain.inverse if inverse else jchain.forward)
            return _loss(out[0], out[-1], jnp) + (0.0 if inverse else jnp.sum(out[1])), out
        (g_params, g_x), ref = jax.jit(jax.grad(jloss, argnums=(0, 1), has_aux=True))(
            variables["params"], jnp.asarray(x))
        tchain.zero_grad()
        tx = _t(x).requires_grad_()
        out = (tchain.inverse if inverse else tchain)(tx, _t(ctx))
        (_loss(out[0], out[-1], torch) + (0.0 if inverse else torch.sum(out[1]))).backward()
        for got, want in zip(out, ref):
            _close(got, want, CHAIN_TOL)
        _grads_close({"x": tx.grad}, {"x": g_x})
        _grads_close({n: p.grad for n, p in tchain.named_parameters()},
                     flow_state_from_jax(tchain, {"params": g_params}))


def test_transition_mlp_matches_jax():
    """Outputs over (4, 5, 2) and the gradients of Σ sin(out) for the input
    and every parameter; the bridge maps ``Dense_i`` → ``fc{i+1}``."""
    jmod, tmod = JaxTransitionMLP(state_dim=2), TransitionMLP(2)
    variables = _shifted(jmod.init(jax.random.PRNGKey(1), jnp.zeros((1, 2))), 1)
    _load(tmod, mlp_state_from_jax(variables["params"]))
    s = _inputs(LEAD + (2,), 5)

    def jloss(params, s_):
        out = jmod.apply({"params": params}, s_)
        return jnp.sum(jnp.sin(out)), out
    (g_params, g_s), ref = jax.jit(jax.grad(jloss, argnums=(0, 1), has_aux=True))(
        variables["params"], jnp.asarray(s))
    ts = _t(s).requires_grad_()
    out = tmod(ts)
    torch.sum(torch.sin(out)).backward()
    _close(out, ref)
    _grads_close({"s": ts.grad}, {"s": g_s})
    _grads_close({n: p.grad for n, p in tmod.named_parameters()},
                 mlp_state_from_jax(g_params))


def test_initial_draws():
    """``flax_init_`` draws the uniform parameters from U[0, scale) in
    registration order (Planar/Radial 2·√(1/dim), MAF 2·√0.5, the spline's
    1.0), zeros ActNorm without a draw, and gives TransitionMLP flax's
    lecun-normal kernels and zero biases; JAX's initial draws lie in the
    same ranges.  Moments over 4,096 draws: mean within 4 standard errors
    of scale/2, standard deviation within 5 % of scale/√12."""
    dim = 4096
    planar = TF.Planar(dim)
    flax_init_(planar, torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    scale = 2 * (1.0 / dim) ** 0.5
    for name in ("w", "u", "b"):
        want = torch.empty(getattr(planar, name).shape).uniform_(0.0, scale, generator=gen)
        assert torch.equal(getattr(planar, name), want), name
    for draw in (planar.w, planar.u):
        assert 0.0 <= float(draw.min()) and float(draw.max()) < scale
        assert abs(float(draw.mean()) - scale / 2) < 4 * scale / (12 * dim) ** 0.5
        assert abs(float(draw.std()) / (scale / 12**0.5) - 1.0) < 0.05

    act = TF.ActNorm(2)
    with torch.no_grad():
        act.mu.fill_(1.0)
    mods = torch.nn.ModuleList([TF.Radial(2), TF.MAF(2), TF.NSFAutoregressive(2), act,
                                TransitionMLP(2)])
    flax_init_(mods, torch.Generator().manual_seed(5))
    ranges = {"0.x0": 2 * 0.5**0.5, "0.log_alpha": 2 * 0.5**0.5, "0.beta": 2 * 0.5**0.5,
              "1.initial_param": 2 * 0.5**0.5, "2.init_param": 1.0}
    state = mods.state_dict()
    for name, top in ranges.items():
        assert 0.0 <= float(state[name].min()) and float(state[name].max()) < top, name
    assert torch.count_nonzero(act.mu) == 0 and torch.count_nonzero(act.log_sigma) == 0
    mlp = mods[4]
    assert all(torch.count_nonzero(f.bias) == 0 for f in (mlp.fc1, mlp.fc2, mlp.fc3))
    assert abs(float(mlp.fc2.weight.std()) * 8.0 - 1.0) < 0.05     # lecun: 1/√64
    assert float(mlp.fc2.weight.abs().max()) <= 2.0 / 8.0 / 0.87962566  # truncated

    for kind, names, top in (("radial", ("x0", "log_alpha", "beta"), 2 * 0.5**0.5),
                             ("maf", ("initial_param",), 2 * 0.5**0.5),
                             ("nsf_ar", ("init_param",), 1.0)):
        params = FLOWS[kind][0](2).init(jax.random.PRNGKey(0), jnp.zeros((1, 2)))["params"]
        for name in names:
            assert 0.0 <= float(params[name].min()) and float(params[name].max()) < top
