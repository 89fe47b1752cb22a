"""nfdpf_torch resamplers vs the JAX package: the dense ε-annealed Sinkhorn
and ``ot_resample`` (both gradient modes, both convergence modes), the soft
systematic and multinomial resamplers, and the warm start of the streaming
OT resampler.  The invariants of tests/test_resampling.py and the warm-start
contracts of tests/test_pallas.py and tests/test_filter.py are mirrored on
the port.  Inputs come from numpy with a seed; JAX's random draws are
replayed as tensors; the JAX Pallas kernels run in interpret mode, the port
on the CPU through its kernels' plain versions."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfdpf_tpu.ops.pallas.sinkhorn_pallas as sp
import nfdpf_tpu.ops.resampling as jr
import nfdpf_tpu.ops.sinkhorn as js
import nfdpf_torch.ops.resampling as tr
import nfdpf_torch.ops.sinkhorn as ts
from nfdpf_torch.config import DPFConfig
from nfdpf_torch.models.dpf import DPF
from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc
from nfdpf_torch.ops.density import effective_sample_size, weighted_mean


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(sp, "_INTERPRET", True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _cloud(seed, b=2, n=32, scale=3.0):
    """Particles N(0, scale²) and softmax weights of N(0, 1) logits."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, n, 2)) * scale).astype(np.float32)
    lw = rng.standard_normal((b, n))
    probs = (np.exp(lw) / np.exp(lw).sum(-1, keepdims=True)).astype(np.float32)
    return x, probs


# ---------------------------------------------------------------------------
# the dense Sinkhorn against the JAX package
# ---------------------------------------------------------------------------


def _jax_scaled(x):
    """The centred, diameter·√d-scaled cloud ``sinkhorn_transport`` feeds the
    loop, computed by the JAX package."""
    xj = _j(x)
    centered = xj - jnp.mean(xj, axis=1, keepdims=True)
    return np.asarray(centered / (js.diameter(xj, xj)[:, None, None] * math.sqrt(2)))


@pytest.mark.parametrize("seed,n,convergence,max_iter",
                         [(0, 37, "all", 100), (1, 24, "any", 100), (2, 37, "all", 5)])
def test_sinkhorn_loop_matches_jax(seed, n, convergence, max_iter):
    """Same iteration count (the loop's plus 2) and potentials within
    rtol/atol 1e-5; the last case stops on ``max_iter``."""
    x, probs = _cloud(seed, b=3, n=n)
    scaled = _jax_scaled(x)
    logw = np.log(probs)
    uniform = np.full_like(logw, -math.log(n))
    args = (0.1, 0.75, 1e-3, max_iter, convergence)
    a_ref, b_ref, it_ref = js.sinkhorn_potentials(_j(logw), _j(scaled), _j(uniform),
                                                  _j(scaled), *args)
    a, b, it = ts.sinkhorn_potentials(_t(logw), _t(scaled), _t(uniform), _t(scaled), *args)
    assert it == int(it_ref) > 2
    if max_iter == 5:
        assert it == max_iter + 1
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("convergence", ["all", "any"])
@pytest.mark.parametrize("transport_grad", [False, True], ids=["detached", "transport_grad"])
def test_ot_resample_matches_jax(transport_grad, convergence):
    """Resampled particles, weights and indices within rtol/atol 1e-5; the
    loop's iterations equal JAX's; the gradient of a probe against the
    particles (both modes) and the weights (transport_grad) within rtol 1e-4
    / atol 1e-5; without transport_grad the weights get none."""
    x, probs = _cloud(3, b=2, n=29, scale=2.0)
    probe = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    kw = dict(eps=0.1, scaling=0.75, threshold=1e-3, max_iter=100,
              transport_grad=transport_grad, convergence=convergence)

    def loss(p, w):
        return jnp.sum(js.ot_resample(p, w, **kw)[0] * probe)

    out_ref = js.ot_resample(_j(x), _j(probs), **kw)
    g_ref = jax.grad(loss, argnums=(0, 1))(_j(x), _j(probs))
    scaled = _jax_scaled(x)
    it_ref = js.sinkhorn_potentials(
        jnp.log(_j(probs)), _j(scaled), jnp.full((2, 29), -math.log(29)), _j(scaled),
        0.1, 0.75, 1e-3, 100, convergence)[2]

    tx, tw = _t(x).requires_grad_(), _t(probs).requires_grad_()
    ts.reset_dense_loop()
    out = ts.ot_resample(tx, tw, **kw)
    assert ts.DENSE_LOOP["calls"] == 1 and ts.DENSE_LOOP["iters"] == int(it_ref)
    # a host read per loop test; the last is skipped when max_iter ends the loop
    assert ts.DENSE_LOOP["host_syncs"] == min(int(it_ref) - 1, 99)
    for got, ref in zip(out, out_ref):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    g_x, g_w = torch.autograd.grad(torch.sum(out[0] * _t(probe)), [tx, tw], allow_unused=True)
    np.testing.assert_allclose(g_x.numpy(), np.asarray(g_ref[0]), rtol=1e-4, atol=1e-5)
    if transport_grad:
        assert float(np.abs(np.asarray(g_ref[1])).sum()) > 0
        np.testing.assert_allclose(g_w.numpy(), np.asarray(g_ref[1]), rtol=1e-4, atol=1e-5)
    else:
        assert g_w is None and not np.asarray(g_ref[1]).any()


def test_transport_from_potentials_matches_jax():
    """The plan from given potentials, rtol/atol 1e-5."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 13, 2)) * 0.5).astype(np.float32)
    f, g = (rng.standard_normal((2, 2, 13)) * 0.05).astype(np.float32)
    logw = np.log(rng.dirichlet(np.ones(13), 2)).astype(np.float32)
    ref = js.transport_from_potentials(_j(x), _j(f), _j(g), 0.1, _j(logw), 13)
    got = ts.transport_from_potentials(_t(x), _t(f), _t(g), 0.1, _t(logw), 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the invariants of tests/test_resampling.py, on the port
# ---------------------------------------------------------------------------


def test_transport_matrix_marginals():
    """Columns sum to n·w_j (rtol 1e-3), rows to about 1 (atol 0.05)."""
    x, probs = _cloud(6, b=2, n=64)
    t = ts.sinkhorn_transport(_t(x), torch.log(_t(probs)), eps=0.1, scaling=0.9,
                              threshold=1e-4, max_iter=500, convergence="any")
    np.testing.assert_allclose(t.sum(dim=1).numpy(), 64 * probs, rtol=1e-3)
    np.testing.assert_allclose(t.sum(dim=2).numpy(), 1.0, atol=0.05)


def test_ot_resample_preserves_mean_and_restores_ess():
    x, probs = _cloud(7, b=2, n=64)
    p_r, w_r, idx = ts.ot_resample(_t(x), _t(probs), eps=0.1, scaling=0.9, threshold=1e-4,
                                   max_iter=500, convergence="any")
    assert float(effective_sample_size(w_r)) == pytest.approx(64, rel=1e-5)
    np.testing.assert_allclose(weighted_mean(p_r, w_r).numpy(),
                               weighted_mean(_t(x), _t(probs)).numpy(), atol=0.1)
    assert torch.equal(idx[0], torch.arange(64, dtype=torch.int32))


def test_ot_gradient_topology_reference_mode():
    """transport_grad=False: the weights' gradient is exactly zero, the
    particles' is not."""
    x, probs = _cloud(8, b=1, n=32)
    tw = _t(probs).requires_grad_()
    p_r, _, _ = ts.ot_resample(_t(x), tw / tw.sum(-1, keepdim=True), max_iter=20)
    assert not p_r.requires_grad
    tx = _t(x).requires_grad_()
    p_r, _, _ = ts.ot_resample(tx, _t(probs), max_iter=20)
    (g_x,) = torch.autograd.grad(torch.sum(p_r**2), [tx])
    assert float(g_x.abs().sum()) > 0


def test_ot_gradient_topology_true_otdpf_mode():
    """transport_grad=True: the gradient flows through T into the weights."""
    x, probs = _cloud(9, b=1, n=16)
    tw = _t(probs).requires_grad_()
    p_r, _, _ = ts.ot_resample(_t(x), tw / tw.sum(-1, keepdim=True), max_iter=50,
                               transport_grad=True)
    (g_w,) = torch.autograd.grad(torch.sum(p_r**2), [tw])
    assert float(g_w.abs().sum()) > 0


def test_systematic_indices_valid_and_proportional():
    """Index i is chosen ⌊N·w_i⌋ or ⌈N·w_i⌉ times."""
    _, probs = _cloud(0, b=2, n=128)
    offset = torch.rand(2, 1, generator=torch.Generator().manual_seed(1)) / 128
    idx = tr.systematic_indices(_t(probs), offset)
    assert idx.dtype == torch.int32 and idx.shape == (2, 128)
    assert int(idx.min()) >= 0 and int(idx.max()) < 128
    for b in range(2):
        counts = np.bincount(idx[b].numpy(), minlength=128)
        assert np.all(counts >= np.floor(probs[b] * 128) - 1e-6)
        assert np.all(counts <= np.ceil(probs[b] * 128) + 1e-6)


def test_soft_resample_importance_correction():
    """Over 200 offsets, the mean of Σ w'_i x'_i is Σ w_i x_i (atol 0.15)."""
    x, probs = _cloud(2, b=1, n=256)
    gen = torch.Generator().manual_seed(0)
    means = [weighted_mean(*tr.soft_systematic_resample(_t(x), _t(probs), 0.5,
                                                        generator=gen)[:2]).numpy()[0]
             for _ in range(200)]
    np.testing.assert_allclose(np.mean(means, axis=0),
                               weighted_mean(_t(x), _t(probs)).numpy()[0], atol=0.15)


def test_soft_resample_alpha_one_uniform_weights():
    x, probs = _cloud(3, b=4, n=64)
    _, w_r, _ = tr.soft_systematic_resample(_t(x), _t(probs), 1.0,
                                            generator=torch.Generator().manual_seed(4))
    np.testing.assert_allclose(w_r.numpy(), 1.0 / 64, rtol=1e-5)


def test_soft_resample_gradient_flows_through_particles_and_weights():
    x, probs = _cloud(5, b=1, n=32)
    tx, tw = _t(x).requires_grad_(), _t(probs).requires_grad_()
    p_r, w_r, _ = tr.soft_systematic_resample(tx, tw, 0.5, torch.full((1, 1), 0.01))
    g_x, g_w = torch.autograd.grad(torch.sum(weighted_mean(p_r, w_r) ** 2), [tx, tw])
    assert float(g_x.abs().sum()) > 0 and float(g_w.abs().sum()) > 0


def test_soft_resample_refuses_alpha_outside_unit_interval():
    x, probs = _cloud(5, b=1, n=8)
    with pytest.raises(ValueError, match="alpha"):
        tr.soft_systematic_resample(_t(x), _t(probs), 0.0, torch.zeros(1, 1))


# ---------------------------------------------------------------------------
# soft and multinomial resampling against the JAX package, same draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 100, 10240])
def test_systematic_grid_has_the_jax_bits(n):
    """The markers' grid equals ``jnp.linspace(0, (n−1)/n, n)`` bit for bit
    as the JAX package computes it (compiled)."""
    ref = np.asarray(jax.jit(lambda: jnp.linspace(0.0, (n - 1.0) / n, n))())
    got = tr.systematic_basic(n).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("alpha", [0.5, 1.0])
@pytest.mark.parametrize("n", [37, 100])
def test_soft_systematic_resample_matches_jax(alpha, n):
    """The JAX offsets replayed: indices equal, particles exact, weights
    within 1e-6; the gradient against particles and weights within rtol
    1e-5 / atol 1e-6."""
    x, probs = _cloud(11, b=3, n=n)
    key = jax.random.PRNGKey(n)
    offset = np.asarray(jax.random.uniform(key, (3, 1), minval=0.0, maxval=1.0 / n))
    probe = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def loss(p, w):
        p_r, w_r, _ = jr.soft_systematic_resample(key, p, w, alpha)
        return jnp.sum(p_r * probe * w_r[..., None])

    p_ref, w_ref, i_ref = jr.soft_systematic_resample(key, _j(x), _j(probs), alpha)
    g_ref = jax.grad(loss, argnums=(0, 1))(_j(x), _j(probs))
    tx, tw = _t(x).requires_grad_(), _t(probs).requires_grad_()
    p, w, idx = tr.soft_systematic_resample(tx, tw, alpha, _t(offset))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(
        tr.systematic_indices(_t(probs), _t(offset)).numpy(),
        np.asarray(jr.systematic_indices(key, _j(probs))))
    np.testing.assert_array_equal(p.detach().numpy(), np.asarray(p_ref))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(w_ref), rtol=0, atol=1e-6)
    # at alpha = 1 the weights are uniform: no gradient reaches ``probs``
    grads = torch.autograd.grad(torch.sum(p * _t(probe) * w[..., None]), [tx, tw],
                                allow_unused=True)
    for got, ref in zip(grads, g_ref):
        got = torch.zeros(ref.shape) if got is None else got
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_multinomial_resample_matches_jax_draws():
    """Each row's uniforms replayed from JAX's per-row keys: the same
    indices; weights uniform; indices valid."""
    x, probs = _cloud(12, b=3, n=50)
    key = jax.random.PRNGKey(3)
    uniform = np.stack([np.asarray(jax.random.uniform(k, (50,)))
                        for k in jax.random.split(key, 3)])
    _, w_ref, i_ref = jr.multinomial_resample(key, _j(x), _j(probs))
    p, w, idx = tr.multinomial_resample(_t(x), _t(probs), _t(uniform))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(p.numpy(), np.take_along_axis(x, idx.numpy()[..., None], 1))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref))
    _, w, idx = tr.multinomial_resample(_t(x), _t(probs),
                                        generator=torch.Generator().manual_seed(0))
    assert idx.dtype == torch.int32 and 0 <= int(idx.min()) and int(idx.max()) < 50
    np.testing.assert_allclose(w.numpy(), 1.0 / 50)


# ---------------------------------------------------------------------------
# the warm start of the streaming resampler (mirrors tests/test_pallas.py)
# ---------------------------------------------------------------------------

KW = dict(eps=0.1, scaling=0.75, threshold=1e-3, max_iter=100)


def _pallas_cloud(seed):
    """tests/test_pallas.py's cloud for ``PRNGKey(seed)``: its warm-start
    contracts are checked on the same data."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    x = jax.random.normal(k1, (2, 40, 2)) * 3.0
    return np.asarray(x), np.asarray(jax.nn.softmax(jax.random.normal(k2, (2, 40))))


def _drifted(x, probs):
    """The cloud a few motion steps later, as tests/test_pallas.py moves it."""
    x2 = _j(x) + 0.05 * jax.random.normal(jax.random.PRNGKey(7), x.shape)
    return np.asarray(x2), np.asarray(jax.nn.softmax(jnp.log(_j(probs)) * 1.1))


def test_warm_start_invalid_flag_is_the_cold_start():
    """Potentials marked not valid give the cold start's bits, and the
    potentials come back (B, 2, N)."""
    x, probs = _pallas_cloud(5)
    cold = sc.ot_resample_streaming(_t(x), _t(probs), **KW)
    warm = sc.ot_resample_streaming(_t(x), _t(probs), **KW,
                                    warm_start=(torch.zeros(2, 2, 40), False),
                                    return_potentials=True)
    assert torch.equal(warm[0], cold[0]) and warm[3] == cold[3] > 0
    assert warm[4].shape == (2, 2, 40)


@pytest.mark.parametrize("threshold,max_iter", [(1e-3, 100), (1e-4, 200)])
def test_warm_start_matches_jax(threshold, max_iter):
    """A warm firing from the JAX package's potentials of a first firing:
    the same iterations, particles within rtol 1e-5 / atol 1e-4, potentials
    within 1e-4; the warm start takes fewer iterations than the cold one."""
    x, probs = _pallas_cloud(6)
    kw = dict(KW, threshold=threshold, max_iter=max_iter)
    _, _, _, ex = sp.ot_resample_pallas(_j(x), _j(probs), **kw, return_extras=True)
    x2, probs2 = _drifted(x, probs)
    p_ref, _, _, ex2 = sp.ot_resample_pallas(
        _j(x2), _j(probs2), **kw, warm_start=(ex["potentials"], jnp.asarray(True)),
        return_extras=True)
    pots = torch.tensor(np.asarray(ex["potentials"]))
    p, _, _, iters, pots2 = sc.ot_resample_streaming(
        _t(x2), _t(probs2), **kw, warm_start=(pots, True), return_potentials=True)
    assert iters == int(ex2["iters"])
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pots2.numpy(), np.asarray(ex2["potentials"]), rtol=1e-4,
                               atol=1e-4)
    _, _, _, cold_iters = sc.ot_resample_streaming(_t(x2), _t(probs2), **kw)
    assert iters < cold_iters


def test_warm_start_same_fixed_point():
    """Warm and cold reach the same transport within the convergence slack
    (rtol 5e-2 / atol 0.35 at threshold 1e-3), and the gap shrinks below 0.05
    at threshold 1e-4."""
    x, probs = _pallas_cloud(6)
    x2, probs2 = _drifted(x, probs)
    gaps = []
    for threshold, max_iter in ((1e-3, 100), (1e-4, 200)):
        kw = dict(KW, threshold=threshold, max_iter=max_iter)
        *_, pots = sc.ot_resample_streaming(_t(x), _t(probs), **kw, return_potentials=True)
        p_cold = sc.ot_resample_streaming(_t(x2), _t(probs2), **kw)[0]
        p_warm = sc.ot_resample_streaming(_t(x2), _t(probs2), **kw,
                                          warm_start=(pots, True))[0]
        np.testing.assert_allclose(p_warm.numpy(), p_cold.numpy(), rtol=5e-2, atol=0.35)
        gaps.append(float((p_warm - p_cold).abs().max()))
    assert gaps[1] < 0.05


def test_warm_start_gradient_topology_unchanged():
    """Warm or cold, the gradient reaches the particles only through T @ x
    and the weights get none; the two agree within rtol 5e-2 / atol 5e-3."""
    x, probs = _pallas_cloud(8)
    *_, pots = sc.ot_resample_streaming(_t(x), _t(probs), **KW, return_potentials=True)
    grads = []
    for warm in (None, (pots, True)):
        tx, tw = _t(x).requires_grad_(), _t(probs).requires_grad_()
        out = sc.ot_resample_streaming(tx, tw, **KW, warm_start=warm)[0]
        g_x, g_w = torch.autograd.grad(torch.sum(out**2), [tx, tw], allow_unused=True)
        assert g_w is None and bool(torch.isfinite(g_x).all())
        grads.append(g_x)
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), rtol=5e-2, atol=5e-3)


def test_warm_start_refuses_potentials_of_another_shape():
    x, probs = _cloud(5, b=2, n=12)
    with pytest.raises(ValueError, match="potentials"):
        sc.ot_resample_streaming(_t(x), _t(probs), warm_start=(torch.zeros(2, 2, 11), True))


def test_filter_warm_start_streaming_ot():
    """tests/test_filter.py's contract on the port: firing every step from a
    uniform start, the first firing takes the same iterations warm and cold,
    and the later ones together at most 1.1× the cold ones."""
    iters = {}
    rng = np.random.default_rng(2)
    enc = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    start = torch.from_numpy((rng.standard_normal((2, 4)) * 5).astype(np.float32))
    vel = torch.from_numpy((rng.standard_normal((2, 5, 2)) * 2).astype(np.float32))
    for warm in (False, True):
        cfg = DPFConfig(num_particles=16, sequence_length=5, batch_size=2,
                        resampler_type="ot", use_pallas=True, sinkhorn_warm_start=warm,
                        ess_threshold=1.1)
        with torch.no_grad():
            out = DPF(cfg, device="cpu").filter_from_encodings(
                enc, start, vel, generator=torch.Generator().manual_seed(0))
        assert bool((out.sinkhorn_iters > 0).all())
        assert bool(torch.isfinite(out.particles).all())
        iters[warm] = out.sinkhorn_iters.numpy()
    assert iters[True][0] == iters[False][0]
    assert iters[True][1:].sum() <= iters[False][1:].sum() * 1.1
