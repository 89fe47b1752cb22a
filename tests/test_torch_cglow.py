"""The conditional-GLOW measurement of nfdpf_torch vs the JAX package: the
batched small-matrix linear algebra (against JAX and against float64
``torch.linalg``), the squeeze layout, the whole ``CondGlowModel`` (nll,
gradients with respect to its inputs and every parameter, decode) through
the parameter bridge, the ``CGlowMeasurement`` and the bridge round trip of
a CGLOW engine.  The cases of tests/test_cglow_parity.py, held here to the
JAX package (which that file holds to the absent PyTorch original)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfdpf_tpu.config import DPFConfig as JaxConfig
from nfdpf_tpu.models import cglow as jcg
from nfdpf_tpu.models.dpf import DPF as JaxDPF
from nfdpf_tpu.ops import linalg as jlinalg
from nfdpf_torch.bridge import cglow_state_from_jax, load_jax_variables, torch_state_from_jax
from nfdpf_torch.config import DPFConfig
from nfdpf_torch.models import cglow as tcg
from nfdpf_torch.models.dpf import DPF
from nfdpf_torch.models.nets import flax_init_
from nfdpf_torch.ops import linalg as tlinalg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# linalg (mirrors tests/test_linalg.py)
# ---------------------------------------------------------------------------


def _well_conditioned(seed, b, n):
    """tanh-bounded entries and a diagonal boost: the regime Cond1x1Conv's
    tanh head produces."""
    w = np.random.default_rng(seed).standard_normal((b, n, n))
    return (np.tanh(w) + 2.0 * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n", [2, 3, 12])
def test_logabsdet_matches_jax_and_float64(n):
    """Values within rtol/atol 1e-5 of JAX's elimination and of float64
    ``slogdet``."""
    w = _well_conditioned(n, 64, n)
    got = tlinalg.logabsdet(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlinalg.logabsdet(jnp.asarray(w))),
                               rtol=1e-5, atol=1e-5)
    want = torch.linalg.slogdet(torch.from_numpy(w).double())[1].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_logabsdet_with_negative_determinant():
    """Two rows swapped: the sign flips, log|det| does not."""
    w = _well_conditioned(1, 8, 5)
    wneg = torch.from_numpy(w[:, [1, 0, 2, 3, 4], :])
    np.testing.assert_allclose(tlinalg.logabsdet(wneg).numpy(),
                               tlinalg.logabsdet(torch.from_numpy(w)).numpy(), rtol=1e-6)
    sign, want = torch.linalg.slogdet(wneg.double())
    assert bool((sign < 0).any())
    np.testing.assert_allclose(tlinalg.logabsdet(wneg).numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_logabsdet_gradient_is_analytic():
    """The gradient W⁻ᵀ·ḡ against JAX's custom VJP and float64 autograd of
    ``slogdet``, within rtol 1e-4 / atol 1e-5."""
    w = _well_conditioned(2, 16, 12)
    probe = np.random.default_rng(3).standard_normal(16).astype(np.float32)
    g_jax = jax.grad(lambda a: jnp.sum(jlinalg.logabsdet(a) * probe))(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(tlinalg.logabsdet(tw) * torch.from_numpy(probe)), [tw])
    w64 = torch.from_numpy(w).double().requires_grad_()
    (g64,) = torch.autograd.grad(torch.sum(torch.linalg.slogdet(w64)[1]
                                           * torch.from_numpy(probe).double()), [w64])
    np.testing.assert_allclose(g.numpy(), np.asarray(g_jax), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), g64.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [2, 3, 12])
def test_inv_matches_jax_and_float64(n):
    """Gauss-Jordan + one Newton step within rtol 1e-4 / atol 1e-5 of JAX's
    and of float64 ``inv``."""
    w = _well_conditioned(10 + n, 64, n)
    got = tlinalg.inv(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlinalg.inv(jnp.asarray(w))), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got, torch.linalg.inv(torch.from_numpy(w).double()).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_inv_gradient_is_analytic():
    """−Yᵀ ḡ Yᵀ against JAX's custom VJP and float64 autograd of ``inv``."""
    w = _well_conditioned(4, 8, 6)
    t = np.random.default_rng(5).standard_normal(w.shape).astype(np.float32)
    g_jax = jax.grad(lambda a: jnp.sum(jlinalg.inv(a) * t))(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(tlinalg.inv(tw) * torch.from_numpy(t)), [tw])
    w64 = torch.from_numpy(w).double().requires_grad_()
    (g64,) = torch.autograd.grad(torch.sum(torch.linalg.inv(w64) * torch.from_numpy(t).double()),
                                 [w64])
    np.testing.assert_allclose(g.numpy(), np.asarray(g_jax), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), g64.numpy(), rtol=1e-4, atol=1e-5)


def test_pivoting_handles_zero_leading_entry():
    """A zero leading entry: elimination without pivoting would divide by 0."""
    w = torch.tensor([[[0.0, 1.0], [1.0, 0.5]]])
    np.testing.assert_allclose(float(tlinalg.logabsdet(w)[0]), 0.0, atol=1e-6)
    np.testing.assert_allclose(tlinalg.inv(w)[0].numpy(), torch.linalg.inv(w)[0].numpy(),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the conditional GLOW
# ---------------------------------------------------------------------------


def test_squeeze_matches_jax_bitwise():
    """space-to-depth with the (c, fh, fw) channel order, and back."""
    x = np.random.default_rng(0).standard_normal((3, 8, 4, 5)).astype(np.float32)
    sq = tcg.squeeze2d(torch.from_numpy(x))
    np.testing.assert_array_equal(sq.numpy(), np.asarray(jcg.squeeze2d(jnp.asarray(x))))
    back = tcg.unsqueeze2d(sq)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jcg.unsqueeze2d(jnp.asarray(sq.numpy()))))
    np.testing.assert_array_equal(back.numpy(), x)


def _randomise(params, key, std=0.15):
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(key, len(leaves))
    return jax.tree_util.tree_unflatten(
        treedef, [std * jax.random.normal(k, a.shape, a.dtype) for k, a in zip(keys, leaves)])


def _glow_pair(flow_depth, num_levels, learn_top, seed):
    """A JAX ``CondGlowModel`` with every parameter drawn from N(0, 0.15²)
    (tests/test_cglow_parity.py's draw) and the port's loaded from it."""
    model = jcg.CondGlowModel(flow_depth=flow_depth, num_levels=num_levels, learn_top=learn_top)
    x0 = jnp.zeros((2, 8, 8, 3))
    params = _randomise(model.init(jax.random.PRNGKey(0), x0, x0)["params"],
                        jax.random.PRNGKey(seed))
    port = tcg.CondGlowModel(flow_depth=flow_depth, num_levels=num_levels, learn_top=learn_top)
    state = cglow_state_from_jax(_np_tree(params))
    assert set(state) == set(port.state_dict())
    port.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return model, params, port


def _inputs(seed, b=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, 8, 8, 3)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("flow_depth,num_levels,learn_top",
                         [(1, 1, False), (2, 1, False), (1, 2, False), (1, 2, True)])
def test_cglow_nll_and_gradients_match_jax(flow_depth, num_levels, learn_top):
    """(z, nll) within rtol/atol 1e-5; the gradient of mean(nll) with respect
    to the condition, the target and every parameter, as ‖Δ‖/‖g‖ per tensor,
    within 1e-4.  The condition's gradient crosses the analytic backward of
    ``logabsdet`` (the 1×1 convolution's weight is made from it)."""
    model, params, port = _glow_pair(flow_depth, num_levels, learn_top, 42 + flow_depth)
    x, y = _inputs(7)

    @jax.jit
    def fwd_grad(x_, y_, p):
        def loss(x_, y_, p):
            z, nll = model.apply({"params": p}, x_, y_)
            return jnp.mean(nll), (z, nll)
        return jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(x_, y_, p)

    (_, (z, nll)), (gx, gy, gp) = fwd_grad(jnp.asarray(x), jnp.asarray(y), params)
    tx, ty = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    tz, tnll = port(tx, ty)
    np.testing.assert_allclose(tnll.detach().numpy(), np.asarray(nll), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(z), rtol=1e-5, atol=1e-5)
    tnll.mean().backward()
    assert _rel(tx.grad.numpy(), gx) < 1e-4 and _rel(ty.grad.numpy(), gy) < 1e-4
    named = dict(port.named_parameters())
    ref = cglow_state_from_jax(_np_tree(gp))
    assert set(ref) == set(named)
    for name, g_ref in ref.items():
        assert np.linalg.norm(g_ref) > 0, name
        assert _rel(named[name].grad.numpy(), g_ref) < 1e-4, name


def _as_float64(module):
    return copy.deepcopy(module).double()


def _held_to_float64(got, ref_jax, ref64, atol):
    """``got`` (the port, float32) within ``atol`` of JAX's float32 result
    and of the port's float64 run.  Where the 1×1 convolution's weights are
    badly conditioned, two float32 runs differ by more than their rounding;
    float64 says which is off."""
    got = np.asarray(got, np.float64)
    assert np.abs(got - np.asarray(ref_jax)).max() <= atol
    assert np.abs(got - ref64).max() <= atol


def test_cglow_decode_matches_jax_and_inverts_encode():
    """decode(encode(y)) gives y back within 1e-4; decode on the JAX z
    (through the analytic inverse with its Newton step) within atol 1e-4 of
    JAX's decode and of the port's float64 decode: the drawn weights make
    float32 decodes, JAX's too, sit a few 1e-5 from float64."""
    model, params, port = _glow_pair(1, 1, False, 3)
    x, y = _inputs(9)
    z, _ = model.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
    y_ref, _ = model.apply({"params": params}, jnp.asarray(x), z, jnp.zeros(4),
                           method=jcg.CondGlowModel.decode)
    tx, tz_jax = torch.from_numpy(x), torch.tensor(np.asarray(z))
    with torch.no_grad():
        tz, _ = port(tx, torch.from_numpy(y))
        y_back, _ = port.decode(tx, tz, torch.zeros(4))
        y_dec, _ = port.decode(tx, tz_jax, torch.zeros(4))
        y64, _ = _as_float64(port).decode(tx.double(), tz_jax.double(),
                                          torch.zeros(4, dtype=torch.float64))
    np.testing.assert_allclose(y_back.numpy(), y, rtol=1e-4, atol=1e-4)
    _held_to_float64(y_dec.numpy(), y_ref, y64.numpy(), 1e-4)


def test_conv_resize_general_branch_matches_jax():
    """A resize whose stride is not its kernel (8 → 3: stride 2, kernel 4)
    takes the strided-convolution branch over the same flattened weight."""
    mod = jcg.ConvResize((8, 8), (3, 3), 5)
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(np.float32)
    params = _randomise(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                        jax.random.PRNGKey(1), std=0.3)
    conv = params["Conv_0"]
    port = tcg.ConvResize((8, 8), (3, 3), 4, 5)
    assert not port.patch
    with torch.no_grad():
        port.conv.weight.copy_(torch.tensor(np.asarray(conv["kernel"]).reshape(-1, 5)))
        port.conv.bias.copy_(torch.tensor(np.asarray(conv["bias"])))
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(mod.apply({"params": params},
                                                                 jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the measurement model and the engine
# ---------------------------------------------------------------------------

B, N = 2, 16
CGLOW = dict(num_particles=N, sequence_length=5, batch_size=B, width=128,
             resampler_type="ot", measurement="CGLOW", train_type="DPF", use_pallas=True,
             compute_dtype="float32")


@pytest.fixture(scope="module")
def cglow_engines():
    """A JAX CGLOW engine whose CGLOW parameters are drawn from N(0, 0.15²),
    and the port's loaded from it."""
    je = JaxDPF(JaxConfig(**CGLOW))
    variables = jax.jit(je.init)(jax.random.PRNGKey(4))   # compiled once, not op by op
    meas = variables["measurement"]["params"]
    variables["measurement"] = {"params": dict(
        meas, cglow=_randomise(meas["cglow"], jax.random.PRNGKey(5)))}
    pe = DPF(DPFConfig(**CGLOW), device="cpu")
    load_jax_variables(pe, _np_tree(variables))
    return je, variables, pe


def test_cglow_measurement_matches_jax(cglow_engines):
    """The measurement on (B, N) particles and 192-wide encodings (the NHWC
    reshape of both): log-likelihoods within atol 1e-4 of JAX's and of the
    port's float64 run (the 1×1 convolution's weights reach condition
    numbers of ~6e3 at these particles: JAX sits 2.5e-5 from float64, the
    port 1.2e-5); their gradient against the encodings and the particles as
    ‖Δ‖/‖g‖ within 1e-4 of the float64 run and 1e-3 of JAX's (whose float32
    gradient against the particles sits 1.8e-4 from float64, the port's
    2e-5)."""
    je, variables, pe = cglow_engines
    rng = np.random.default_rng(5)
    enc = rng.standard_normal((B, 192)).astype(np.float32)
    particles = (rng.standard_normal((B, N, 2)) * 40).astype(np.float32)
    probe = rng.standard_normal((B, N)).astype(np.float32)

    @jax.jit
    def value_and_grads(e, p):
        def fn(e, p):
            lik = je.measurement.apply(variables["measurement"], e, p)
            return jnp.sum(lik * probe), lik
        return jax.value_and_grad(fn, argnums=(0, 1), has_aux=True)(e, p)

    (_, ref), g_ref = value_and_grads(jnp.asarray(enc), jnp.asarray(particles))
    te, tp = torch.from_numpy(enc).requires_grad_(), torch.from_numpy(particles).requires_grad_()
    got = pe.measurement(te, tp)
    te64, tp64 = (t.detach().double().requires_grad_() for t in (te, tp))
    got64 = _as_float64(pe.measurement)(te64, tp64)
    _held_to_float64(got.detach().numpy(), ref, got64.detach().numpy(), 1e-4)
    assert float(got.detach().amax(-1).abs().max()) == 0.0     # the row maximum is taken off
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(probe)), [te, tp])
    grads64 = torch.autograd.grad(torch.sum(got64 * torch.from_numpy(probe).double()),
                                  [te64, tp64])
    for g, r, r64 in zip(grads, g_ref, grads64):
        assert _rel(g.numpy(), r) < 1e-3 and _rel(g.numpy(), r64.numpy()) < 1e-4


def test_cglow_engine_bridge_round_trip(cglow_engines):
    """The bridge covers every parameter and buffer of a CGLOW engine, with
    its encoder, decoder and proposal context at 192 (+4) wide, and carries
    each JAX value unchanged; an unknown entry inside the CGLOW subtree is
    refused."""
    _, variables, pe = cglow_engines
    state = torch_state_from_jax(_np_tree(variables))
    own = pe.state_dict()
    assert set(state) == set(own)
    for name, value in state.items():
        np.testing.assert_array_equal(own[name].numpy(), value, err_msg=name)
    assert pe.encoder.dense.out_features == 192 and pe.decoder.dense.in_features == 192
    assert pe.cond_model.flows[0].t1.fc1.in_features == 1 + 192 + 4
    assert pe.measurement.particle_encoder.fc3.out_features == 192
    broken = _np_tree(variables)
    broken["measurement"]["params"]["cglow"]["layer_mods_0"]["extra"] = {}
    with pytest.raises(KeyError, match="layer_mods_0"):
        torch_state_from_jax(broken)


def test_cglow_initialisation_follows_the_jax_initialisers():
    """``flax_init_`` gives the port's CGLOW the JAX package's initial
    values where they are constants (the zero-init resizes, dense layers and
    coupling head), and draws of the JAX scale elsewhere."""
    model = tcg.CondGlowModel(num_levels=2, learn_top=True)
    flax_init_(model, torch.Generator().manual_seed(0))
    named = {k: p.detach() for k, p in model.named_parameters()}
    zeros = [k for k in named if ".resize." in k or ".dense.0." in k or ".dense.1." in k
             or ".f3." in k or k.startswith("top_") or k.endswith("conv.bias")
             or ".affine.rx2." in k]
    assert zeros and all(float(named[k].abs().max()) == 0.0 for k in zeros)
    head = named["layer_mods.0.invconv.net.dense.2.bias"]
    assert 0.05 < float(head.std()) < 0.15
    assert 0.02 < float(named["layer_mods.0.affine.f1.actnorm.logs"].std()) < 0.1
    assert 0.05 < float(named["layer_mods.0.affine.rx1.conv.weight"].std()) < 0.15
