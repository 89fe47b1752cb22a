"""The CNF-DPF slice of nfdpf_torch (RealNVP dynamics + RealNVP proposal,
OT resampling on the streaming path) vs the JAX package: the filter loop and
one full training step, on the packed-chain route (``pallas_coupling``) and
on the ``FlowChain`` module route.  Parameters cross through the bridge,
noise replays the JAX key schedule (the flows draw nothing), the JAX Pallas
kernels run in interpret mode and the port runs on the CPU through its
kernels' plain versions.

The flows' weights are scaled up from their N(0, 0.01²) init (×10) before
both packages get them: at init the flows are near the identity and a
wrong flow would pass."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nfdpf_tpu.ops.pallas.coupling_pallas as cp
import nfdpf_tpu.ops.pallas.sinkhorn_pallas as sp
from nfdpf_tpu.config import DPFConfig as JaxConfig
from nfdpf_tpu.models.dpf import DPF as JaxDPF
from nfdpf_tpu.train import Trainer as JaxTrainer
from nfdpf_torch.bridge import load_jax_variables, torch_state_from_jax
from nfdpf_torch.config import DPFConfig
from nfdpf_torch.models.dpf import DPF
from nfdpf_torch.train import Trainer

# B·T = 10 frames as in tests/test_torch_train.py: with 8 frames the JAX CPU
# backend's float32 encoder gradient sits 1e-2 from a float64 run of the port
# while the port's float32 one sits 4e-6 from it (bootstrap and CNF alike)
B, N, T = 2, 16, 5
CNF = dict(num_particles=N, sequence_length=T, batch_size=B, width=128,
           resampler_type="ot", measurement="cos", train_type="DPF",
           use_pallas=True, compute_dtype="float32", ess_threshold=1.01,
           nf_dyn=True, nf_cond=True, pallas_coupling=True)
FLOW_SCALE = 10.0


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """torch on one intra-op thread for this file's tests, restored after
    them: the test workers share the machine's cores, and at 8 threads each
    the port's train steps spend their time waiting on one another
    (tests/test_torch_models.py's ``one_intra_op_thread``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(sp, "_INTERPRET", True)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scale_flows(tree):
    """``tree`` with the two chains' entries multiplied by FLOW_SCALE."""
    return {k: (jax.tree_util.tree_map(lambda a: a * FLOW_SCALE, v)
                if k in ("nf_dyn", "cond_model") else v) for k, v in tree.items()}


def _noise(key, with_vel, width=128.0):
    """Replay the JAX key schedule of ``Trainer._loss`` (train.py:90-91) and
    the filter (dpf.py:325,384; dynamics.py:38) as the port's noise dict."""
    out = {}
    if with_vel:
        k_vel, key, _ = jax.random.split(key, 3)
        out["vel"] = torch.tensor(np.asarray(jax.random.normal(k_vel, (B, T, 2))))
    k_init, k = jax.random.split(key)
    init = jax.random.uniform(k_init, (B, N, 2), minval=-width / 2, maxval=width / 2)
    motion = []
    for _ in range(T):
        k, _, k_motion = jax.random.split(k, 3)
        motion.append(np.asarray(jax.random.normal(k_motion, (B, N, 2))))
    out["init"] = torch.tensor(np.asarray(init))
    out["motion"] = torch.tensor(np.stack(motion))
    return out


# ---------------------------------------------------------------------------
# the filter
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_filter():
    je = JaxDPF(JaxConfig(**CNF))
    variables = _scale_flows(je.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((B, T, 32)).astype(np.float32)
    start = (rng.standard_normal((B, 4)) * 10).astype(np.float32)
    vel = (rng.standard_normal((B, T, 2)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(100)
    ref = je.filter_from_encodings(variables, jnp.asarray(enc), jnp.asarray(start),
                                   jnp.asarray(vel), key, train=True)
    return dict(variables=_np_tree(variables), enc=enc, start=start, vel=vel, key=key,
                ref=jax.tree_util.tree_map(np.asarray, ref))


@pytest.mark.parametrize("pallas_coupling", [True, False], ids=["packed", "module"])
def test_cnf_filter_from_encodings_matches_jax(jax_filter, pallas_coupling):
    """B=2, N=16, T=5, both flows on, every step resampled (ess 1.01).  Gate
    steps, ancestor indices and Sinkhorn iteration counts equal; histories
    within rtol 1e-5 plus atol 5e-4 (particles of magnitude ~100 that pass
    two flows and the transport per step), 1e-4 on the log terms."""
    jf = jax_filter
    ref = jf["ref"]
    pe = DPF(DPFConfig(**dict(CNF, pallas_coupling=pallas_coupling)), device="cpu")
    load_jax_variables(pe, jf["variables"])
    with torch.no_grad():
        out = pe.filter_from_encodings(torch.tensor(jf["enc"]), torch.tensor(jf["start"]),
                                       torch.tensor(jf["vel"]), _noise(jf["key"], False))
    assert out.resampled.all()
    np.testing.assert_array_equal(out.resampled.numpy(), ref.resampled)
    np.testing.assert_array_equal(out.sinkhorn_iters.numpy(), ref.sinkhorn_iters)
    np.testing.assert_array_equal(out.indices.numpy(), ref.indices)
    assert float(np.abs(ref.jacobians).max()) > 1e-2      # the dynamics flow is not idle
    assert float(np.abs(ref.priors - ref.likelihoods).max()) > 0
    for field, atol in (("particles", 5e-4), ("weights", 1e-6), ("noise", 1e-4),
                        ("likelihoods", 1e-4), ("jacobians", 1e-4), ("priors", 1e-4),
                        ("init_weights_log", 1e-6), ("obs_likelihood", 1e-4)):
        np.testing.assert_allclose(getattr(out, field).numpy(), getattr(ref, field),
                                   rtol=1e-5, atol=atol, err_msg=field)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.random((B, T, 128, 128, 3), dtype=np.float32),
        "state": (rng.standard_normal((B, T, 4)) * 10).astype(np.float32),
        "start_state": (rng.standard_normal((B, 4)) * 10).astype(np.float32),
    }


def _variables(params, rest):
    return _np_tree({k: {"params": params[k], **rest[k]} for k in params})


@pytest.fixture(scope="module")
def jax_step():
    """One JAX value_and_grad + Adam step of the CNF-DPF on a fixed batch."""
    trainer = JaxTrainer(JaxConfig(**CNF))
    state = trainer.init_state(jax.random.PRNGKey(0))
    params = _scale_flows(state.params)
    opt_state = trainer.tx.init(params)
    batch = _batch(1)
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def step(params):
        (loss, aux), grads = jax.value_and_grad(trainer._loss, has_aux=True)(
            params, state.rest, jbatch, key, True)
        updates, _ = trainer.tx.update(grads, opt_state, params)
        return loss, aux, grads, optax.apply_updates(params, updates)

    loss, aux, grads, new_params = step(params)
    return dict(params=params, rest=state.rest, batch=batch, key=key, loss=loss, aux=aux,
                grads=grads, new_params=new_params)


def _port_trainer(params, rest, **overrides):
    trainer = Trainer(DPFConfig(**dict(CNF, **overrides)), device="cpu")
    load_jax_variables(trainer.engine, _variables(params, rest))
    return trainer


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("pallas_coupling", [True, False], ids=["packed", "module"])
def test_cnf_train_step_matches_jax(jax_step, pallas_coupling):
    """One CNF-DPF train step against the JAX one, on both coupling routes.

    * loss terms: rtol 1e-5; firings and Sinkhorn iterations: exact;
    * every parameter gradient, both chains' included and non-zero, as
      ‖g − g_jax‖/‖g_jax‖ per tensor: 1e-3 for the flows (their gradients
      pass T steps of transport and two exponentials per step), 1e-4 for the
      encoder and the measurement model, 1e-2 for the decoder (the backward
      of its last BatchNorm cancels most of the gradient; see
      tests/test_torch_train.py);
    * the parameters after the step: Adam (optax's defaults) applied to the
      port's own gradient, atol 1e-7; and the JAX step's parameters: every
      entry within 2·lr, 99.5 % of the entries within 1e-7.
    """
    js = jax_step
    trainer = _port_trainer(js["params"], js["rest"], pallas_coupling=pallas_coupling)
    before = {k: v.detach().clone() for k, v in trainer.engine.named_parameters()}
    metrics = trainer.train_step(js["batch"], noise=_noise(js["key"], True))

    aux = js["aux"]
    assert metrics["resample_count"] == int(aux["resample_count"]) == T
    assert metrics["sinkhorn_iters"] == int(aux["sinkhorn_iters"]) > 0
    for k, ref in (("loss", js["loss"]), ("loss_sup", aux["loss_sup"]),
                   ("loss_ae", aux["loss_ae"]), ("obs_likelihood", aux["obs_likelihood"])):
        np.testing.assert_allclose(float(metrics[k]), float(ref), rtol=1e-5, err_msg=k)

    grads = torch_state_from_jax(
        {k: {"params": v} for k, v in _np_tree(js["grads"]).items()})
    named = dict(trainer.engine.named_parameters())
    assert set(grads) == set(named)
    flows = [k for k in named if k.startswith(("nf_dyn.", "cond_model."))]
    assert len(flows) == 2 * 2 * 4 * 6
    for name, g_ref in grads.items():
        assert named[name].grad is not None, name
        if name in flows:
            bound = 1e-3
            # the output layers' biases always see a gradient; the chains are live
            if name.endswith("fc3.bias"):
                assert float(np.abs(g_ref).sum()) > 0, name
        else:
            bound = 1e-2 if name.startswith("decoder.") else 1e-4
        if float(np.linalg.norm(g_ref)) > 0:
            assert _rel(named[name].grad.numpy(), g_ref) < bound, name
        else:
            assert float(named[name].grad.abs().sum()) == 0, name
    for chain in ("nf_dyn.", "cond_model."):
        total = sum(float(named[k].grad.abs().sum()) for k in flows if k.startswith(chain))
        assert total > 0, chain

    tx = optax.adam(DPFConfig().lr)
    port_grads = {k: p.grad.numpy() for k, p in named.items()}
    params0 = {k: v.numpy() for k, v in before.items()}
    updates, _ = tx.update(port_grads, tx.init(params0), params0)
    for name, want in optax.apply_updates(params0, updates).items():
        np.testing.assert_allclose(named[name].detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-7, err_msg=name)

    # against the JAX step's own parameters.  Adam's first update is
    # −lr·g/(|g| + 1e-8), close to −lr·sign(g): where the two gradients
    # agree in sign the entries agree to 1e-7, and an entry whose gradient is
    # near zero and differs in sign moves by at most 2·lr the other way.
    after_jax = torch_state_from_jax(
        {k: {"params": v} for k, v in _np_tree(js["new_params"]).items()})
    assert set(after_jax) == set(named)
    lr = DPFConfig().lr
    total = close = 0
    for name, want in after_jax.items():
        diff = np.abs(named[name].detach().numpy() - want)
        assert float(diff.max()) <= 2 * lr + 1e-7, name
        total += diff.size
        close += int((diff <= 1e-7).sum())
    assert close >= 0.995 * total, (close, total)


@pytest.mark.parametrize("switches", [dict(nf_dyn=True, nf_cond=False),
                                      dict(nf_dyn=False, nf_cond=True)],
                         ids=["nf_dyn_only", "nf_cond_only"])
def test_single_flow_loss_matches_jax(jax_step, switches):
    """Each flow alone: the training-mode loss terms against JAX (rtol 1e-5);
    the unused chain gets no gradient (Adam then leaves it alone, which
    equals optax's update on a zero gradient), the used one does."""
    js = jax_step
    cfg = dict(CNF, **switches)
    jt = JaxTrainer(JaxConfig(**cfg))
    jbatch = {k: jnp.asarray(v) for k, v in js["batch"].items()}
    ref, ref_aux = jax.jit(lambda p: jt._loss(p, js["rest"], jbatch, js["key"], True))(
        js["params"])
    trainer = _port_trainer(js["params"], js["rest"], **switches)
    loss, aux = trainer._loss(js["batch"], True, _noise(js["key"], True))
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(aux["obs_likelihood"].detach()),
                               float(ref_aux["obs_likelihood"]),
                               rtol=1e-5)
    assert aux["sinkhorn_iters"] == int(ref_aux["sinkhorn_iters"])
    loss.backward()
    used, unused = (("nf_dyn", "cond_model") if switches["nf_dyn"]
                    else ("cond_model", "nf_dyn"))
    engine = trainer.engine
    assert all(p.grad is None for p in getattr(engine, unused).parameters())
    assert sum(float(p.grad.abs().sum()) for p in getattr(engine, used).parameters()) > 0


def test_cnf_eval_step_runs_without_grad(jax_step):
    """``eval_step`` on the CNF slice: finite losses, filled jacobians and
    priors of the expected shape, and no autograd graph."""
    js = jax_step
    trainer = _port_trainer(js["params"], js["rest"])
    metrics, aux = trainer.eval_step(js["batch"], noise=_noise(js["key"], True))
    out = aux["filter_out"]
    assert np.isfinite(float(metrics["loss"]))
    assert out.jacobians.shape == out.priors.shape == (B, T, N)
    assert float(out.jacobians.abs().max()) > 0 and not out.particles.requires_grad


# ---------------------------------------------------------------------------
# the bridge stays strict
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("missing", ["nf_dyn", "cond_model"])
def test_bridge_needs_the_flow_subtrees(jax_step, missing):
    """``load_jax_variables`` covers every parameter or raises: a variables
    tree without a chain's subtree is refused, and so is one with a chain of
    another depth."""
    js = jax_step
    engine = DPF(DPFConfig(**CNF), device="cpu")
    variables = _variables(js["params"], js["rest"])
    without = {k: v for k, v in variables.items() if k != missing}
    with pytest.raises(KeyError):
        load_jax_variables(engine, without)
    shallow = dict(variables)
    shallow[missing] = {"params": {"flows_0": variables[missing]["params"]["flows_0"]}}
    with pytest.raises(KeyError, match="bridge mismatch"):
        load_jax_variables(engine, shallow)


# ---------------------------------------------------------------------------
# flow width 16, and the padding of widths 9-15
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_step_h16():
    """One JAX value_and_grad of the CNF-DPF at ``flow_hidden_dim=16`` on
    the packed path (``pallas_coupling``)."""
    cfg = dict(CNF, flow_hidden_dim=16)
    trainer = JaxTrainer(JaxConfig(**cfg))
    state = trainer.init_state(jax.random.PRNGKey(0))
    params = _scale_flows(state.params)
    batch = _batch(1)
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, aux), grads = jax.jit(lambda p: jax.value_and_grad(trainer._loss, has_aux=True)(
        p, state.rest, jbatch, key, True))(params)
    return dict(params=params, rest=state.rest, batch=batch, key=key, loss=loss,
                aux=aux, grads=grads)


def test_cnf_h16_train_step_matches_jax(jax_step_h16):
    """The CNF-DPF with 16-wide conditioners, both flows on the packed route
    (here the kernels' plain version), against JAX's packed path: loss terms
    rtol 1e-5, firings and Sinkhorn iterations exact, gradients as in
    ``test_cnf_train_step_matches_jax`` (1e-3 for the flows, 1e-2 for the
    decoder, 1e-4 for the rest), both chains' non-zero."""
    js = jax_step_h16
    trainer = _port_trainer(js["params"], js["rest"], flow_hidden_dim=16)
    assert trainer.engine.nf_dyn.flows[0].t1.fc1.out_features == 16
    loss, aux = trainer._loss(js["batch"], True, _noise(js["key"], True))
    loss.backward()
    ref_aux = js["aux"]
    assert aux["resample_count"] == int(ref_aux["resample_count"]) == T
    assert aux["sinkhorn_iters"] == int(ref_aux["sinkhorn_iters"]) > 0
    for k, got, ref in (("loss", loss, js["loss"]), ("loss_sup", aux["loss_sup"],
                                                     ref_aux["loss_sup"]),
                        ("obs_likelihood", aux["obs_likelihood"], ref_aux["obs_likelihood"])):
        np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5, err_msg=k)
    grads = torch_state_from_jax(
        {k: {"params": v} for k, v in _np_tree(js["grads"]).items()})
    named = dict(trainer.engine.named_parameters())
    for name, g_ref in grads.items():
        if name.startswith(("nf_dyn.", "cond_model.")):
            bound = 1e-3
        else:
            bound = 1e-2 if name.startswith("decoder.") else 1e-4
        if float(np.linalg.norm(g_ref)) > 0:
            assert _rel(named[name].grad.numpy(), g_ref) < bound, name
    for chain in ("nf_dyn.", "cond_model."):
        assert sum(float(p.grad.abs().sum()) for k, p in named.items()
                   if k.startswith(chain)) > 0, chain


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("ctx_dim", [4, 36])
def test_padded_chain_equals_the_unpadded_one(ctx_dim, inverse):
    """A 12-wide packed chain zero-padded to 16 (``pad_hidden``, what the
    CUDA route runs for widths 9-15) gives the outputs and log-det of the
    unpadded plain chain within 1e-6 + 1e-6·|ref| (padded units add exact
    zeros; only the order of float32 products can differ), and gradients of
    x, ctx and the unpadded weights and biases within 1e-6·max|ref|: the
    padding's own gradients are sliced away."""
    from nfdpf_torch.models.nets import flax_init_
    from nfdpf_torch.ops.cuda import coupling_cuda as cc
    from nfdpf_torch.ops.flows import realnvp_chain

    gen = torch.Generator().manual_seed(ctx_dim)
    chain = realnvp_chain(2, 2, 12, 0.3, ctx_dim=ctx_dim)
    flax_init_(chain, gen)
    x = torch.randn(3, 10, 2, generator=gen)
    ctx = torch.randn(3, 1, ctx_dim, generator=gen).expand(3, 10, ctx_dim)
    gy, gld = torch.randn(3, 10, 2, generator=gen), torch.randn(3, 10, generator=gen)
    with torch.no_grad():
        w, b = cc.pack_chain_params(chain)
    assert cc.kernel_hidden(12) == 16 and cc.kernel_hidden(8) == 8
    assert cc.kernel_hidden(17) == 17
    results = []
    for pad in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, ctx, w, b)]
        wp, bp = cc.pad_hidden(leaves[2], leaves[3], 16) if pad else leaves[2:]
        if pad:
            assert wp.shape == (2, 4, 3, max(1 + ctx_dim, 16), 16) and bp.shape[-1] == 16
        y, ld = cc.chain_apply_packed_plain(leaves[0], leaves[1], wp, bp, inverse)
        grads = torch.autograd.grad([y, ld], leaves, [gy, gld])
        results.append((y.detach(), ld.detach(), grads))
    (y0, ld0, g0), (y1, ld1, g1) = results
    torch.testing.assert_close(y1, y0, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ld1, ld0, rtol=1e-6, atol=1e-6)
    for name, a, ref in zip(("x", "ctx", "weights", "biases"), g1, g0):
        assert a.shape == ref.shape, name
        assert float((a - ref).abs().max()) <= 1e-6 * float(ref.abs().max()), name
