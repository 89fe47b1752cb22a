"""The SDPF semi-supervised training of nfdpf_torch vs the JAX package: the
blockwise ancestor walk and both pseudo-likelihoods on the same histories,
and one full SDPF training step (Gaussian prior with ``nf_dyn`` off, NF
prior with it on, and BASELINE config 5: the CGLOW measurement with the NF
dynamics) from the same parameters (through the bridge), noise and
semi-supervised mask.  The JAX mask comes from ``jax.random.permutation``,
which torch cannot replay, so it crosses as ``noise["mask"]``.  The JAX
Pallas kernels run in interpret mode; the port runs on the CPU through its
kernels' plain versions."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nfdpf_tpu.ops.pallas.coupling_pallas as cp
import nfdpf_tpu.ops.pallas.sinkhorn_pallas as sp
from nfdpf_tpu import losses as JL
from nfdpf_tpu.config import DPFConfig as JaxConfig
from nfdpf_tpu.train import Trainer as JaxTrainer
from nfdpf_tpu.train import _split_variables
from nfdpf_torch import losses as TL
from nfdpf_torch.bridge import load_jax_variables, torch_state_from_jax
from nfdpf_torch.config import DPFConfig
from nfdpf_torch.train import Trainer

# B·T = 10 frames, as tests/test_torch_cnf.py chose (at 8 the JAX CPU
# backend's float32 encoder gradient is off by 1e-2)
B, N, T = 2, 16, 5
BASE = dict(num_particles=N, sequence_length=T, batch_size=B, width=128,
            resampler_type="ot", measurement="cos", train_type="SDPF", labeled_ratio=0.5,
            block_length=2, use_pallas=True, compute_dtype="float32", ess_threshold=1.01)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(sp, "_INTERPRET", True)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the ancestor walk and the two pseudo-likelihoods
# ---------------------------------------------------------------------------


def _histories(seed, b=2, t=20, n=8):
    """Random filter histories as tests/test_losses.py draws them."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, n))
    weights = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {"weights": weights.astype(np.float32),
            "noise": (rng.standard_normal((b, t, n, 2)) * 2).astype(np.float32),
            "lik": rng.standard_normal((b, t, n)).astype(np.float32),
            "idx": rng.integers(0, n, (b, t, n)).astype(np.int32),
            "priors": rng.standard_normal((b, t, n)).astype(np.float32)}


# (T, block length): whole blocks, and a T that leaves a partial trailing block
WALKS = [(20, 5), (23, 10), (7, 2)]


@pytest.mark.parametrize("t,block", WALKS)
def test_ancestor_walk_matches_jax(t, block):
    """Q/b per batch element within rtol/atol 1e-5; the walk never resets
    its accumulator between blocks, so T=23 with blocks of 10 checks the
    carried sum and the ignored tail."""
    h = _histories(t, t=t)
    ref = JL._ancestor_walk(jnp.asarray(h["lik"]), jnp.asarray(h["idx"]),
                            jnp.asarray(h["priors"]), jnp.asarray(h["weights"]), block)
    got = TL._ancestor_walk(*(torch.from_numpy(h[k]) for k in ("lik", "idx", "priors",
                                                                "weights")), block)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,block", WALKS)
def test_pseudolikelihoods_match_jax(t, block):
    """Both losses within rtol/atol 1e-5, and their gradients against the
    likelihoods, the prior terms (NF) and the motion noise (Gaussian)
    within 1e-4 relative (‖Δ‖/‖g‖).  The NF loss gathers Jacobians it never
    adds: a change of them leaves it as it is."""
    h = _histories(100 + t, t=t)
    w, noise, lik, idx, pri = (h[k] for k in ("weights", "noise", "lik", "idx", "priors"))
    jac = np.random.default_rng(t).standard_normal(lik.shape).astype(np.float32)

    def j_gauss(noise_, lik_):
        return JL.pseudolikelihood_loss(jnp.asarray(w), noise_, lik_, jnp.asarray(idx),
                                        block_len=block, std_pos=2.0, std_vel=3.0)

    def j_nf(lik_, pri_):
        return JL.pseudolikelihood_loss_nf(jnp.asarray(w), jnp.asarray(noise), lik_,
                                           jnp.asarray(idx), jnp.asarray(jac), pri_,
                                           block_len=block)

    tw, tidx = torch.from_numpy(w), torch.from_numpy(idx)
    tn, tl, tp = (torch.from_numpy(a).requires_grad_() for a in (noise, lik, pri))
    got_g = TL.pseudolikelihood_loss(tw, tn, tl, tidx, block, 2.0, 3.0)
    got_nf = TL.pseudolikelihood_loss_nf(tw, tn, tl, tidx, torch.from_numpy(jac), tp, block)
    got_nf_jac = TL.pseudolikelihood_loss_nf(tw, tn, tl, tidx, torch.zeros_like(tl), tp, block)
    assert float(got_nf.detach()) == float(got_nf_jac.detach())
    for got, fn, args, leaves in ((got_g, j_gauss, (noise, lik), (tn, tl)),
                                  (got_nf, j_nf, (lik, pri), (tl, tp))):
        jargs = tuple(jnp.asarray(a) for a in args)
        ref, g_ref = jax.value_and_grad(fn, argnums=(0, 1))(*jargs)
        np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5, atol=1e-5)
        grads = torch.autograd.grad(got, leaves)
        for g, r in zip(grads, g_ref):
            r = np.asarray(r)
            assert np.linalg.norm(r) > 0
            assert np.linalg.norm(g.numpy() - r) / np.linalg.norm(r) < 1e-4


def test_gaussian_pseudolikelihood_keeps_the_velocity_constant():
    """With 2-D noise the velocity term is its constant alone:
    2·log c − 2·log σ_vel per step, summed along the walk."""
    h = _histories(5, t=10)
    args = [torch.from_numpy(h[k]) for k in ("weights", "noise", "lik", "idx")]
    base = TL.pseudolikelihood_loss(*args, 10, 1.0, 1.0)
    wider = TL.pseudolikelihood_loss(*args, 10, 1.0, math.e)
    # one block of 10 steps: Q changes by Σ_n w·(10·(−2)) = −20 per element
    np.testing.assert_allclose(float(wider - base), 20.0, rtol=1e-5)


def test_loss_pseudolik_is_zero_for_the_dpf_train_type():
    cfg = DPFConfig(**dict(BASE, train_type="DPF", labeled_ratio=1.0))
    trainer = Trainer(cfg, device="cpu")
    metrics = trainer.train_step(_batch(3), generator=trainer.generator(0))
    assert float(metrics["loss_pseudolik"]) == 0.0


# ---------------------------------------------------------------------------
# one SDPF training step
# ---------------------------------------------------------------------------


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((B, T, 128, 128, 3), dtype=np.float32),
            "state": (rng.standard_normal((B, T, 4)) * 10).astype(np.float32),
            "start_state": (rng.standard_normal((B, 4)) * 10).astype(np.float32)}


def _jax_loss_noise(key, labeled_ratio, width=128.0):
    """Replay the JAX key schedule of ``Trainer._loss`` (train.py:90-98: the
    velocity draw, the filter's, the semi-supervised mask) and of the filter
    (dpf.py:325,384; dynamics.py:38) as the port's noise dict."""
    k_vel, k_filter, k_mask = jax.random.split(key, 3)
    k_init, k = jax.random.split(k_filter)
    init = jax.random.uniform(k_init, (B, N, 2), minval=-width / 2, maxval=width / 2)
    motion = []
    for _ in range(T):
        k, _, k_motion = jax.random.split(k, 3)
        motion.append(np.asarray(jax.random.normal(k_motion, (B, N, 2))))
    mask = JL.semi_supervised_mask(k_mask, B, T, labeled_ratio)
    return {"vel": torch.tensor(np.asarray(jax.random.normal(k_vel, (B, T, 2)))),
            "init": torch.tensor(np.asarray(init)),
            "motion": torch.tensor(np.stack(motion)),
            "mask": torch.tensor(np.asarray(mask))}


def _randomise_cglow(params, key, std=0.15):
    """The CGLOW's parameters drawn anew from N(0, std²), as
    tests/test_cglow_parity.py does: at init most of them are zeros and
    the flow is near a constant map."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(key, len(leaves))
    return jax.tree_util.tree_unflatten(
        treedef, [std * jax.random.normal(k, a.shape, a.dtype) for k, a in zip(keys, leaves)])


# the SDPF steps: the bootstrap filter (nf_dyn off: the Gaussian-prior
# pseudo-likelihood) and BASELINE config 5 (nf_dyn on, the dynamics on the
# packed chain: the NF-prior pseudo-likelihood; the CGLOW measurement)
STEPS = {
    "gaussian_prior": dict(BASE),
    "config5_cglow_nf_prior": dict(BASE, measurement="CGLOW", nf_dyn=True,
                                   pallas_coupling=True),
}
FLOWS = ("nf_dyn.", "cond_model.")


@pytest.fixture(scope="module", params=sorted(STEPS))
def sdpf_step(request):
    """One JAX value_and_grad + Adam step; the dynamics flow's weights
    scaled ×10 from their N(0, 0.01²) init (tests/test_torch_cnf.py), the
    CGLOW's drawn from N(0, 0.15²)."""
    cfg = STEPS[request.param]
    trainer = JaxTrainer(JaxConfig(**cfg))
    # jitted: the same initialisers, compiled once rather than op by op
    params, rest = _split_variables(jax.jit(trainer.engine.init)(jax.random.PRNGKey(0)))
    params = {k: jax.tree_util.tree_map(lambda a: a * 10.0, v) if k in ("nf_dyn", "cond_model")
              else v for k, v in params.items()}
    if "cglow" in params["measurement"]:
        params["measurement"] = dict(params["measurement"], cglow=_randomise_cglow(
            params["measurement"]["cglow"], jax.random.PRNGKey(42)))
    opt_state = trainer.tx.init(params)
    batch = _batch(1)
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def step(params):
        (loss, aux), grads = jax.value_and_grad(trainer._loss, has_aux=True)(
            params, rest, jbatch, key, True)
        updates, _ = trainer.tx.update(grads, opt_state, params)
        return loss, aux, grads, optax.apply_updates(params, updates)

    loss, aux, grads, new_params = step(params)
    return dict(name=request.param, cfg=cfg, params=params, rest=rest, batch=batch,
                key=key, loss=loss, aux=aux, grads=grads, new_params=new_params)


def _variables(params, rest):
    return _np_tree({k: {"params": params[k], **rest[k]} for k in params})


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_sdpf_train_step_matches_jax(sdpf_step):
    """One SDPF train step against the JAX one, from the same parameters,
    noise and mask:

    * loss terms (loss_pseudolik included) rtol 1e-5; firings and Sinkhorn
      iterations exact;
    * every parameter gradient, as ‖g − g_jax‖/‖g_jax‖ per tensor: 1e-4,
      the decoder's 1e-2 and the RealNVP chains' 1e-3 (the tolerances of
      tests/test_torch_train.py and test_torch_cnf.py); a chain the step
      does not run gets none (JAX: zero);
    * the pseudo-likelihood alone sends a gradient to the measurement
      model and the encoder (tests/test_train.py:253-275);
    * the parameters after the step: Adam on the port's gradient, atol
      1e-7 and rtol 1.2e-7 (one float32 ulp: torch's Adam and optax's
      round apart by one on weights near 1); BN running statistics rtol
      1e-4 / atol 1e-5."""
    js = sdpf_step
    cfg = js["cfg"]
    trainer = Trainer(DPFConfig(**cfg), device="cpu")
    load_jax_variables(trainer.engine, _variables(js["params"], js["rest"]))
    before = {k: v.detach().clone() for k, v in trainer.engine.named_parameters()}
    noise = _jax_loss_noise(js["key"], cfg["labeled_ratio"])

    # the pseudo-likelihood's own gradient first (no optimizer step; the BN
    # running statistics it moves are put back)
    stats = {k: v.clone() for k, v in trainer.engine.named_buffers()}
    _, aux_pl = trainer._loss(js["batch"], True, noise)
    aux_pl["loss_pseudolik"].backward()
    for sub in ("measurement", "encoder"):
        total = sum(float(p.grad.abs().sum()) for name, p in trainer.engine.named_parameters()
                    if name.startswith(sub + ".") and p.grad is not None)
        assert np.isfinite(total) and total > 0, sub
    trainer.engine.zero_grad(set_to_none=True)
    trainer.engine.load_state_dict({**trainer.engine.state_dict(), **stats})

    metrics = trainer.train_step(js["batch"], noise=noise)
    aux = js["aux"]
    assert metrics["resample_count"] == int(aux["resample_count"]) == T
    assert metrics["sinkhorn_iters"] == int(aux["sinkhorn_iters"]) > 0
    assert float(aux["loss_pseudolik"]) != 0
    for k, ref in (("loss", js["loss"]), ("loss_sup", aux["loss_sup"]),
                   ("loss_ae", aux["loss_ae"]), ("loss_pseudolik", aux["loss_pseudolik"]),
                   ("obs_likelihood", aux["obs_likelihood"])):
        np.testing.assert_allclose(float(metrics[k]), float(ref), rtol=1e-5, err_msg=k)

    grads = torch_state_from_jax({k: {"params": v} for k, v in _np_tree(js["grads"]).items()})
    named = dict(trainer.engine.named_parameters())
    assert set(grads) == set(named)
    for name, g_ref in grads.items():
        grad = named[name].grad
        used = not name.startswith(FLOWS) or (name.startswith("nf_dyn.") and cfg.get("nf_dyn"))
        if not used:
            assert grad is None and not g_ref.any(), name
            continue
        assert grad is not None, name
        bound = (1e-3 if name.startswith(FLOWS) else
                 1e-2 if name.startswith("decoder.") else 1e-4)
        if float(np.linalg.norm(g_ref)) > 0:
            assert _rel(grad.numpy(), g_ref) < bound, name
        else:
            assert float(grad.abs().sum()) == 0, name
    if cfg["measurement"] == "CGLOW":
        assert sum(float(p.grad.abs().sum())
                   for p in trainer.engine.measurement.cglow.parameters()) > 0

    tx = optax.adam(DPFConfig().lr)
    port_grads = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
                  for k, p in named.items()}
    params0 = {k: v.numpy() for k, v in before.items()}
    updates, _ = tx.update(port_grads, tx.init(params0), params0)
    for name, want in optax.apply_updates(params0, updates).items():
        np.testing.assert_allclose(named[name].detach().numpy(), np.asarray(want),
                                   rtol=1.2e-7, atol=1e-7, err_msg=name)
    after = torch_state_from_jax(_variables(js["new_params"], aux["new_rest"]))
    for name, buf in trainer.engine.named_buffers():
        np.testing.assert_allclose(buf.numpy(), after[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_the_mask_in_noise_is_the_one_used():
    """A train step takes ``noise["mask"]`` as it is: the supervised loss is
    the masked RMSE of that mask (here all labels but one step's)."""
    cfg = DPFConfig(**BASE)
    trainer = Trainer(cfg, device="cpu")
    batch = _batch(4)
    mask = torch.ones(B, T)
    mask[0, 2] = 0.0
    gen = torch.Generator().manual_seed(1)
    noise = {"vel": torch.randn(B, T, 2, generator=gen), "mask": mask,
             "init": torch.rand(B, N, 2, generator=gen) * 128 - 64,
             "motion": torch.randn(T, B, N, 2, generator=gen)}
    with torch.no_grad():
        _, aux = trainer._loss(batch, True, noise)
    out = aux["filter_out"]
    want, _ = TL.supervised_loss(out.particles, out.weights, torch.from_numpy(batch["state"]),
                                 mask, True, cfg.labeled_ratio)
    assert float(aux["loss_sup"]) == float(want)
