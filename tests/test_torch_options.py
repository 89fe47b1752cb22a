"""The single-card settings of the JAX CLI in nfdpf_torch against the JAX
package: bfloat16 compute (``--compute-dtype``), ``--remat``,
``--encode-per-step`` and ``--torch-init``, and the settings check, which
refuses, on a particle mesh, soft resampling, dense OT and SDPF only.

As in the other parity tests: B=2, N=16, T=5 (B·T = 10 frames), parameters
carried by the bridge, noise replayed from the JAX key schedule, the JAX
Pallas kernels in interpret mode and the port on its kernels' plain
versions.  Each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfdpf_tpu.ops.pallas.coupling_pallas as cp
import nfdpf_tpu.ops.pallas.sinkhorn_pallas as sp
from nfdpf_tpu.config import DPFConfig as JaxConfig
from nfdpf_tpu.models.dpf import DPF as JaxDPF
from nfdpf_tpu.train import Trainer as JaxTrainer
from nfdpf_torch.bridge import load_jax_variables, torch_state_from_jax
from nfdpf_torch.config import DPFConfig
from nfdpf_torch.models.dpf import DPF, check_supported
from nfdpf_torch.models.nets import FlaxBatchNorm
from nfdpf_torch.train import Trainer

B, N, T = 2, 16, 5
BASE = dict(num_particles=N, sequence_length=T, batch_size=B, width=128,
            resampler_type="ot", measurement="cos", train_type="DPF",
            use_pallas=True, compute_dtype="float32", ess_threshold=1.01)
CNF = dict(BASE, nf_dyn=True, nf_cond=True, pallas_coupling=True)
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
    """``tree`` with the two chains' entries multiplied by FLOW_SCALE: at
    their N(0, 0.01²) init the flows are near the identity."""
    return {k: (jax.tree_util.tree_map(lambda a: a * FLOW_SCALE, v)
                if k in ("nf_dyn", "cond_model") else v) for k, v in tree.items()}


def _noise(key, width=128.0):
    """Replay the JAX key schedule of ``Trainer._loss`` (train.py:90-91) and
    the filter (dpf.py:325,384; dynamics.py:38) as the port's noise dict
    (OT resampling draws nothing)."""
    k_vel, key, _ = jax.random.split(key, 3)
    k_init, k = jax.random.split(key)
    init = jax.random.uniform(k_init, (B, N, 2), minval=-width / 2, maxval=width / 2)
    motion = []
    for _ in range(T):
        k, _, k_motion = jax.random.split(k, 3)
        motion.append(np.asarray(jax.random.normal(k_motion, (B, N, 2))))
    return {"vel": torch.tensor(np.asarray(jax.random.normal(k_vel, (B, T, 2)))),
            "init": torch.tensor(np.asarray(init)),
            "motion": torch.tensor(np.stack(motion))}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((B, T, 128, 128, 3), dtype=np.float32),
            "state": (rng.standard_normal((B, T, 4)) * 10).astype(np.float32),
            "start_state": (rng.standard_normal((B, 4)) * 10).astype(np.float32)}


def _variables(params, rest):
    return _np_tree({k: {"params": params[k], **rest[k]} for k in params})


def _jax_step(settings, scale_flows=False):
    """One JAX value_and_grad of the training loss on ``_batch(1)``."""
    trainer = JaxTrainer(JaxConfig(**settings))
    state = trainer.init_state(jax.random.PRNGKey(0))
    params = _scale_flows(state.params) if scale_flows else state.params
    batch = _batch(1)
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def step(params):
        return jax.value_and_grad(trainer._loss, has_aux=True)(
            params, state.rest, jbatch, key, True)

    (loss, aux), grads = step(params)
    aux = {k: v for k, v in aux.items() if k != "filter_out"}
    return dict(params=_np_tree(params), rest=_np_tree(state.rest), batch=batch, key=key,
                loss=float(loss), aux=_np_tree(aux), grads=_np_tree(grads))


def _port_trainer(js, settings):
    trainer = Trainer(DPFConfig(**settings), device="cpu")
    load_jax_variables(trainer.engine, _variables(js["params"], js["rest"]))
    return trainer


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check_step(trainer, metrics, js, grad_bound, loss_rtol):
    """The port's train step against the JAX one: firings and Sinkhorn
    iterations exact, the loss terms within ``loss_rtol``, and every
    parameter's gradient within ``grad_bound(name)`` as ‖g − g_jax‖/‖g_jax‖
    (a parameter JAX gives exactly zero gets none or zero)."""
    aux = js["aux"]
    assert metrics["resample_count"] == int(aux["resample_count"]) == T
    assert metrics["sinkhorn_iters"] == int(aux["sinkhorn_iters"]) > 0
    for k, ref in (("loss", js["loss"]), ("loss_sup", aux["loss_sup"]),
                   ("loss_ae", aux["loss_ae"]), ("obs_likelihood", aux["obs_likelihood"])):
        np.testing.assert_allclose(float(metrics[k]), float(ref), rtol=loss_rtol, err_msg=k)
    grads = torch_state_from_jax({k: {"params": v} for k, v in js["grads"].items()})
    named = dict(trainer.engine.named_parameters())
    assert set(grads) == set(named)
    for name, g_ref in grads.items():
        g = named[name].grad
        if float(np.linalg.norm(g_ref)) == 0.0:
            assert g is None or float(g.abs().sum()) == 0.0, name
            continue
        assert g is not None, name
        assert _rel(g.numpy(), g_ref) < grad_bound(name), name


def _assert_running_stats(module, stats, rtol, atol):
    """BN running mean/var of ``module`` against flax's batch_stats."""
    for i, bn in enumerate(module.norms):
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(bn, ours).numpy(), np.asarray(stats[f"BatchNorm_{i}"][theirs]),
                rtol=rtol, atol=atol, err_msg=f"BatchNorm_{i}.{theirs}")


# ---------------------------------------------------------------------------
# bfloat16 compute
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_engines():
    """A JAX bf16 engine with its variables, and the port in bf16 and in
    float32 loaded with them."""
    je = JaxDPF(JaxConfig(**dict(BASE, compute_dtype="bfloat16")))
    variables = _np_tree(je.init(jax.random.PRNGKey(3)))
    ports = {}
    for dtype in ("bfloat16", "float32"):
        ports[dtype] = DPF(DPFConfig(**dict(BASE, compute_dtype=dtype)), device="cpu")
        load_jax_variables(ports[dtype], variables)
    return je, variables, ports


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("net", ["encoder", "decoder"])
def test_bf16_nets_match_jax(bf16_engines, net, train):
    """The bf16 encoder (10 frames) and decoder (10 codes) against flax's
    with ``dtype=bfloat16``: outputs float32, ‖Δ‖/‖ref‖ ≤ 1e-2 (five conv or
    deconv layers, each rounding its output to bfloat16's 8 bits, 3.9e-3) and
    under half the float32 port's distance from the same reference (so the
    casts are the ones flax makes); in train mode the BN running statistics,
    float32 in both, within rtol 1e-3 / atol 1e-4.  The parameters stay
    float32."""
    je, variables, ports = bf16_engines
    rng = np.random.default_rng(0)
    if net == "encoder":
        x = rng.random((B * T, 128, 128, 3), dtype=np.float32)
        ref, stats = je.encode(variables, jnp.asarray(x), train=train)
    else:
        x = rng.standard_normal((B * T, 32)).astype(np.float32)
        ref, stats = je.decode(variables, jnp.asarray(x), train=train)
    ref = np.asarray(ref)
    assert ref.dtype == np.float32
    got, after = {}, {}
    for dtype, pe in ports.items():
        module = getattr(pe, net)
        saved = {k: v.clone() for k, v in module.state_dict().items()}
        module.train(train)
        with torch.no_grad():
            got[dtype] = module(torch.from_numpy(x))
        after[dtype] = {k: v.clone() for k, v in module.state_dict().items()}
        module.load_state_dict(saved)
    assert got["bfloat16"].dtype == torch.float32
    err = _rel(got["bfloat16"].numpy(), ref)
    assert err <= 1e-2
    assert err < 0.5 * _rel(got["float32"].numpy(), ref)
    module = getattr(ports["bfloat16"], net)
    assert all(p.dtype == torch.float32 for p in module.parameters())
    if train:
        for i in range(len(module.norms)):
            for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
                np.testing.assert_allclose(
                    after["bfloat16"][f"norms.{i}.{ours}"].numpy(),
                    np.asarray(stats[f"BatchNorm_{i}"][theirs]), rtol=1e-3, atol=1e-4,
                    err_msg=f"BatchNorm_{i}.{theirs}")


@pytest.fixture(scope="module")
def jax_bf16():
    return _jax_step(dict(BASE, compute_dtype="bfloat16"))


def test_bf16_train_step_matches_jax(jax_bf16):
    """One bf16 train step against JAX's bf16 step: firings and Sinkhorn
    iterations exact, loss terms within rtol 1e-3, each gradient as
    ‖Δ‖/‖g‖ within 1e-1 (2e-1 for the decoder, whose last BatchNorm's
    backward cancels most of its gradient: 1e-2 in float32): bfloat16's
    unit roundoff, 3.9e-3, compounds through five layers of rounded
    activations and their backward.  The encoder's and decoder's gradients
    as a whole sit at least 1.25× closer to JAX's bf16 ones than the float32
    port's do, so the casts are flax's (on the CPU: 2.4× and 1.47×).  After Adam the parameters are
    float32 and finite."""
    js = jax_bf16
    trainer = _port_trainer(js, dict(BASE, compute_dtype="bfloat16"))
    metrics = trainer.train_step(js["batch"], noise=_noise(js["key"]))
    _check_step(trainer, metrics, js, lambda name: 2e-1 if name.startswith("decoder.") else 1e-1,
                loss_rtol=1e-3)
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
               for p in trainer.engine.parameters())

    f32 = _port_trainer(js, dict(BASE, compute_dtype="float32"))
    loss, _ = f32._loss(js["batch"], True, _noise(js["key"]))
    loss.backward()
    ref = torch_state_from_jax({k: {"params": v} for k, v in js["grads"].items()})
    for net in ("encoder.", "decoder."):
        names = [k for k in ref if k.startswith(net)]
        want = np.concatenate([ref[k].ravel() for k in names])
        dist = {}
        for label, engine in (("bf16", trainer.engine), ("f32", f32.engine)):
            named = dict(engine.named_parameters())
            got = np.concatenate([named[k].grad.numpy().ravel() for k in names])
            dist[label] = _rel(got, want)
        assert 1.25 * dist["bf16"] < dist["f32"], (net, dist)


def test_bf16_matches_float32_within_jax_bounds(jax_bf16):
    """The port's bf16 eval step against its float32 one from the same
    parameters and noise, with the JAX package's own bounds
    (tests/test_bf16.py): supervised loss within 5 %, predictions within
    1 px."""
    js = jax_bf16
    out = {}
    for dtype in ("float32", "bfloat16"):
        trainer = _port_trainer(js, dict(BASE, compute_dtype=dtype))
        metrics, aux = trainer.eval_step(js["batch"], noise=_noise(js["key"]))
        out[dtype] = (float(metrics["loss_sup"]), aux["predictions"].numpy())
    (loss32, pred32), (loss16, pred16) = out["float32"], out["bfloat16"]
    assert abs(loss16 - loss32) / abs(loss32) < 0.05
    assert float(np.abs(pred16 - pred32).max()) < 1.0


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


# the settings of the port's remat-against-no-remat runs from its generator
REMAT_CASES = {
    # the streaming OT path, both packed chains and the warm start's carry
    "cnf_warm_start": CNF | dict(sinkhorn_warm_start=True),
    # the soft resampler's offsets and the motion draws from the generator
    "soft": BASE | dict(resampler_type="soft"),
    # the per-step encode beside the region: BN updated once a step
    "encode_per_step": BASE | dict(encode_per_step=True),
    "cnf_module_route": CNF | dict(pallas_coupling=False),
}


@pytest.mark.parametrize("case", sorted(REMAT_CASES))
def test_remat_matches_no_remat(case):
    """The training loss and its gradients with ``remat_scan_step`` and
    without, from the same parameters (flows scaled ×10) and the same
    generator seed: the draws are taken outside the recomputed region, so
    the loss is equal within rtol 1e-6 and every gradient within rtol 1e-4 /
    atol 1e-6 (as tests/test_filter.py holds JAX), firings and iterations
    equal, the used chains' gradients non-zero, and the BN running
    statistics equal (a recomputation does not update them again)."""
    runs = []
    for remat in (False, True):
        trainer = Trainer(DPFConfig(**dict(REMAT_CASES[case], remat_scan_step=remat)),
                          device="cpu")
        with torch.no_grad():
            for p in list(trainer.engine.nf_dyn.parameters()) + list(
                    trainer.engine.cond_model.parameters()):
                p.mul_(FLOW_SCALE)
        loss, aux = trainer._loss(_batch(2), True, generator=trainer.generator(4))
        loss.backward()
        runs.append((float(loss.detach()), aux,
                     {k: p.grad.clone() for k, p in trainer.engine.named_parameters()
                      if p.grad is not None},
                     {k: b.clone() for k, b in trainer.engine.named_buffers()}))
    (l0, a0, g0, b0), (l1, a1, g1, b1) = runs
    assert a0["resample_count"] == a1["resample_count"] == T
    assert a0["sinkhorn_iters"] == a1["sinkhorn_iters"]
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    assert set(g0) == set(g1)
    cfg = REMAT_CASES[case]
    for chain, used in (("nf_dyn.", cfg.get("nf_dyn")), ("cond_model.", cfg.get("nf_cond"))):
        if used:
            assert sum(float(g.abs().sum()) for k, g in g0.items() if k.startswith(chain)) > 0
    for name, g in g0.items():
        np.testing.assert_allclose(g1[name].numpy(), g.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    for name in b0:
        torch.testing.assert_close(b1[name], b0[name], rtol=0, atol=0, msg=name)


@pytest.fixture(scope="module")
def jax_remat():
    return _jax_step(CNF | dict(sinkhorn_warm_start=True, remat_scan_step=True),
                     scale_flows=True)


def test_remat_train_step_matches_jax(jax_remat):
    """The port's remat train step against JAX's (``jax.checkpoint`` on the
    scan step) on the CNF-DPF with the packed chains, the streaming OT and
    the warm start, flows ×10: the tolerances of tests/test_torch_cnf.py
    (loss terms rtol 1e-5; gradients 1e-3 for the flows, 1e-2 for the
    decoder, 1e-4 for the rest)."""
    js = jax_remat
    trainer = _port_trainer(js, CNF | dict(sinkhorn_warm_start=True, remat_scan_step=True))
    metrics = trainer.train_step(js["batch"], noise=_noise(js["key"]))

    def bound(name):
        if name.startswith(("nf_dyn.", "cond_model.")):
            return 1e-3
        return 1e-2 if name.startswith("decoder.") else 1e-4
    _check_step(trainer, metrics, js, bound, loss_rtol=1e-5)


# ---------------------------------------------------------------------------
# encode_per_step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_per_step():
    return _jax_step(dict(BASE, encode_per_step=True))


# the gradients JAX's float32 CPU run gets farthest from a float64 run of
# the port under the per-step encode (BN statistics over each step's 2
# frames): 4.4e-4, 5.1e-4, 6.4e-4 and 1.1e-3, the port's float32 run 5e-6
PER_STEP_LOOSE = ("encoder.convs.0.", "encoder.convs.1.", "encoder.norms.0.")


def _per_step_bound(name):
    if name.startswith(PER_STEP_LOOSE):
        return 2e-3
    return 1e-2 if name.startswith("decoder.") else 1e-4


def _float64_grads(js, settings):
    """The port's loss gradients on the JAX step's inputs, in float64."""
    torch.set_default_dtype(torch.float64)
    try:
        trainer = _port_trainer(js, settings)
        trainer.engine.double()
        trainer.engine.encoder.compute_dtype = trainer.engine.decoder.compute_dtype = \
            torch.float64
        noise = {k: v.double() for k, v in _noise(js["key"]).items()}
        batch = {k: v.astype(np.float64) for k, v in js["batch"].items()}
        loss, _ = trainer._loss(batch, True, noise)
        loss.backward()
    finally:
        torch.set_default_dtype(torch.float32)
    return {k: p.grad.numpy() for k, p in trainer.engine.named_parameters()
            if p.grad is not None}


@pytest.fixture(scope="module")
def port_per_step(jax_per_step):
    """The port's ablation from the JAX step's parameters and noise, once for
    the tests that read it: (the trainer after its train step, the step's
    metrics, the eval loss it gave before the step; an eval step leaves a
    trainer as it was)."""
    js = jax_per_step
    trainer = _port_trainer(js, dict(BASE, encode_per_step=True))
    noise = _noise(js["key"])
    eval_loss = float(trainer.eval_step(js["batch"], noise=noise)[0]["loss"])
    return trainer, trainer.train_step(js["batch"], noise=noise), eval_loss


def test_encode_per_step_train_step_matches_jax(jax_per_step, port_per_step):
    """A train step of the ablation against JAX's: loss terms rtol 1e-5,
    gradients 1e-4 (decoder 1e-2), but 2e-3 for the first two conv layers
    and the first BatchNorm, where JAX's float32 run sits up to 1.1e-3 from
    float64 (``PER_STEP_LOOSE``): those are also held to 1e-4 of the port's
    float64 run.  The encoder's BN running statistics after the T per-step
    updates and the AE path's full-frame one, and the decoder's, within rtol
    1e-4 / atol 1e-5."""
    js = jax_per_step
    settings = dict(BASE, encode_per_step=True)
    trainer, metrics, _ = port_per_step
    _check_step(trainer, metrics, js, _per_step_bound, loss_rtol=1e-5)
    rest = js["aux"]["new_rest"]
    _assert_running_stats(trainer.engine.encoder, rest["encoder"]["batch_stats"],
                          rtol=1e-4, atol=1e-5)
    _assert_running_stats(trainer.engine.decoder, rest["decoder"]["batch_stats"],
                          rtol=1e-4, atol=1e-5)
    g64 = _float64_grads(js, settings)
    for name, p in trainer.engine.named_parameters():
        if name.startswith(PER_STEP_LOOSE):
            assert _rel(p.grad.numpy(), g64[name]) < 1e-4, name


def test_encode_per_step_eval_is_the_hoisted_encode(jax_per_step, port_per_step):
    """As tests/test_filter.py holds JAX: in eval mode the ablation is the
    hoisted encode (loss rtol 1e-6), and after a train step its encoder BN
    statistics differ from the hoisted mode's (T per-step updates and one
    full-frame update against one).  Each mode's eval step runs on the
    trainer before its train step (an eval step leaves it as it was); the
    ablation's are ``port_per_step``'s."""
    js = jax_per_step
    noise = _noise(js["key"])
    trainer = _port_trainer(js, BASE)
    hoisted_loss = float(trainer.eval_step(js["batch"], noise=noise)[0]["loss"])
    trainer.train_step(js["batch"], noise=noise)
    per_step, _, per_step_loss = port_per_step
    np.testing.assert_allclose(per_step_loss, hoisted_loss, rtol=1e-6)
    assert not torch.allclose(per_step.engine.encoder.norms[0].running_mean,
                              trainer.engine.encoder.norms[0].running_mean)


def test_encode_per_step_in_eval_mode_raises():
    """A direct eval-mode call of the per-step encode is refused with a
    ValueError (the JAX package raises a KeyError there, ADVICE.md)."""
    engine = DPF(DPFConfig(**dict(BASE, encode_per_step=True)), device="cpu")
    engine.eval()
    images = torch.zeros(B, T, 128, 128, 3)
    with pytest.raises(ValueError, match="train mode"):
        engine.filter_encoding_per_step(images, torch.zeros(B, 4), torch.zeros(B, T, 2))


def test_remat_with_encode_per_step_matches_jax(jax_per_step):
    """remat over the ablation against JAX's ablation without it (remat
    changes no value in JAX, tests/test_filter.py): the bounds of the
    ablation's own test, BN running statistics included."""
    js = jax_per_step
    trainer = _port_trainer(js, dict(BASE, encode_per_step=True, remat_scan_step=True))
    metrics = trainer.train_step(js["batch"], noise=_noise(js["key"]))
    _check_step(trainer, metrics, js, _per_step_bound, loss_rtol=1e-5)
    _assert_running_stats(trainer.engine.encoder, js["aux"]["new_rest"]["encoder"]["batch_stats"],
                          rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# torch_init
# ---------------------------------------------------------------------------


def _uniform_check(w, bound):
    """|w| ≤ bound, max|w| > 0.8·bound, and E|w| = bound/2 within 10 % (a
    uniform draw; flax's truncated normal at this bound gives ~0.35·bound)."""
    a = w.detach().abs()
    assert float(a.max()) <= bound * (1 + 1e-6)
    assert float(a.max()) > 0.8 * bound
    assert abs(float(a.mean()) / bound - 0.5) < 0.05


def test_torch_init_bounds():
    """torch_init as tests/test_models.py holds JAX: U(±1/√fan_in) for dense
    and conv kernels and dense biases (non-zero), fan_in torch's; the
    decoder's ConvTranspose uses out_ch·kh·kw (its bound (128·16)^-½ lies
    above the in_ch·kh·kw one, (256·16)^-½, which the max check tells
    apart); convolutions have no bias; BN starts at scale 1, bias 0."""
    engine = DPF(DPFConfig(**dict(BASE, measurement="NN", torch_init=True)), device="cpu")
    engine.requires_grad_(False)
    enc, dec = engine.encoder, engine.decoder
    _uniform_check(enc.convs[0].weight, 48 ** -0.5)
    _uniform_check(enc.convs[4].weight, (128 * 16) ** -0.5)
    assert all(c.bias is None for c in list(enc.convs) + list(dec.deconvs))
    _uniform_check(enc.dense.weight, (256 * 16) ** -0.5)
    _uniform_check(enc.dense.bias, (256 * 16) ** -0.5)
    _uniform_check(dec.dense.weight, 32 ** -0.5)
    _uniform_check(dec.deconvs[0].weight, (128 * 16) ** -0.5)
    _uniform_check(dec.deconvs[4].weight, (3 * 16) ** -0.5)
    meas = engine.measurement
    pe = meas.particle_encoder
    for layer, fan_in in ((pe.fc1, 2), (pe.fc2, 16), (pe.fc3, 32),
                          (meas.likelihood_net.fc1, 64), (meas.likelihood_net.fc3, 64)):
        bound = fan_in ** -0.5
        assert float(layer.weight.abs().max()) <= bound + 1e-7
        assert float(layer.bias.abs().max()) <= bound + 1e-7
        assert float(layer.bias.abs().max()) > 0.0
    for bn in engine.modules():
        if isinstance(bn, FlaxBatchNorm):
            assert bool((bn.weight == 1).all() and (bn.bias == 0).all())


@pytest.mark.parametrize("measurement", ["cos", "CRNVP", "CGLOW"])
def test_torch_init_leaves_the_flows_alone(measurement):
    """The flows' N(0, 0.01²) draws, the CRNVP measurement's flow and the
    CGLOW's draws are the same with and without torch_init (JAX gives them
    their own keys); the nets it reaches are not."""
    settings = dict(BASE, measurement=measurement, nf_dyn=True, nf_cond=True)
    default = dict(DPF(DPFConfig(**settings), device="cpu").named_parameters())
    torch_init = dict(DPF(DPFConfig(**settings, torch_init=True), device="cpu")
                      .named_parameters())
    reached = ("encoder.", "decoder.", "measurement.particle_encoder.",
               "measurement.likelihood_net.")
    for name, p in default.items():
        if name.startswith(reached):
            if name.endswith("weight") and p.dim() > 1:
                assert not torch.equal(torch_init[name], p), name
        else:
            torch.testing.assert_close(torch_init[name], p, rtol=0, atol=0, msg=name)


def test_torch_init_parameters_cross_the_bridge():
    """A torch_init model's parameters carried from JAX through the bridge
    (no new mapping: the names and dtypes are flax's) and its encodings at
    rtol/atol 1e-4, as the float32 encoder test holds them."""
    je = JaxDPF(JaxConfig(**dict(BASE, torch_init=True)))
    variables = _np_tree(je.init(jax.random.PRNGKey(3)))
    assert float(np.abs(variables["encoder"]["params"]["Dense_0"]["bias"]).max()) > 0
    pe = DPF(DPFConfig(**dict(BASE, torch_init=True)), device="cpu")
    load_jax_variables(pe, variables)
    x = np.random.default_rng(0).random((B * T, 128, 128, 3), dtype=np.float32)
    ref, _ = je.encode(variables, jnp.asarray(x), train=False)
    pe.eval()
    with torch.no_grad():
        got = pe.encode(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# what the port still refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overrides", [dict(mesh_data=2), dict(mesh_particle=2)],
                         ids=["mesh_data", "mesh_particle"])
def test_only_meshes_are_refused(overrides):
    """Every setting of the JAX CLI builds on the CPU, all four of this
    slice's together with every measurement, alone and on a data or a
    particle mesh, and so do soft resampling, OT over materialised costs
    and SDPF beside them; only values no package runs are refused: an
    unknown compute dtype is a ValueError, on a mesh too."""
    every = dict(compute_dtype="bfloat16", remat_scan_step=True, encode_per_step=True,
                 torch_init=True)
    for measurement in ("cos", "NN", "gaussian", "CRNVP", "CGLOW"):
        check_supported(DPFConfig(**dict(BASE, measurement=measurement, **every)))
        check_supported(DPFConfig(**dict(BASE, measurement=measurement, **every, **overrides)))
    for resampling in (dict(resampler_type="soft"), dict(use_pallas=False),
                       dict(ot_transport_grad=True), dict(train_type="SDPF")):
        check_supported(DPFConfig(**dict(BASE, **every, **resampling, **overrides)))
    for mesh in ({}, overrides):
        with pytest.raises(ValueError, match="compute_dtype"):
            check_supported(DPFConfig(**dict(BASE, compute_dtype="float16", **mesh)))


@pytest.mark.parametrize("case", ["soft_cglow", "dense_nn", "transport_grad_crnvp",
                                  "warm_gaussian"])
def test_every_setting_together_takes_a_train_step(case):
    """bf16, remat, the per-step encode and torch_init together, with each
    resampling path and another measurement: one train step (T=3) from the
    generator, every step resampled, finite losses and gradients, the
    parameters float32."""
    overrides = {"soft_cglow": dict(resampler_type="soft", measurement="CGLOW"),
                 "dense_nn": dict(use_pallas=False, measurement="NN"),
                 "transport_grad_crnvp": dict(ot_transport_grad=True, measurement="CRNVP",
                                              nf_dyn=True, nf_cond=True, pallas_coupling=True),
                 "warm_gaussian": dict(sinkhorn_warm_start=True, measurement="gaussian")}[case]
    cfg = DPFConfig(**dict(BASE, compute_dtype="bfloat16", remat_scan_step=True,
                           encode_per_step=True, torch_init=True, sequence_length=3,
                           **overrides))
    trainer = Trainer(cfg, device="cpu")
    batch = {k: v[:, :3] if k != "start_state" else v for k, v in _batch(8).items()}
    metrics = trainer.train_step(batch, generator=trainer.generator(0))
    assert all(np.isfinite(float(metrics[k])) for k in ("loss", "loss_sup", "loss_ae"))
    assert metrics["resample_count"] == 3
    for name, p in trainer.engine.named_parameters():
        assert p.dtype == torch.float32, name
        if p.grad is not None:
            assert bool(torch.isfinite(p.grad).all()), name
    assert any(p.grad is not None for p in trainer.engine.measurement.parameters())
