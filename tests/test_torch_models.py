"""nfdpf_torch models vs the JAX package: the networks through the parameter
bridge (train and eval mode, BN running statistics), the bootstrap dynamics,
the four measurement models the port runs, and the filter loop on each
resampling path: streaming OT, dense OT, soft, the warm start, and the NF-DPF
with the CRNVP measurement (the flows and the CNF-DPF slice are in
tests/test_torch_flows.py and test_torch_cnf.py).  Inputs and noise come from
numpy / the JAX key schedule; the JAX Pallas kernels run in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfdpf_tpu.ops.pallas.sinkhorn_pallas as sp
from nfdpf_tpu.config import DPFConfig as JaxConfig
from nfdpf_tpu.models import dynamics as jdyn
from nfdpf_tpu.models.dpf import DPF as JaxDPF
from nfdpf_torch.bridge import load_jax_variables, torch_state_from_jax
from nfdpf_torch.config import DPFConfig
from nfdpf_torch.models import dynamics as tdyn
from nfdpf_torch.models.dpf import DPF, check_coupling_kernels, particle_initialization
from nfdpf_torch.models.nets import FlaxBatchNorm
from nfdpf_torch.train import Trainer

B, N, T = 2, 16, 5
SLICE = dict(num_particles=N, sequence_length=T, batch_size=B, width=128,
             resampler_type="ot", measurement="cos", train_type="DPF",
             use_pallas=True, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(sp, "_INTERPRET", True)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def engines():
    """A JAX engine with its variables and the port loaded with them."""
    je = JaxDPF(JaxConfig(**SLICE))
    variables = je.init(jax.random.PRNGKey(3))
    pe = DPF(DPFConfig(**SLICE), device="cpu")
    load_jax_variables(pe, _np_tree(variables))
    return je, variables, pe


def _images(seed, frames):
    return np.random.default_rng(seed).random((frames, 128, 128, 3), dtype=np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_encoder_matches_jax(engines, train):
    """Encodings (rtol/atol 1e-4: five conv+BN layers in float32) and, in
    train mode, the updated BN running statistics (biased variance)."""
    je, variables, pe = engines
    imgs = _images(0, 6)
    ref, stats = je.encode(variables, jnp.asarray(imgs), train=train)
    enc = pe.encoder
    saved = {k: v.clone() for k, v in enc.state_dict().items()}
    enc.train(train)
    with torch.no_grad():
        got = pe.encode(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    if train:
        _assert_running_stats(enc, stats)
    enc.load_state_dict(saved)


def _assert_running_stats(module, stats):
    """BN running mean/var against flax's batch_stats (rtol 1e-4 / atol 1e-5)."""
    for i, bn in enumerate(module.norms):
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(bn, ours).numpy(), np.asarray(stats[f"BatchNorm_{i}"][theirs]),
                rtol=1e-4, atol=1e-5, err_msg=f"BatchNorm_{i}.{theirs}")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_decoder_matches_jax(engines, train):
    """Reconstructions (atol 1e-5 on sigmoid outputs) and running stats."""
    je, variables, pe = engines
    z = np.random.default_rng(1).standard_normal((4, 32)).astype(np.float32)
    ref, stats = je.decode(variables, jnp.asarray(z), train=train)
    dec = pe.decoder
    saved = {k: v.clone() for k, v in dec.state_dict().items()}
    dec.train(train)
    with torch.no_grad():
        got = pe.decode(torch.from_numpy(z))
    assert got.shape == (4, 128, 128, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    if train:
        _assert_running_stats(dec, stats)
    dec.load_state_dict(saved)


def test_cosine_measurement_matches_jax(engines):
    """Particle encoder + cosine log-likelihood (rtol 1e-5 / atol 1e-5)."""
    je, variables, pe = engines
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((B, 32)).astype(np.float32)
    particles = (rng.standard_normal((B, N, 2)) * 40).astype(np.float32)
    ref = je.measurement.apply(variables["measurement"], jnp.asarray(enc),
                               jnp.asarray(particles))
    with torch.no_grad():
        got = pe.measurement(torch.from_numpy(enc), torch.from_numpy(particles))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


MEASUREMENTS = ("NN", "gaussian", "CRNVP")


def _scale_tree(tree, keys, factor):
    """``tree`` with the subtrees under ``keys`` multiplied by ``factor``."""
    return {k: (jax.tree_util.tree_map(lambda a: a * factor, v) if k in keys else v)
            for k, v in tree.items()}


@pytest.mark.parametrize("kind", MEASUREMENTS)
def test_measurement_model_matches_jax(kind):
    """NN, gaussian and CRNVP through the bridge (which must cover every
    parameter): log-likelihoods within rtol/atol 1e-5, their gradient
    against the encodings and the particles within rtol 1e-4 / atol 1e-5.
    The CRNVP flow's weights are scaled ×10 from their N(0, 0.01²) init so
    that it is not near the identity."""
    cfg = dict(SLICE, measurement=kind)
    je = JaxDPF(JaxConfig(**cfg))
    variables = je.init(jax.random.PRNGKey(4))
    if kind == "CRNVP":
        variables["measurement"] = {"params": _scale_tree(
            variables["measurement"]["params"], ("cnf",), 10.0)}
    pe = DPF(DPFConfig(**cfg), device="cpu")
    np_vars = _np_tree(variables)
    assert set(torch_state_from_jax(np_vars)) == set(pe.state_dict())
    load_jax_variables(pe, np_vars)
    rng = np.random.default_rng(5)
    enc = rng.standard_normal((B, 32)).astype(np.float32)
    particles = (rng.standard_normal((B, N, 2)) * 40).astype(np.float32)
    probe = rng.standard_normal((B, N)).astype(np.float32)

    def fn(e, p):
        return je.measurement.apply(variables["measurement"], e, p)

    ref = fn(jnp.asarray(enc), jnp.asarray(particles))
    g_ref = jax.grad(lambda e, p: jnp.sum(fn(e, p) * probe), argnums=(0, 1))(
        jnp.asarray(enc), jnp.asarray(particles))
    te, tp = torch.from_numpy(enc).requires_grad_(), torch.from_numpy(particles).requires_grad_()
    got = pe.measurement(te, tp)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(probe)), [te, tp])
    for g, r in zip(grads, g_ref):
        assert float(np.abs(np.asarray(r)).max()) > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def test_bridge_refuses_a_measurement_it_cannot_map(engines):
    _, variables, pe = engines
    tree = _np_tree(variables)
    tree["measurement"]["params"]["unmapped_net"] = {}
    with pytest.raises(KeyError, match="unmapped_net"):
        load_jax_variables(pe, tree)


def test_flax_batchnorm_running_variance_is_biased():
    """torch's BatchNorm stores the unbiased variance; the flax rule the port
    follows stores the biased one."""
    bn = FlaxBatchNorm(1)
    x = torch.tensor([1.0, 2.0, 4.0, 7.0]).reshape(4, 1, 1, 1)
    bn.train()
    bn(x)
    biased = float(x.var(correction=0))
    assert bn.running_var.item() == pytest.approx(0.9 + 0.1 * biased, rel=1e-6)
    assert bn.running_mean.item() == pytest.approx(0.1 * 3.5, rel=1e-6)


def test_bridge_covers_every_parameter_and_buffer(engines):
    _, variables, pe = engines
    assert set(torch_state_from_jax(_np_tree(variables))) == set(pe.state_dict())
    broken = _np_tree(variables)
    del broken["encoder"]["params"]["Dense_0"]
    with pytest.raises(KeyError):
        load_jax_variables(pe, broken)


def test_motion_update_and_bootstrap_identity():
    """motion_update with injected noise equals the JAX one on the same draw
    (exact up to float32 add order); with the flows off prior == proposal."""
    key = jax.random.PRNGKey(4)
    particles = np.random.default_rng(3).standard_normal((B, N, 2)).astype(np.float32)
    vel = np.ones((B, 2), np.float32)
    ref, ref_noise = jdyn.motion_update(key, jnp.asarray(particles), jnp.asarray(vel), 20.0)
    draw = torch.tensor(np.asarray(jax.random.normal(key, (B, N, 2))))
    got, noise = tdyn.motion_update(torch.from_numpy(particles), torch.from_numpy(vel),
                                    20.0, draw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(noise.numpy(), np.asarray(ref_noise), rtol=1e-6)
    phys, jac = tdyn.nf_dynamic_model(None, got, use_nf=False)
    propose, lki, prior, propose_log = tdyn.proposal_likelihood(
        None, None, lambda e, p: torch.zeros(p.shape[:2]), phys, got, torch.zeros(B, 32),
        noise, jac, False, False, 20.0, 20.0)
    assert torch.equal(prior, propose_log) and torch.equal(propose, got)
    assert torch.equal(jac, torch.zeros(B, N))


def test_particle_initialization_modes():
    start = torch.tensor([[10.0, -5.0, 1.0, 1.0]])
    gen = torch.Generator().manual_seed(0)
    p_true, w = particle_initialization(start[:, :2], 128.0, 50, 2, True, gen)
    assert p_true.shape == (1, 50, 2)
    assert abs(float(p_true.mean(dim=1)[0, 0]) - 10.0) < 1.0
    p_unif, w = particle_initialization(start[:, :2], 128.0, 50, 2, False, gen)
    assert float(p_unif.min()) >= -64.0 and float(p_unif.max()) <= 64.0
    np.testing.assert_allclose(w.numpy(), np.log(1.0 / 50), rtol=1e-6)


def _jax_filter_noise(key, width=128.0):
    """Replay the JAX filter's key schedule (dpf.py:325,384; dynamics.py:38;
    the soft resampler's offsets, resampling.py:46)."""
    k_init, k_scan = jax.random.split(key)
    init = jax.random.uniform(k_init, (B, N, 2), minval=-width / 2, maxval=width / 2)
    motion, offsets, k = [], [], k_scan
    for _ in range(T):
        k, k_rs, k_motion = jax.random.split(k, 3)
        motion.append(np.asarray(jax.random.normal(k_motion, (B, N, 2))))
        offsets.append(np.asarray(jax.random.uniform(k_rs, (B, 1), minval=0.0,
                                                     maxval=1.0 / N)))
    return {"init": torch.tensor(np.asarray(init)),
            "motion": torch.from_numpy(np.stack(motion)),
            "resample": torch.from_numpy(np.stack(offsets))}


def test_filter_from_encodings_matches_jax():
    """B=2, N=16, T=5, width 128, use_pallas=True, with JAX encodings and JAX
    noise.  ess_threshold 0.97 makes the gate fire on steps 2 and 4 only, so
    both branches run; gate steps and Sinkhorn iteration counts must be equal,
    histories within atol 2e-4 (particles of magnitude ~130)."""
    cfg = dict(SLICE, ess_threshold=0.97)
    je = JaxDPF(JaxConfig(**cfg))
    variables = je.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    imgs = rng.random((B, T, 128, 128, 3), dtype=np.float32)
    start = (rng.standard_normal((B, 4)) * 10).astype(np.float32)
    vel = (rng.standard_normal((B, T, 2)) * 2).astype(np.float32)
    enc, _ = je.encode(variables, jnp.asarray(imgs.reshape(B * T, 128, 128, 3)),
                       train=False)
    enc = enc.reshape(B, T, -1)
    key = jax.random.PRNGKey(100)
    ref = je.filter_from_encodings(variables, enc, jnp.asarray(start),
                                   jnp.asarray(vel), key, train=True)

    pe = DPF(DPFConfig(**cfg), device="cpu")
    load_jax_variables(pe, _np_tree(variables))
    with torch.no_grad():
        out = pe.filter_from_encodings(torch.tensor(np.asarray(enc)),
                                       torch.from_numpy(start), torch.from_numpy(vel),
                                       _jax_filter_noise(key))
    np.testing.assert_array_equal(out.resampled.numpy(), np.asarray(ref.resampled))
    assert out.resampled.any() and not out.resampled.all()
    np.testing.assert_array_equal(out.sinkhorn_iters.numpy(),
                                  np.asarray(ref.sinkhorn_iters))
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(ref.indices))
    for field, atol in (("particles", 2e-4), ("weights", 1e-6), ("noise", 1e-4),
                        ("likelihoods", 1e-5), ("jacobians", 0), ("priors", 1e-5),
                        ("init_weights_log", 1e-6), ("obs_likelihood", 1e-5)):
        np.testing.assert_allclose(getattr(out, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-5, atol=atol, err_msg=field)


# the resampling paths beside the streaming one, as (overrides, atol on the
# particles, atol on the log terms): the bootstrap filter's tolerances, and
# the CNF-DPF's (tests/test_torch_cnf.py) where the flows run
FILTER_PATHS = {
    "dense_ot": (dict(use_pallas=False), 2e-4, 1e-5),
    # the Gaussian measurement weighs the particles unevenly enough that
    # systematic resampling moves indices
    "soft": (dict(resampler_type="soft", measurement="gaussian"), 2e-4, 1e-5),
    "soft_alpha1": (dict(resampler_type="soft", alpha=1.0, measurement="gaussian"), 2e-4,
                    1e-5),
    "warm_start": (dict(sinkhorn_warm_start=True), 2e-4, 1e-5),
    "nfdpf_crnvp": (dict(measurement="CRNVP", nf_dyn=True, nf_cond=True,
                         pallas_coupling=True), 5e-4, 1e-4),
}


@pytest.mark.parametrize("case", sorted(FILTER_PATHS))
def test_filter_path_matches_jax(case):
    """B=2, N=16, T=5 with random encodings and the JAX noise (the soft
    resampler's offsets replayed per step from ``k_rs``), every step
    resampled; every flow and the CRNVP measurement's scaled ×10 from their
    init.  Gate steps, ancestor
    indices and Sinkhorn iteration counts (0 off the streaming path) equal;
    histories within rtol 1e-5 and the case's atol."""
    overrides, atol_p, atol_log = FILTER_PATHS[case]
    cfg = dict(SLICE, ess_threshold=1.01, **overrides)
    je = JaxDPF(JaxConfig(**cfg))
    variables = _scale_tree(je.init(jax.random.PRNGKey(0)), ("nf_dyn", "cond_model"), 10.0)
    variables["measurement"] = {"params": _scale_tree(
        variables["measurement"]["params"], ("cnf",), 10.0)}
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((B, T, 32)).astype(np.float32)
    start = (rng.standard_normal((B, 4)) * 10).astype(np.float32)
    vel = (rng.standard_normal((B, T, 2)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(100)
    ref = jax.tree_util.tree_map(np.asarray, je.filter_from_encodings(
        variables, jnp.asarray(enc), jnp.asarray(start), jnp.asarray(vel), key, train=True))

    pe = DPF(DPFConfig(**cfg), device="cpu")
    load_jax_variables(pe, _np_tree(variables))
    with torch.no_grad():
        out = pe.filter_from_encodings(torch.from_numpy(enc), torch.from_numpy(start),
                                       torch.from_numpy(vel), _jax_filter_noise(key))
    assert out.resampled.all()
    np.testing.assert_array_equal(out.resampled.numpy(), ref.resampled)
    np.testing.assert_array_equal(out.sinkhorn_iters.numpy(), ref.sinkhorn_iters)
    assert (ref.sinkhorn_iters > 0).any() == (case in ("warm_start", "nfdpf_crnvp"))
    np.testing.assert_array_equal(out.indices.numpy(), ref.indices)
    if case.startswith("soft"):
        assert (ref.indices != np.arange(N)).any()
    for field, atol in (("particles", atol_p), ("weights", 1e-6), ("noise", 1e-4),
                        ("likelihoods", atol_log), ("jacobians", atol_log),
                        ("priors", atol_log), ("init_weights_log", 1e-6),
                        ("obs_likelihood", atol_log)):
        np.testing.assert_allclose(getattr(out, field).numpy(), getattr(ref, field),
                                   rtol=1e-5, atol=atol, err_msg=field)


# settings the port refused until the ROADMAP item named beside each brought
# them (4, 18, and 23 for soft resampling under a particle axis)
UNSUPPORTED = {
    "encode_per_step": (dict(encode_per_step=True), 18),
    "remat": (dict(remat_scan_step=True), 18),
    "bf16": (dict(compute_dtype="bfloat16"), 18),
    "torch_init": (dict(torch_init=True), 4),
    "mesh": (dict(mesh_particle=2, resampler_type="soft"), 23),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unported_settings_raise(case):
    """Each setting the port once refused builds, alone and beside a data
    or particle mesh (soft resampling beside each on a particle mesh); what
    still raises beside it is a value no package runs (``ValueError``)."""
    overrides, _ = UNSUPPORTED[case]
    for mesh in ({}, dict(mesh_data=2), dict(mesh_particle=2),
                 dict(mesh_particle=2, resampler_type="soft")):
        DPF(DPFConfig(**{**SLICE, **overrides, **mesh}), device="cpu")
    with pytest.raises(ValueError, match="unknown resampler"):
        DPF(DPFConfig(**{**SLICE, **overrides, "resampler_type": "multinomial"}), device="cpu")


def _train_batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((B, T, 128, 128, 3), dtype=np.float32),
            "state": (rng.standard_normal((B, T, 4)) * 10).astype(np.float32),
            "start_state": (rng.standard_normal((B, 4)) * 10).astype(np.float32)}


# settings the port refused until it ran them, and the two other
# measurement models
PORTED = {
    "measurement_NN": dict(measurement="NN"),
    "measurement_gaussian": dict(measurement="gaussian"),
    "measurement_CRNVP": dict(measurement="CRNVP"),
    "measurement_CGLOW": dict(measurement="CGLOW"),
    "sdpf": dict(train_type="SDPF", labeled_ratio=0.5, block_length=2),
    "soft_resampler": dict(resampler_type="soft"),
    "dense_ot": dict(use_pallas=False),
    "ot_transport_grad": dict(ot_transport_grad=True),
    "warm_start": dict(sinkhorn_warm_start=True),
}


@pytest.mark.parametrize("case", sorted(PORTED))
def test_ported_settings_take_a_train_step(case):
    """Each setting builds on the CPU and takes one train step from the
    generator, resampling every step: finite losses, every firing counted,
    Sinkhorn iterations only on the streaming path, and a finite gradient
    for every parameter of the measurement model."""
    cfg = DPFConfig(**dict(SLICE, ess_threshold=1.01, **PORTED[case]))
    trainer = Trainer(cfg, device="cpu")
    metrics = trainer.train_step(_train_batch(8), generator=trainer.generator(0))
    assert all(np.isfinite(float(metrics[k])) for k in ("loss", "loss_sup", "loss_ae"))
    assert metrics["resample_count"] == T
    assert (metrics["sinkhorn_iters"] > 0) == (case in ("measurement_NN", "measurement_gaussian",
                                                        "measurement_CRNVP", "measurement_CGLOW",
                                                        "sdpf", "warm_start"))
    grads = [p.grad for p in trainer.engine.measurement.parameters()]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("overrides", [dict(resampler_type="soft"), dict(use_pallas=False),
                                       dict(ot_transport_grad=True)],
                         ids=["soft", "dense_ot", "ot_transport_grad"])
def test_warm_start_off_the_streaming_path_raises(overrides):
    """The warm start runs on the streaming OT path only: any other
    resampling path is refused when the filter is built."""
    with pytest.raises(ValueError, match="sinkhorn_warm_start"):
        DPF(DPFConfig(**dict(SLICE, sinkhorn_warm_start=True, **overrides)), device="cpu")


# chains and whether the CUDA coupling kernels refuse them, as (overrides,
# refused on CUDA): the narrow pair takes them up to 16 wide (9-15 padded to
# 16) and up to 8 blocks, with a context of any width (its share of layer 0
# is a kernel of its own), and the wide pair every other chain up to
# WIDE_MAX_HIDDEN wide, with any number of blocks: hidden 17, nine blocks,
# four blocks at width 9-16 (the narrow backward's shared memory), four at 32
# and hidden 256 build for CUDA
COUPLING_LIMITS = {
    "hidden16": (dict(flow_hidden_dim=16), False),
    "hidden12": (dict(flow_hidden_dim=12), False),
    "hidden17": (dict(flow_hidden_dim=17), False),
    "blocks9": (dict(n_sequence=9), False),
    "hidden16_module_route": (dict(flow_hidden_dim=16, pallas_coupling=False), False),
    # the proposal's context is the 192-wide CGLOW encoding + 4
    "cglow_proposal": (dict(measurement="CGLOW"), False),
    "cglow_proposal_module_route": (dict(measurement="CGLOW", pallas_coupling=False), False),
    # --hiddensize 117 makes the proposal's context 121 wide
    "hiddensize117": (dict(hidden_size=117), False),
    "blocks4_hidden16": (dict(n_sequence=4, flow_hidden_dim=16), False),
    "hidden32_blocks4": (dict(n_sequence=4, flow_hidden_dim=32), False),
    "hidden256": (dict(flow_hidden_dim=256), False),
}


@pytest.fixture
def one_intra_op_thread():
    """torch on one intra-op thread for the test, restored after it.  The
    test workers share the machine's cores, each with as many torch
    threads: a train step of 256-wide flows took ~195 s in each of six
    processes at 8 threads against ~2 s at one (the checks here are
    finiteness and non-zero gradients, which no thread count moves)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", sorted(COUPLING_LIMITS))
def test_coupling_kernel_limits_are_refused_when_built(case, one_intra_op_thread):
    """A CNF-DPF whose packed chains neither pair of coupling kernels takes is
    refused when it is built for CUDA, before anything reaches the card (so
    this runs without one); one they take, and the module route, are not
    refused.  On the CPU the same configuration builds and takes a train
    step on the plain version."""
    overrides, refused = COUPLING_LIMITS[case]
    cfg = DPFConfig(**{**SLICE, "num_particles": 10, "ess_threshold": 1.01, "nf_dyn": True,
                       "nf_cond": True, "pallas_coupling": True, **overrides})
    if refused:
        with pytest.raises(NotImplementedError, match="CUDA coupling kernels"):
            DPF(cfg, device="cuda")
    else:
        check_coupling_kernels(cfg)
    rng = np.random.default_rng(7)
    batch = {"image": rng.random((B, T, 128, 128, 3), dtype=np.float32),
             "state": (rng.standard_normal((B, T, 4)) * 10).astype(np.float32),
             "start_state": (rng.standard_normal((B, 4)) * 10).astype(np.float32)}
    trainer = Trainer(cfg, device="cpu")
    metrics = trainer.train_step(batch, generator=trainer.generator(0))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["resample_count"]) > 0
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for name, p in trainer.engine.named_parameters() if name.startswith("nf_dyn"))


def test_coupling_kernels_refuse_a_chain_past_the_widest_when_built():
    """A chain wider than ``WIDE_MAX_HIDDEN`` (the context share takes a
    thread a hidden unit of a net) is refused when the filter is built for
    CUDA, before anything reaches the card; the module route is not."""
    from nfdpf_torch.ops.cuda.coupling_cuda import WIDE_MAX_HIDDEN

    cfg = DPFConfig(**{**SLICE, "nf_dyn": True, "nf_cond": True, "pallas_coupling": True,
                       "flow_hidden_dim": WIDE_MAX_HIDDEN + 1})
    with pytest.raises(NotImplementedError, match="CUDA coupling kernels.*hidden <= 1024"):
        DPF(cfg, device="cuda")
    check_coupling_kernels(DPFConfig(**{**SLICE, "nf_dyn": True, "pallas_coupling": False,
                                        "flow_hidden_dim": 2048}))
