"""nfdpf_torch trainer vs the JAX package: one full training step (loss,
every parameter gradient, the parameters after Adam, the BN running
statistics) of the bootstrap DPF on streaming OT, of bench.py's
configuration (dense OT) and of the NF-DPF with the CRNVP measurement, the
eval step, and the package's boundaries (no JAX import, no silent CPU
fallback).  The JAX Pallas kernels run in interpret mode; the
port runs on the CPU through the kernels' plain versions."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nfdpf_tpu.ops.pallas.sinkhorn_pallas as sp
from nfdpf_tpu.config import DPFConfig as JaxConfig
from nfdpf_tpu.train import Trainer as JaxTrainer
from nfdpf_torch.bridge import load_jax_variables, torch_state_from_jax
from nfdpf_torch.config import DPFConfig
from nfdpf_torch.train import Trainer

B, N, T = 2, 16, 5
CFG = dict(num_particles=N, sequence_length=T, batch_size=B, width=128,
           resampler_type="ot", measurement="cos", train_type="DPF",
           use_pallas=True, compute_dtype="float32", ess_threshold=0.97)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(sp, "_INTERPRET", True)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.random((B, T, 128, 128, 3), dtype=np.float32),
        "state": (rng.standard_normal((B, T, 4)) * 10).astype(np.float32),
        "start_state": (rng.standard_normal((B, 4)) * 10).astype(np.float32),
    }


def _jax_loss_noise(key, width=128.0):
    """Replay the JAX key schedule of ``Trainer._loss`` (train.py:90-91) and
    the filter (dpf.py:325,384; dynamics.py:38; the soft resampler's
    offsets, resampling.py:46) as the port's noise dict."""
    k_vel, k_filter, _ = jax.random.split(key, 3)
    k_init, k_scan = jax.random.split(k_filter)
    init = jax.random.uniform(k_init, (B, N, 2), minval=-width / 2, maxval=width / 2)
    motion, offsets, k = [], [], k_scan
    for _ in range(T):
        k, k_rs, k_motion = jax.random.split(k, 3)
        motion.append(np.asarray(jax.random.normal(k_motion, (B, N, 2))))
        offsets.append(np.asarray(jax.random.uniform(k_rs, (B, 1), minval=0.0,
                                                     maxval=1.0 / N)))
    return {"vel": torch.tensor(np.asarray(jax.random.normal(k_vel, (B, T, 2)))),
            "init": torch.tensor(np.asarray(init)),
            "motion": torch.from_numpy(np.stack(motion)),
            "resample": torch.from_numpy(np.stack(offsets))}


def _variables(params, rest):
    return _np_tree({k: {"params": params[k], **rest[k]} for k in params})


@pytest.fixture(scope="module")
def jax_step():
    """One JAX value_and_grad + Adam step on a fixed batch and key."""
    trainer = JaxTrainer(JaxConfig(**CFG))
    state = trainer.init_state(jax.random.PRNGKey(0))
    batch = _batch(1)
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def step(params):
        (loss, aux), grads = jax.value_and_grad(trainer._loss, has_aux=True)(
            params, state.rest, jbatch, key, True)
        updates, _ = trainer.tx.update(grads, state.opt_state, params)
        return loss, aux, grads, optax.apply_updates(params, updates)

    loss, aux, grads, new_params = step(state.params)
    return dict(state=state, batch=batch, key=key, loss=loss, aux=aux, grads=grads,
                new_params=new_params, trainer=trainer)


def _port_trainer(params, rest):
    trainer = Trainer(DPFConfig(**CFG), device="cpu")
    load_jax_variables(trainer.engine, _variables(params, rest))
    return trainer


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_train_step_matches_jax(jax_step):
    """One train step against the JAX one.

    * loss terms: rtol 1e-5; gate firings and Sinkhorn iterations: exact;
    * every parameter gradient, as ‖g − g_jax‖/‖g_jax‖ per tensor: 1e-4, and
      1e-2 for the decoder; the two flow chains take no part in the
      bootstrap filter: JAX gives them exactly zero, the port none (Adam
      then leaves them alone, which equals optax's update on zero).  The decoder's gradient passes the backward of
      its last BatchNorm, which cancels most of it: float32 results of
      either framework differ from a float64 reference by up to 3e-3 there
      (measured on this decoder at these shapes);
    * the parameters after the step: Adam (lr 1e-4, optax's defaults)
      applied to the port's own gradient, atol 1e-7 — on the first step each
      weight moves by about lr·sign(g), so comparing with the JAX weights
      directly would test the sign of gradients that are round-off;
    * BN running statistics after the step: rtol 1e-4 / atol 1e-5.
    """
    js = jax_step
    trainer = _port_trainer(js["state"].params, js["state"].rest)
    before = {k: v.detach().clone() for k, v in trainer.engine.named_parameters()}
    metrics = trainer.train_step(js["batch"], noise=_jax_loss_noise(js["key"]))

    aux = js["aux"]
    assert metrics["resample_count"] == int(aux["resample_count"]) > 0
    assert metrics["sinkhorn_iters"] == int(aux["sinkhorn_iters"]) > 0
    for k, ref in (("loss", js["loss"]), ("loss_sup", aux["loss_sup"]),
                   ("loss_ae", aux["loss_ae"]), ("obs_likelihood", aux["obs_likelihood"])):
        np.testing.assert_allclose(float(metrics[k]), float(ref), rtol=1e-5, err_msg=k)

    grads = torch_state_from_jax(
        {k: {"params": v} for k, v in _np_tree(js["grads"]).items()})
    named = dict(trainer.engine.named_parameters())
    assert set(grads) == set(named)
    unused = [k for k in named if k.startswith(("nf_dyn.", "cond_model."))]
    assert len(unused) == 2 * 2 * 4 * 6
    for name, g_ref in grads.items():
        if name in unused:
            assert named[name].grad is None and not g_ref.any(), name
            continue
        bound = 1e-2 if name.startswith("decoder.") else 1e-4
        assert _rel(named[name].grad.numpy(), g_ref) < bound, name

    tx = optax.adam(DPFConfig().lr)
    port_grads = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
                  for k, p in named.items()}
    params0 = {k: v.numpy() for k, v in before.items()}
    updates, _ = tx.update(port_grads, tx.init(params0), params0)
    for name, want in optax.apply_updates(params0, updates).items():
        np.testing.assert_allclose(named[name].detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-7, err_msg=name)

    after = torch_state_from_jax(_variables(js["new_params"], aux["new_rest"]))
    buffers = dict(trainer.engine.named_buffers())
    for name, buf in buffers.items():
        np.testing.assert_allclose(buf.numpy(), after[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


# bench.py's configuration (dense OT: use_pallas off, bench.py:92-99) with the
# gate firing as in CFG, and the paper's NF-DPF (RealNVP dynamics and
# proposal on the packed chains, CRNVP measurement) firing every step
PATHS = {
    "bench_dense_ot": dict(CFG, use_pallas=False),
    "nfdpf_crnvp": dict(CFG, ess_threshold=1.01, nf_dyn=True, nf_cond=True,
                        pallas_coupling=True, measurement="CRNVP"),
}
FLOWS = ("nf_dyn.", "cond_model.")


@pytest.fixture(scope="module", params=sorted(PATHS))
def path_step(request):
    """One JAX value_and_grad + Adam step of a path; every flow's weights
    (both chains and the CRNVP measurement's) scaled ×10 from their
    N(0, 0.01²) init, as tests/test_torch_cnf.py does."""
    cfg = PATHS[request.param]
    trainer = JaxTrainer(JaxConfig(**cfg))
    state = trainer.init_state(jax.random.PRNGKey(0))
    scale = lambda t: jax.tree_util.tree_map(lambda a: a * 10.0, t)  # noqa: E731
    params = {k: scale(v) if k in ("nf_dyn", "cond_model") else v
              for k, v in state.params.items()}
    if "cnf" in params["measurement"]:
        params["measurement"] = dict(params["measurement"], cnf=scale(params["measurement"]["cnf"]))
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
    return dict(name=request.param, cfg=cfg, params=params, rest=state.rest, batch=batch,
                key=key, loss=loss, aux=aux, grads=grads, new_params=new_params)


def test_path_train_step_matches_jax(path_step):
    """One train step of each path against the JAX one, at the tolerances of
    ``test_train_step_matches_jax`` (the two RealNVP chains at
    tests/test_torch_cnf.py's 1e-3): loss terms rtol 1e-5; firings exact and
    Sinkhorn iterations exact (0 on the dense path, as in the JAX package);
    every gradient as ‖g − g_jax‖/‖g_jax‖ per tensor 1e-4, the decoder's
    1e-2; a chain the path does not run gets none (JAX: zero); the
    parameters after the step are Adam on the port's gradient, atol 1e-7;
    BN running statistics rtol 1e-4 / atol 1e-5."""
    js = path_step
    cfg = js["cfg"]
    trainer = Trainer(DPFConfig(**cfg), device="cpu")
    load_jax_variables(trainer.engine, _variables(js["params"], js["rest"]))
    before = {k: v.detach().clone() for k, v in trainer.engine.named_parameters()}
    metrics = trainer.train_step(js["batch"], noise=_jax_loss_noise(js["key"]))

    aux = js["aux"]
    assert metrics["resample_count"] == int(aux["resample_count"]) > 0
    assert metrics["sinkhorn_iters"] == int(aux["sinkhorn_iters"])
    assert (metrics["sinkhorn_iters"] > 0) == cfg["use_pallas"]
    for k, ref in (("loss", js["loss"]), ("loss_sup", aux["loss_sup"]),
                   ("loss_ae", aux["loss_ae"]), ("obs_likelihood", aux["obs_likelihood"])):
        np.testing.assert_allclose(float(metrics[k]), float(ref), rtol=1e-5, err_msg=k)

    grads = torch_state_from_jax(
        {k: {"params": v} for k, v in _np_tree(js["grads"]).items()})
    named = dict(trainer.engine.named_parameters())
    assert set(grads) == set(named)
    flows_on = cfg.get("nf_dyn", False)
    for name, g_ref in grads.items():
        grad = named[name].grad
        if name.startswith(FLOWS) and not flows_on:
            assert grad is None and not g_ref.any(), name
            continue
        assert grad is not None, name
        bound = (1e-3 if name.startswith(FLOWS) else
                 1e-2 if name.startswith("decoder.") else 1e-4)
        if float(np.linalg.norm(g_ref)) > 0:
            assert _rel(grad.numpy(), g_ref) < bound, name
        else:
            assert float(grad.abs().sum()) == 0, name
    if cfg["measurement"] == "CRNVP":
        assert sum(float(p.grad.abs().sum())
                   for p in trainer.engine.measurement.cnf.parameters()) > 0

    tx = optax.adam(DPFConfig().lr)
    port_grads = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
                  for k, p in named.items()}
    params0 = {k: v.numpy() for k, v in before.items()}
    updates, _ = tx.update(port_grads, tx.init(params0), params0)
    for name, want in optax.apply_updates(params0, updates).items():
        np.testing.assert_allclose(named[name].detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-7, err_msg=name)
    after = torch_state_from_jax(_variables(js["new_params"], aux["new_rest"]))
    for name, buf in trainer.engine.named_buffers():
        np.testing.assert_allclose(buf.numpy(), after[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_eval_step_matches_jax(jax_step):
    """Eval mode: BN running statistics, plain RMSE; losses within rtol 1e-5."""
    js = jax_step
    state = js["state"]
    batch = {k: jnp.asarray(v) for k, v in js["batch"].items()}
    key = jax.random.PRNGKey(9)
    ref = js["trainer"].make_eval_step()(state, batch, key)[0]
    trainer = _port_trainer(state.params, state.rest)
    metrics, _ = trainer.eval_step(js["batch"], noise=_jax_loss_noise(key))
    for k in ("loss", "loss_sup", "loss_ae", "obs_likelihood"):
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    assert metrics["resample_count"] == int(ref["resample_count"])
    assert metrics["sinkhorn_iters"] == int(ref["sinkhorn_iters"])


def test_uint8_images_are_scaled_like_float(jax_step):
    """uint8 frames are normalised on the device: same loss as frames/255."""
    js = jax_step
    trainer = _port_trainer(js["state"].params, js["state"].rest)
    batch = dict(js["batch"])
    batch["image"] = (batch["image"] * 255).astype(np.uint8)
    noise = _jax_loss_noise(js["key"])
    as_float = dict(batch, image=batch["image"].astype(np.float32) / 255.0)
    m_u8, _ = trainer.eval_step(batch, noise=noise)
    m_f, _ = trainer.eval_step(as_float, noise=noise)
    assert float(m_u8["loss"]) == pytest.approx(float(m_f["loss"]), rel=1e-6)


def test_train_steps_draw_from_generator():
    """Without injected noise the trainer draws from a generator: the same
    seed gives the same step, and the loss stays finite."""
    batch = _batch(2)
    losses = []
    for _ in range(2):
        trainer = Trainer(DPFConfig(**CFG), device="cpu")
        m = trainer.train_step(batch, generator=trainer.generator(11))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


def test_import_loads_neither_jax_nor_the_jax_package():
    """Every module of the port, the entry point, the data pipeline, the
    utilities and the plots included, imports neither JAX nor the JAX
    package; nor does it import matplotlib, which the plots load when they
    draw."""
    code = ("import sys, nfdpf_torch, nfdpf_torch.train, nfdpf_torch.bridge\n"
            "import nfdpf_torch.main, nfdpf_torch.data.simulator, nfdpf_torch.data.dataset\n"
            "import nfdpf_torch.utils.checkpoint, nfdpf_torch.utils.metrics\n"
            "import nfdpf_torch.utils.freeze, nfdpf_torch.utils.profiling, nfdpf_torch.viz\n"
            "import nfdpf_torch.ops.rqs, nfdpf_torch.ops.flows, nfdpf_torch.data.skew_t_plot\n"
            "import nfdpf_torch.ops, nfdpf_torch.models, nfdpf_torch.data, nfdpf_torch.utils\n"
            "import nfdpf_torch.parallel\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'nfdpf_tpu', 'matplotlib')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("package", ["", "ops", "models", "data", "utils", "parallel"])
def test_package_exports_equal_the_jax_packages(package):
    """Each sub-package's ``__all__`` (and the top level's, with
    ``__version__``) names what the JAX package's names, and each name
    resolves."""
    import importlib

    ours = importlib.import_module(".".join(filter(None, ("nfdpf_torch", package))))
    theirs = importlib.import_module(".".join(filter(None, ("nfdpf_tpu", package))))
    assert ours.__all__ == theirs.__all__
    assert all(hasattr(ours, name) for name in ours.__all__)
    if not package:
        assert ours.__version__ == theirs.__version__


# JAX-package names with no counterpart in the port's module of the same path
JAX_ONLY = {
    "Array": "the alias of jax.Array; the port annotates torch.Tensor",
    "TrainState": "train.py: the flax train state; the port's Trainer holds a module and "
                  "a torch optimizer",
    "_split_variables": "train.py: flax's collections apart; a torch module holds them together",
    "_merge_variables": "train.py: the same, merged back",
    "_LoopState": "ops/sinkhorn.py: the carry of lax.while_loop; the port loops in Python",
    "_mm": "ops/linalg.py: jnp.matmul at HIGHEST precision; torch's float32 matmul is "
           "full precision with TF32 off",
    "_inv_fwd": "ops/linalg.py: a custom_vjp half; the port's _Inv is an autograd.Function",
    "_inv_bwd": "ops/linalg.py: the same",
    "_logabsdet_fwd": "ops/linalg.py: a custom_vjp half; the port's _LogAbsDet",
    "_logabsdet_bwd": "ops/linalg.py: the same",
    "_logabsdet_fwd_impl": "ops/linalg.py: the port's _logabsdet_impl",
    "_normal_init": "models/cglow.py: a flax initialiser; flax_init_ reads param_init_std",
    "_dense": "models/nets.py: a Dense with torch's init; flax_init_'s torch_init marks",
    "torch_uniform": "models/nets.py: torch's U(±1/√fan_in); flax_init_'s torch_init draws it",
    "ThroughputMeter": "utils/profiling.py: nothing read the port's meter; its benchmark "
                       "times its own window, and the port's spans time the layers",
}


def _top_level_names(path):
    import ast

    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, ast.AnnAssign) else [])
        names.update(t.id for t in targets if isinstance(t, ast.Name))
    return names


def test_every_jax_module_has_its_counterpart():
    """Module by module, every top-level def, class and assignment of the
    JAX package is in the port's module of the same path, but for
    ``JAX_ONLY``.  ``ops/pallas`` is left out: its kernels are ported into
    ``ops/cuda`` under the CUDA route's names (the kernel table in
    PERF.md)."""
    import glob

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    missing, seen = {}, set()
    for path in sorted(glob.glob(os.path.join(root, "nfdpf_tpu", "**", "*.py"), recursive=True)):
        rel = os.path.relpath(path, os.path.join(root, "nfdpf_tpu"))
        if rel.startswith("ops" + os.sep + "pallas"):
            continue
        port = os.path.join(root, "nfdpf_torch", rel)
        ours = _top_level_names(port) if os.path.exists(port) else set()
        seen |= _top_level_names(path)
        left = sorted(_top_level_names(path) - ours - set(JAX_ONLY))
        if left:
            missing[rel] = left
    assert not missing, missing
    assert set(JAX_ONLY) <= seen, sorted(set(JAX_ONLY) - seen)


def test_trainer_needs_a_gpu_unless_told_cpu(monkeypatch, tmp_path):
    """Without a GPU the entry points raise unless given ``device="cpu"``:
    the trainer, ``main`` (before it makes any data or directory) and the
    simulator's ``generate_dataset``."""
    from nfdpf_torch.data.simulator import generate_dataset
    from nfdpf_torch.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(DPFConfig(**CFG))
    assert Trainer(DPFConfig(**CFG), device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--data-path", str(tmp_path / "disks")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_dataset(str(tmp_path / "disks"), num_examples=8, file_size=10)
    assert os.listdir(tmp_path) == []
