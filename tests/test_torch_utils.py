"""nfdpf_torch's utilities and plots, as tests/test_utils_extra.py and
tests/test_viz.py hold the JAX package's: parameter freezing against the
JAX masked optimizer, the metrics logger, the profiler trace (its spans:
tests/test_torch_spans.py), checkpoints, and every plot (which needs
matplotlib and says so when it is missing)."""

import builtins
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nfdpf_tpu.utils.freeze import masked_optimizer as jax_masked_optimizer
from nfdpf_torch import viz
from nfdpf_torch.utils.checkpoint import (
    checkpoint_metadata,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from nfdpf_torch.utils.freeze import frozen_mask, masked_optimizer
from nfdpf_torch.utils.metrics import MetricsLogger, is_primary
from nfdpf_torch.utils.profiling import trace


class _Two(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = torch.nn.Linear(3, 2)
        self.flow = torch.nn.Linear(2, 1)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_masked_optimizer_matches_jax(opt):
    """A frozen top-level module keeps its weights and gets no optimizer
    state; the rest moves as under JAX's ``masked_optimizer``: SGD rtol
    1e-6, Adam 1e-4 (torch takes Adam's bias corrections in float64, optax
    in float32, where 1 − 0.999 is 1.3e-5 off)."""
    model = _Two()
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(1.0)
    params = {name: p.detach().numpy().copy() for name, p in model.named_parameters()}
    grads = {name: np.full_like(v, 0.5) for name, v in params.items()}
    cls, kw, tx = ((torch.optim.SGD, dict(lr=0.1), optax.sgd(0.1)) if opt == "sgd" else
                   (torch.optim.Adam, dict(lr=0.1), optax.adam(0.1)))
    optimizer = masked_optimizer(cls, model, frozen=("encoder",), **kw)
    jparams = {"encoder": {k: v for k, v in params.items() if k.startswith("encoder")},
               "flow": {k: v for k, v in params.items() if k.startswith("flow")}}
    jtx = jax_masked_optimizer(tx, jparams, frozen=("encoder",))
    jstate = jtx.init(jparams)
    jgrads = jax.tree_util.tree_map(lambda v: jnp.full_like(v, 0.5), jparams)
    for _ in range(2):
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[name])
        optimizer.step()
        updates, jstate = jtx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for name, p in model.named_parameters():
        want = jparams[name.split(".")[0]][name]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=1e-6 if opt == "sgd" else 1e-4, err_msg=name)
    np.testing.assert_array_equal(model.encoder.weight.detach().numpy(), 1.0)
    assert not any(p is q for group in optimizer.param_groups for p in group["params"]
                   for q in model.encoder.parameters())


def test_frozen_mask_by_top_level_name():
    mask = frozen_mask(_Two(), ["encoder"])
    assert mask == {"encoder.weight": True, "encoder.bias": True,
                    "flow.weight": False, "flow.bias": False}


def test_metrics_logger_jsonl(tmp_path):
    assert is_primary()
    log_dir = str(tmp_path / "logs")
    logger = MetricsLogger(log_dir, tensorboard=False)
    logger.scalar("Sup_loss/loss", 1.25, 3)
    logger.close()
    lines = open(os.path.join(log_dir, "metrics.jsonl")).readlines()
    rec = json.loads(lines[0])
    assert rec["tag"] == "Sup_loss/loss" and rec["value"] == 1.25 and rec["step"] == 3


def test_profiler_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        _ = torch.arange(8.0) * 2
    with open(tmp_path / "prof" / "trace.json") as fh:
        assert json.load(fh)["traceEvents"]


def test_checkpoint_roundtrip_and_latest(tmp_path):
    """A checkpoint is a directory; saving again replaces it whole; the
    latest ``ckpt_<n>`` is found by its number."""
    tree = {"model": {"w": torch.arange(3.0)}, "optimizer": {"state": {}, "param_groups": []},
            "epoch": 7}
    path = str(tmp_path / "ckpt_2")
    save_checkpoint(path, tree)
    assert os.path.isdir(path)
    got = restore_checkpoint(path)
    assert got["epoch"] == 7 and torch.equal(got["model"]["w"], tree["model"]["w"])
    save_checkpoint(path, dict(tree, epoch=8))
    assert restore_checkpoint(path)["epoch"] == 8
    assert os.listdir(path) == ["checkpoint.pt"]
    save_checkpoint(str(tmp_path / "ckpt_10"), tree)
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_10")
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def test_checkpoint_metadata_reads_shapes_and_dtypes_only(tmp_path):
    """``checkpoint_metadata`` gives the saved tree with every tensor on the
    meta device (shape and dtype, no data) and the other leaves as saved."""
    opt = torch.optim.Adam(_Two().parameters())
    opt.step()
    tree = {"model": {"w": torch.arange(6.0).reshape(2, 3),
                      "n": torch.zeros(4, dtype=torch.int64)},
            "optimizer": opt.state_dict(), "epoch": 3, "name": "best"}
    path = str(tmp_path / "ckpt_0")
    save_checkpoint(path, tree)
    meta = checkpoint_metadata(path)
    full = restore_checkpoint(path)
    leaves, ref = [], []
    torch.utils._pytree.tree_map(leaves.append, meta)
    torch.utils._pytree.tree_map(ref.append, full)
    assert len(leaves) == len(ref)
    assert any(torch.is_tensor(a) for a in ref)
    for got, want in zip(leaves, ref):
        if torch.is_tensor(want):
            assert got.is_meta and got.shape == want.shape and got.dtype == want.dtype
        else:
            assert got == want
    assert meta["epoch"] == 3 and meta["name"] == "best"


def test_all_plots_render(tmp_path):
    """Every plot renders and saves, as tests/test_viz.py checks the JAX ones."""
    rng = np.random.default_rng(0)
    b, t, n = 2, 6, 16
    images = rng.uniform(size=(t, 128, 128, 3)).astype(np.float32)
    particles = rng.normal(size=(t, n, 2)).astype(np.float32) * 30
    weights = rng.dirichlet(np.ones(n), size=t).astype(np.float32)
    state = rng.normal(size=(t, 4)).astype(np.float32) * 30
    pred = state[:, :2] + 1.0

    figs = viz.plot_obs_tracking(images, particles, weights, state, pred,
                                 str(tmp_path / "track"), steps=[0, 3])
    assert len(figs) == 2
    assert os.path.exists(tmp_path / "track" / "tracking_step_000.png")
    particles4 = rng.normal(size=(t, n, 4)).astype(np.float32) * 30
    figs = viz.plot_obs_tracking(images, torch.from_numpy(particles4), weights, state,
                                 state + 1.0, str(tmp_path / "track4"))
    assert len(figs) == t
    viz.plot_state_tracking(state, pred, str(tmp_path / "traj.png"))
    viz.plot_ess_tracking(np.stack([weights] * b), str(tmp_path / "ess.png"))
    viz.plot_motion_model(particles[0], particles[1], state[0], str(tmp_path / "motion.png"))
    imgs_bt = rng.uniform(size=(b, t, 64, 64, 3)).astype(np.float32)
    viz.plot_obs(imgs_bt, imgs_bt, str(tmp_path / "recon.png"), steps=(0, 3))
    for name in ("traj.png", "ess.png", "motion.png", "recon.png"):
        assert os.path.exists(tmp_path / name), name


def test_plots_raise_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is missing, ``available`` says so and a plot raises
    ImportError (nothing is skipped quietly)."""
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    monkeypatch.setattr(viz.importlib.util, "find_spec", lambda name: None)
    assert not viz.available()
    with pytest.raises(ImportError):
        viz.plot_state_tracking(np.zeros((3, 4)), np.zeros((3, 2)), str(tmp_path / "t.png"))
