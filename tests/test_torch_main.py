"""nfdpf_torch's entry point and epoch loops vs the JAX package: the AE
pretraining step, ``fit`` over two epochs of simulator data (eval histories,
the best epoch's histories and checkpoint), ``fit_fused`` against the
port's own ``fit``, checkpoint resume against an uninterrupted run, the run
id, and ``python -m nfdpf_torch.main`` twice on the CPU.

The configuration is tests/test_train.py's ``_tiny_cfg`` with the NF
dynamics on the packed chain (``nf_dyn``, ``pallas_coupling``; the JAX
Pallas kernel in interpret mode) at T=5: B·T = 10 frames, as every parity
test of the port uses (at 8 frames the JAX CPU backend's float32 encoder
gradient is 1e-2 off).  Noise replays JAX's key schedule: ``fit`` splits one
key per train and per eval step (train.py:332,341), and each step splits
its key as ``Trainer._loss`` and the filter do."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nfdpf_tpu.ops.pallas.coupling_pallas as cp
from nfdpf_tpu.config import DPFConfig as JaxConfig
from nfdpf_tpu.config import parse_args as jax_parse_args
from nfdpf_tpu.data.dataset import DiskDataset as JaxDiskDataset
from nfdpf_tpu.data.dataset import iterate_batches as jax_iterate_batches
from nfdpf_tpu.data.simulator import generate_dataset as jax_generate_dataset
from nfdpf_tpu.main import get_run_id as jax_get_run_id
from nfdpf_tpu.train import Trainer as JaxTrainer
from nfdpf_tpu.train import TrainState, _split_variables
from nfdpf_torch.bridge import load_jax_variables, torch_state_from_jax
from nfdpf_torch.config import DPFConfig, parse_args
from nfdpf_torch.data.dataset import DiskDataset, iterate_batches
from nfdpf_torch.main import get_run_id, main
from nfdpf_torch.train import Trainer
from nfdpf_torch.utils.checkpoint import restore_checkpoint

B, N, T = 2, 12, 5
CFG = dict(num_particles=N, sequence_length=T, batch_size=B, width=128,
           resampler_type="soft", measurement="cos", num_epochs=2,
           nf_dyn=True, pallas_coupling=True)
NAME = "toy_pn=2.0_d=3_const"
LR = DPFConfig().lr


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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _variables(params, rest):
    return _np_tree({k: {"params": params[k], **rest[k]} for k in params})


@pytest.fixture(scope="module")
def jax_trainer():
    """The JAX trainer and its initial variables (``init_state(PRNGKey(0))``'s,
    the initialisers compiled once rather than run op by op)."""
    trainer = JaxTrainer(JaxConfig(**CFG))
    params, rest = _split_variables(jax.jit(trainer.engine.init)(jax.random.PRNGKey(0)))
    return trainer, _variables(params, rest)


def _jax_state(trainer, init_vars):
    """A fresh JAX ``TrainState`` (epoch 0, fresh Adam) from ``init_vars``."""
    params, rest = _split_variables(jax.tree_util.tree_map(jnp.asarray, init_vars))
    return TrainState(params=params, rest=rest, opt_state=trainer.tx.init(params), epoch=0)


def _loss_noise(key, b):
    """The port's noise dict of one step run with ``key``: ``_loss`` splits
    it (k_vel, k_filter, k_mask), the filter splits k_filter (k_init, k_scan)
    and k_scan per time step (k, k_rs, k_motion); the soft resampler's
    offsets come from k_rs."""
    k_vel, k_filter, _ = jax.random.split(key, 3)
    k_init, k = jax.random.split(k_filter)
    init = jax.random.uniform(k_init, (b, N, 2), minval=-64.0, maxval=64.0)
    motion, offsets = [], []
    for _ in range(T):
        k, k_rs, k_motion = jax.random.split(k, 3)
        motion.append(np.asarray(jax.random.normal(k_motion, (b, N, 2))))
        offsets.append(np.asarray(jax.random.uniform(k_rs, (b, 1), minval=0.0, maxval=1.0 / N)))
    return {"vel": torch.tensor(np.asarray(jax.random.normal(k_vel, (b, T, 2)))),
            "init": torch.tensor(np.asarray(init)),
            "motion": torch.from_numpy(np.stack(motion)),
            "resample": torch.from_numpy(np.stack(offsets))}


def _fit_noise(seed, batch_sizes):
    """JAX ``fit``'s schedule: one ``key, sub = split(key)`` per step, train
    and eval alike, from ``PRNGKey(seed)``; ``batch_sizes`` lists each
    step's batch size in the loop's order."""
    key, out = jax.random.PRNGKey(seed), []
    for b in batch_sizes:
        key, sub = jax.random.split(key)
        out.append(_loss_noise(sub, b))
    return out


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """8 train, 1 val, 1 test sequences (3 distractors, T=5) from the JAX
    simulator."""
    path = str(tmp_path_factory.mktemp("disks"))
    jax_generate_dataset(path, num_examples=8, file_size=10, num_distractors=3,
                         pos_noise=2.0, sequence_length=T, seed=0)
    return path


def _schedule(train_n, val_n, epochs):
    return ([B] * (train_n // B) + [1] * val_n) * epochs


def _port_fit(data_dir, run_dir, init_vars, epochs=2, trainer=None, noise=None):
    ds, val = DiskDataset(data_dir, NAME, "train_data"), DiskDataset(data_dir, NAME, "val_data")
    if trainer is None:
        trainer = Trainer(DPFConfig(**CFG), device="cpu")
        load_jax_variables(trainer.engine, init_vars)
    if noise is None:
        noise = _fit_noise(0, _schedule(len(ds), len(val), epochs))
    trainer.fit(lambda e: iterate_batches(ds, B, seed=e),
                lambda: iterate_batches(val, 1, shuffle=False), run_dir,
                num_epochs=epochs, seed=0, noise=noise)
    return trainer


@pytest.fixture(scope="module")
def fits(jax_trainer, data_dir, tmp_path_factory):
    """JAX ``fit`` and the port's, 2 epochs each from the same parameters,
    data order and noise."""
    root = tmp_path_factory.mktemp("fit")
    jt, init_vars = jax_trainer
    state = _jax_state(jt, init_vars)
    jds = JaxDiskDataset(data_dir, NAME, "train_data")
    jval = JaxDiskDataset(data_dir, NAME, "val_data")
    jstate = jt.fit(lambda e: jax_iterate_batches(jds, B, seed=e),
                    lambda: jax_iterate_batches(jval, 1, shuffle=False),
                    str(root / "jax"), num_epochs=2, state=state, seed=0)
    best = jt.load(str(root / "jax" / "models" / "best"), jstate)
    trainer = _port_fit(data_dir, str(root / "port"), init_vars)
    return dict(root=root, init_vars=init_vars, jax_epoch=int(jstate.epoch), trainer=trainer,
                jax_best=best, train_steps=2 * (len(jds) // B), jax_trainer=jt, jax_state=jstate)


def test_fit_matches_jax(fits):
    """``fit`` over 2 epochs against JAX's ``fit``:

    * ``eval_loss_epoch.npy``: rtol 1e-5;
    * ``eval_result_best.npz``, each array within 1e-4 of its largest
      magnitude (particles, weights, likelihoods, predictions; the state
      exactly; 1.3e-5 seen);
    * ``models/best``: the same epoch; BN running statistics rtol 1e-4 /
      atol 1e-5 as after one step (tests/test_torch_train.py); each
      parameter's update from the start, Δ = θ_best − θ_0, within
      ‖Δ − Δ_jax‖ ≤ 5e-2·‖Δ_jax‖ (1.96e-2 the most seen, in the decoder),
      and zero where JAX's is zero; outside the decoder all but 1e-4 of the
      entries of each group within 1e-5 of JAX, in the decoder all but 5 %
      (2.1 % seen: Adam moves a weight by about lr whatever its gradient's
      size, so an entry whose gradient is near round-off parts by up to
      2·lr a step).
    """
    root = fits["root"]
    assert fits["trainer"].epoch == fits["jax_epoch"] == 2
    np.testing.assert_allclose(np.load(root / "port" / "data" / "eval_loss_epoch.npy"),
                               np.load(root / "jax" / "data" / "eval_loss_epoch.npy"), rtol=1e-5)
    got = np.load(root / "port" / "data" / "eval_result_best.npz")
    want = np.load(root / "jax" / "data" / "eval_result_best.npz")
    assert set(got.files) == set(want.files)
    np.testing.assert_array_equal(got["state"], want["state"])
    for key in want.files:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-4 * float(np.abs(want[key]).max()), err_msg=key)

    jb = fits["jax_best"]
    ported = restore_checkpoint(str(root / "port" / "models" / "best"))
    assert ported["epoch"] == jb.epoch
    ref = torch_state_from_jax(_variables(jb.params, jb.rest))
    init = torch_state_from_jax(fits["init_vars"])
    params = dict(fits["trainer"].engine.named_parameters())
    far = {}
    for name, want_v in ref.items():
        got_v = ported["model"][name].numpy()
        if name not in params:                     # a BN running statistic
            np.testing.assert_allclose(got_v, want_v, rtol=1e-4, atol=1e-5, err_msg=name)
            continue
        step, want_step = got_v - init[name], want_v - init[name]
        assert np.linalg.norm(step - want_step) <= 5e-2 * np.linalg.norm(want_step), name
        diff = np.abs(got_v - want_v)
        group = name.split(".")[0]
        n_far, n_all = far.get(group, (0, 0))
        far[group] = (n_far + int((diff > 1e-5).sum()), n_all + diff.size)
    for group, (n_far, n_all) in far.items():
        share = 5e-2 if group == "decoder" else 1e-4
        assert n_far <= share * n_all, (group, n_far, n_all)


def test_test_pass_matches_jax(fits, data_dir, tmp_path):
    """``test`` after the two epochs against JAX's ``test`` under its key
    schedule (one split per batch from ``PRNGKey(seed)``), on the test split
    in batches of min(50, n) as ``main`` makes them: the mean loss and
    ``test_loss_epoch.npy`` rtol 1e-5, ``test_result.npz``'s arrays within
    1e-4 of their largest magnitude (the frames and states exactly), the
    same plots."""
    name = "test_data"
    jds, ds = JaxDiskDataset(data_dir, NAME, name), DiskDataset(data_dir, NAME, name)
    bs = min(50, len(ds))
    want = fits["jax_trainer"].test(lambda: jax_iterate_batches(jds, bs, shuffle=False),
                                    fits["jax_state"], str(tmp_path / "jax"), seed=4)
    got = fits["trainer"].test(lambda: iterate_batches(ds, bs, shuffle=False),
                               str(tmp_path / "port"), seed=4,
                               noise=_fit_noise(4, [bs] * (len(ds) // bs)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(np.load(tmp_path / "port" / "data" / "test_loss_epoch.npy"),
                               np.load(tmp_path / "jax" / "data" / "test_loss_epoch.npy"),
                               rtol=1e-5)
    ours = np.load(tmp_path / "port" / "data" / "test_result.npz")
    ref = np.load(tmp_path / "jax" / "data" / "test_result.npz")
    assert set(ours.files) == set(ref.files)
    for key in ref.files:
        if key in ("images", "state"):
            np.testing.assert_array_equal(ours[key], ref[key])
        else:
            np.testing.assert_allclose(ours[key], ref[key], rtol=0,
                                       atol=1e-4 * float(np.abs(ref[key]).max()), err_msg=key)
    for plot in ("test_trajectory.png", "test_ess.png", "tracking/tracking_step_000.png"):
        assert (tmp_path / "port" / "data" / plot).is_file(), plot


def test_fit_fused_matches_fit(fits, data_dir, tmp_path):
    """``fit_fused`` (the datasets staged on the device, batches gathered
    there) equals the port's ``fit`` over the same batch order and noise,
    bit for bit: the order is the permutation ``fit_fused`` draws each epoch
    from ``np.random.default_rng(seed)``, the eval batches min(50, n_val)."""
    ds, val = DiskDataset(data_dir, NAME, "train_data"), DiskDataset(data_dir, NAME, "val_data")
    noise = _fit_noise(3, _schedule(len(ds), len(val), 2))
    fused = Trainer(DPFConfig(**CFG), device="cpu")
    load_jax_variables(fused.engine, fits["init_vars"])
    fused.fit_fused(ds, val, str(tmp_path / "fused"), num_epochs=2, seed=0, noise=noise)

    rng = np.random.default_rng(0)
    orders = [rng.permutation(len(ds)) for _ in range(2)]
    plain = Trainer(DPFConfig(**CFG), device="cpu")
    load_jax_variables(plain.engine, fits["init_vars"])
    plain.fit(lambda e: ({k: v[orders[e][lo:lo + B]] for k, v in ds.data.items()}
                         for lo in range(0, len(ds) - B + 1, B)),
              lambda: iterate_batches(val, min(50, len(val)), shuffle=False),
              str(tmp_path / "plain"), num_epochs=2, seed=0, noise=noise)
    assert fused.epoch == plain.epoch == 2
    for name, value in plain.engine.state_dict().items():
        assert torch.equal(fused.engine.state_dict()[name], value), name
    for run in ("eval_loss_epoch.npy", "eval_result_best.npz"):
        a = np.load(tmp_path / "fused" / "data" / run)
        b = np.load(tmp_path / "plain" / "data" / run)
        for key in (a.files if hasattr(a, "files") else [None]):
            np.testing.assert_array_equal(a[key] if key else a, b[key] if key else b)


def test_resume_equals_an_uninterrupted_run(fits, data_dir, tmp_path):
    """1 epoch (its checkpoint ``models/best``), a new trainer loads it, 1
    more epoch, as ``main --resume`` runs: the
    parameters, BN statistics and Adam state equal the uninterrupted 2-epoch
    run's bit for bit, given the same noise for epoch 2."""
    ds, val = DiskDataset(data_dir, NAME, "train_data"), DiskDataset(data_dir, NAME, "val_data")
    per_epoch = _schedule(len(ds), len(val), 1)
    noise = _fit_noise(5, per_epoch * 2)
    whole = _port_fit(data_dir, str(tmp_path / "whole"), fits["init_vars"], noise=noise)

    _port_fit(data_dir, str(tmp_path / "cut"), fits["init_vars"], epochs=1,
              noise=noise[:len(per_epoch)])
    resumed = Trainer(DPFConfig(**CFG), device="cpu")
    resumed.load(str(tmp_path / "cut" / "models" / "best"))
    assert resumed.epoch == 1
    _port_fit(data_dir, str(tmp_path / "cut"), None, trainer=resumed,
              noise=noise[len(per_epoch):])
    assert resumed.epoch == whole.epoch == 2
    for name, value in whole.engine.state_dict().items():
        assert torch.equal(resumed.engine.state_dict()[name], value), name
    a, b = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, st in a["state"].items():
        for k, v in st.items():
            assert torch.equal(b["state"][i][k], v), (i, k)


def test_ae_step_matches_jax(jax_trainer):
    """One AE-pretraining step against ``make_ae_pretrain_step`` on B·T = 10
    frames: the loss rtol 1e-5; every gradient of the encoder and decoder as
    ‖g − g_ref‖/‖g_ref‖ within 1e-2 of a float64 run of the port and 2e-2 of
    JAX's, every other parameter's gradient zero.  Here the whole gradient
    crosses the decoder's last BatchNorm, whose backward cancels most of it:
    float32 runs of either package sit up to 1e-2 from float64 (port 5.6e-3,
    JAX 1.01e-2 seen).  The parameters after the step equal Adam on the
    port's own gradient (atol 1e-7 plus one float32 ulp: torch's Adam and
    optax's round a weight near 1 apart, as in tests/test_torch_sdpf.py);
    each encoder and decoder parameter's update Δ within ‖Δ − Δ_jax‖ ≤
    0.2·‖Δ_jax‖ of JAX's (Adam's first step is lr·sign(g): 0.096 seen, where
    0.26 % of the entries' signs part), every other parameter's zero as
    JAX's; BN running statistics rtol 1e-4 / atol 1e-5."""
    jt, init_vars = jax_trainer
    state = _jax_state(jt, init_vars)
    images = np.random.default_rng(4).random((B, T, 128, 128, 3), dtype=np.float32)
    frames = jnp.asarray(images.reshape((-1, 128, 128, 3)))

    def ae_loss(params):
        variables = {k: {"params": params[k], **state.rest[k]} for k in params}
        feats, _ = jt.engine.encode(variables, frames, train=True)
        recon, _ = jt.engine.decode(variables, feats, train=True)
        return jnp.mean((recon - frames) ** 2)

    grads = _np_tree(jax.jit(jax.grad(ae_loss))(state.params))
    new_state, loss = jt.make_ae_pretrain_step()(state, frames)

    trainer = Trainer(DPFConfig(**CFG), device="cpu")
    load_jax_variables(trainer.engine, init_vars)
    before = {k: v.detach().clone() for k, v in trainer.engine.named_parameters()}
    got = trainer.ae_step(images)
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)

    wide = Trainer(DPFConfig(**CFG), device="cpu")
    load_jax_variables(wide.engine, init_vars)
    wide.engine.to(torch.float64).train()
    frames64 = torch.from_numpy(images.reshape((-1, 128, 128, 3))).double()
    torch.mean((wide.engine.decode(wide.engine.encode(frames64)) - frames64) ** 2).backward()
    wide_grads = dict(wide.engine.named_parameters())

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    named = dict(trainer.engine.named_parameters())
    ref_grads = torch_state_from_jax({k: {"params": v} for k, v in grads.items()})
    for name, g_ref in ref_grads.items():
        g = named[name].grad.numpy()
        if not name.startswith(("encoder.", "decoder.")):
            assert not g.any() and not g_ref.any(), name
            continue
        assert rel(g, wide_grads[name].grad.numpy()) < 1e-2, name
        assert rel(g, g_ref) < 2e-2, name

    tx = optax.adam(LR)
    params0 = {k: v.numpy() for k, v in before.items()}
    updates, _ = tx.update({k: p.grad.numpy() for k, p in named.items()}, tx.init(params0),
                           params0)
    after = torch_state_from_jax(_variables(new_state.params, new_state.rest))
    for name, want in optax.apply_updates(params0, updates).items():
        got = named[name].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1.2e-7, atol=1e-7, err_msg=name)
        step, want_step = got - params0[name], after[name] - params0[name]
        if name.startswith(("encoder.", "decoder.")):
            assert np.linalg.norm(step - want_step) <= 0.2 * np.linalg.norm(want_step), name
        else:
            assert not step.any() and not want_step.any(), name
    for name, buf in trainer.engine.named_buffers():
        np.testing.assert_allclose(buf.numpy(), after[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_pretrain_ae_loop_with_validation(data_dir, tmp_path):
    """The AE pretraining loop: a best-epoch checkpoint, the parameters of
    that epoch loaded back, a reconstruction grid each epoch."""
    ds = DiskDataset(data_dir, NAME, "train_data")
    trainer = Trainer(DPFConfig(**CFG), device="cpu")
    batches = lambda epoch=0: iterate_batches(ds, B, seed=epoch)  # noqa: E731
    trainer.pretrain_ae(batches, num_epochs=2, valid_batches=lambda: iterate_batches(ds, B),
                        ckpt_path=str(tmp_path / "ae"), run_dir=str(tmp_path / "run"))
    saved = restore_checkpoint(str(tmp_path / "ae"))["model"]
    for name, value in trainer.engine.state_dict().items():
        assert torch.equal(saved[name], value), name
    for epoch in (0, 1):
        assert (tmp_path / "run" / "data" / f"ae_recon_epoch{epoch:03d}.png").is_file()


def test_run_id_matches_jax():
    argv = ["--seed", "7", "--NF-dyn", "--trainType", "SDPF", "--pos-noise", "3.5",
            "--lr", "0.001", "--resampler_type", "soft", "--measurement", "CRNVP"]
    assert get_run_id(parse_args(argv)) == jax_get_run_id(jax_parse_args(argv))
    assert get_run_id(parse_args([])) == jax_get_run_id(jax_parse_args([]))


def test_cli_main_resume_and_pretrain_load(tmp_path, monkeypatch):
    """``main`` twice on the CPU, as tests/test_train.py drives the JAX
    one: a train run (1 epoch on the staged data, ``fit_fused``, then the
    test pass), then ``--resume --load-pretrainModel`` to epoch 2 on host
    batches (``fit``; main's staging budget set to 0), which continues from
    the saved epoch (the AE checkpoint is missing: fresh weights, as in
    JAX).  ``--no-fused-epoch`` is still parsed, with no effect."""
    import nfdpf_torch.main as entry

    from nfdpf_torch.data.simulator import generate_dataset

    monkeypatch.chdir(tmp_path)
    generate_dataset(str(tmp_path / "disks"), num_examples=16, file_size=20,
                     num_distractors=25, pos_noise=2.0, sequence_length=3, seed=0,
                     device="cpu")
    args = ["--num-epochs", "1", "--num-particles", "8", "--batchsize", "2",
            "--sequence-length", "3", "--resampler_type", "soft", "--measurement", "cos",
            "--NF-dyn", "--pallas-coupling", "--data-path", str(tmp_path / "disks")]
    main(args, device="cpu")
    (run_dir,) = list((tmp_path / "logs").iterdir())
    for artifact in ("models/best", "models/final"):
        assert (run_dir / artifact).is_dir(), artifact
    for artifact in ("eval_loss_epoch.npy", "eval_result_best.npz", "test_loss_epoch.npy",
                     "test_result.npz", "test_trajectory.png", "test_ess.png"):
        assert (run_dir / "data" / artifact).is_file(), artifact
    assert restore_checkpoint(str(run_dir / "models" / "final"))["epoch"] == 1

    monkeypatch.setattr(entry, "STAGED_BYTES_LIMIT", 0)
    main(args[2:] + ["--num-epochs", "2", "--resume", "--load-pretrainModel",
                     "--no-fused-epoch"], device="cpu")
    final = restore_checkpoint(str(run_dir / "models" / "final"))
    assert final["epoch"] == 2
    assert np.isfinite(np.load(run_dir / "data" / "eval_loss_epoch.npy")).all()
    with np.load(run_dir / "data" / "test_result.npz") as res:
        assert set(res.files) == {"particle_list", "particle_weight_list", "likelihood_list",
                                  "state", "pred", "images", "noise"}
        assert res["particle_list"].shape == (2, 3, 8, 2)       # the 2 test sequences


@pytest.mark.parametrize("flag", ["--mesh-data", "--mesh-particle"])
def test_cli_mesh_flags_are_refused(tmp_path, monkeypatch, flag):
    """What ``main`` refuses of a mesh, before any data is made: in one
    process (no torchrun) a 2-rank mesh, whose size is not the world's
    (``make_mesh``'s errors, as JAX's: the particle axis is tested first).
    Under a particle axis that holds at the CLI's defaults too (OT over
    materialised costs), which the port runs there."""
    monkeypatch.chdir(tmp_path)
    why = ("mesh 2x1 != 1 ranks" if flag == "--mesh-data"
           else "1 ranks not divisible by particle=2")
    with pytest.raises(ValueError, match=why):
        main([flag, "2", "--data-path", str(tmp_path / "disks")], device="cpu")
    assert not (tmp_path / "disks").exists()
