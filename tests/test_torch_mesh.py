"""nfdpf_torch device meshes (``parallel/mesh.py``, K6 and the sharded filter
and trainer) vs the JAX package's mesh on the conftest's 8 virtual CPU
devices, and vs the port's own world size 1.

The port's ranks are 4 spawned processes joined over gloo on the CPU
(``nfdpf_torch.parallel.ranks``; they import torch and the port only).
One group runs every case, in a thread while this process computes the JAX
references; smaller meshes take a subset of its ranks.  The JAX Pallas
kernels run in interpret mode, the port's kernels through their plain
versions.

Tolerances: K6 as ``tests/test_pallas.py``'s sharded tests (outputs rtol
1e-4 / atol 1e-5, gradient 1e-3 / 1e-5, equal iterations and indices); the
filter as ``test_sharding.py`` (particles 1e-4, weights 1e-3 / 1e-6); the
train step's loss rtol 1e-5 and each gradient group's ‖Δ‖/‖g‖ ≤ 1e-3 (the
decoder 1e-2, whose gradient passes the backward of its last BatchNorm:
see ``tests/test_torch_train.py``) against the port at world size 1;
against JAX's sharded step the encoder's bound is 2e-3, because that step
is itself 1.06e-3 off JAX's unsharded one there, where the port's meshes
were 1.8e-4 to 5.1e-4 off it (measured at these shapes on the CPU);
the same step in float64 on each mesh against the port's float64 step at
world size 1 within 1e-9, and so soft resampling, OT over materialised
costs (with and without the transport's gradient) and SDPF on 1×2 (one of
them on 2×2 too); every single-card setting on a 2×1 and a 1×2 mesh
against world size 1 at the train step's bounds (bfloat16 at
``tests/test_torch_options.py``'s); a dense or soft firing on 1×2 against
world size 1 at K6's bounds (the soft one bit for bit); BatchNorm 1e-5.

Every reference is a module fixture that the first test takes before it
waits for the ranks, so that references and ranks run side by side.
"""

import hashlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import nfdpf_tpu.ops.pallas.sinkhorn_pallas as sp
from nfdpf_tpu.config import DPFConfig as JaxConfig
from nfdpf_tpu.models.dpf import DPF as JaxDPF
from nfdpf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nfdpf_tpu.parallel.mesh import replicate as jax_replicate
from nfdpf_tpu.parallel.mesh import shard_batch as jax_shard_batch
from nfdpf_tpu.train import Trainer as JaxTrainer
from nfdpf_tpu.train import _split_variables
from nfdpf_torch.bridge import load_jax_variables, torch_state_from_jax
from nfdpf_torch.config import DPFConfig
from nfdpf_torch.data.simulator import generate_dataset
from nfdpf_torch.models.dpf import DPF, check_supported
from nfdpf_torch.models.nets import FlaxBatchNorm
from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc
from nfdpf_torch.parallel import ranks as R
from nfdpf_torch.parallel.mesh import make_mesh
from nfdpf_torch.train import Trainer

WORLD = 4

# K6: tests/test_pallas.py:126-162 (cold) and :246-296 (warm), B=2, N=64, P=4
K6_COLD = dict(eps=0.1, scaling=0.9, threshold=1e-4, max_iter=200, convergence="any")
K6_WARM = dict(eps=0.1, scaling=0.75, threshold=1e-3, max_iter=100)
K6_CASES = ("cold", "warm_start")
# K6's all-gathers outside its loop: the coordinates and log-weights, the
# start's potentials, the final f, the column term and the raw particles
K6_GATHERS = 6

# the filter: test_sharding.py's particle-sharded streaming case (B=8, N=16,
# T=4, resampling every step); the port's 4 ranks at (4/P)×P.  Its soft
# case (test_sharding.py:47-75) at the particle axes over 1
FILTER_CFG = dict(num_particles=16, sequence_length=4, batch_size=8, resampler_type="ot",
                  measurement="cos", use_pallas=True, max_iter=8, ess_threshold=2.0)
FILTER_AXES = (1, 2, 4)
SOFT_FILTER_CFG = dict(FILTER_CFG, resampler_type="soft")
SOFT_FILTER_AXES = (2, 4)

# the train step: test_sharded_train_step_ot_flows's configuration on the
# streaming kernels (K6 under the particle axis; dense OT there is among
# OPTIONS), B·T = 10 frames, resampling every step
STEP_CFG = dict(num_particles=16, sequence_length=5, batch_size=2, resampler_type="ot",
                use_pallas=True, max_iter=5, nf_dyn=True, nf_cond=True, measurement="CRNVP",
                ess_threshold=1.01)
STEP_MESHES = {"2x1": ((2, 1), [0, 1]), "1x2": ((1, 2), [2, 3]), "2x2": ((2, 2), None)}
GROUPS = ("encoder", "decoder", "measurement", "nf_dyn", "cond_model")

BN_SHAPE = (8, 6, 3, 3)      # (B, C, H, W), the batch over a 4×1 mesh

# every single-card setting on a 2×1 and on a 1×2 mesh, each against the
# port at world size 1 (seed init, the cosine measurement; B=2, T=5, N=16,
# resampling every step)
OPTION_BASE = dict(num_particles=16, sequence_length=5, batch_size=2, resampler_type="ot",
                   use_pallas=True, max_iter=5, measurement="cos", ess_threshold=1.01)
OPTIONS = {
    "dense_ot": dict(use_pallas=False),
    "transport_grad": dict(use_pallas=False, ot_transport_grad=True),
    "soft": dict(resampler_type="soft"),
    "sdpf": dict(train_type="SDPF", labeled_ratio=0.5, block_length=2),
    "remat": dict(remat_scan_step=True),
    "encode_per_step": dict(encode_per_step=True),
    "bfloat16": dict(compute_dtype="bfloat16"),
    "warm_start": dict(sinkhorn_warm_start=True),
}
OPTION_GROUPS = ("encoder", "decoder", "measurement")
# the settings whose firings or loss read across the particle axis, in
# float64 on 1×2 against world size 1 (SDPF on the soft resampler, so that
# its ancestor walk crosses ranks); the one also on 2×2
FLOAT64_OPTIONS = {
    "soft": OPTIONS["soft"],
    "dense_ot": OPTIONS["dense_ot"],
    "transport_grad": OPTIONS["transport_grad"],
    "sdpf_soft": dict(OPTIONS["sdpf"], resampler_type="soft"),
}
FLOAT64_2X2 = "sdpf_soft"

# one firing of the dense OT (with and without the transport's gradient) and
# of the soft resampler on a 1×2 mesh (B=2, N=64: K6's cold cloud)
DENSE_KW = dict(eps=0.1, scaling=0.75, threshold=1e-3, max_iter=100)
FIRINGS = {"dense_ot": ("dense", DENSE_KW), "transport_grad": ("dense", dict(
    DENSE_KW, transport_grad=True)), "soft": ("soft", dict(alpha=0.5))}
# the dense firing's all-gathers outside its loop: the particles, the
# log-weights, the start's softmins, the final round and the column normaliser
DENSE_GATHERS = 5


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(sp, "_INTERPRET", True)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cloud(key, b=2, n=64):
    k1, k2 = jax.random.split(key)
    x = jax.random.normal(k1, (b, n, 2)) * 3.0
    return np.asarray(x), np.asarray(jax.nn.softmax(jax.random.normal(k2, (b, n))))


def _batch(seed, b, t):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, t, 128, 128, 3), dtype=np.float32),
            "state": (rng.standard_normal((b, t, 4)) * 10).astype(np.float32),
            "start_state": (rng.standard_normal((b, 4)) * 10).astype(np.float32)}


def _filter_noise(key, b, n, t, width=128.0):
    """The JAX filter's draws (dpf.py:325,384; the soft resampler's offsets,
    resampling.py:46) as the port's global noise."""
    k_init, k = jax.random.split(key)
    init = jax.random.uniform(k_init, (b, n, 2), minval=-width / 2, maxval=width / 2)
    motion, offsets = [], []
    for _ in range(t):
        k, k_rs, k_motion = jax.random.split(k, 3)
        motion.append(np.asarray(jax.random.normal(k_motion, (b, n, 2))))
        offsets.append(np.asarray(jax.random.uniform(k_rs, (b, 1), minval=0.0, maxval=1.0 / n)))
    return {"init": np.asarray(init), "motion": np.stack(motion),
            "resample": np.stack(offsets)}


def _option_noise(seed, b, n, t):
    """Global draws for every setting: the soft resampler's offsets and the
    semi-supervised mask too."""
    rng = np.random.default_rng(seed)
    return {"vel": rng.standard_normal((b, t, 2)).astype(np.float32),
            "init": (rng.random((b, n, 2)) * 128 - 64).astype(np.float32),
            "motion": rng.standard_normal((t, b, n, 2)).astype(np.float32),
            "resample": (rng.random((t, b, 1)) / n).astype(np.float32),
            "mask": (rng.random((b, t)) < 0.5).astype(np.float32)}


def _step_noise(key, b, n, t):
    """The JAX train step's draws (train.py:90-91, then the filter's)."""
    k_vel, k_filter, _ = jax.random.split(key, 3)
    return {"vel": np.asarray(jax.random.normal(k_vel, (b, t, 2))),
            **_filter_noise(k_filter, b, n, t)}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _groups(grads: dict) -> dict:
    """Each group's gradient tensors flattened together, by port name."""
    return {g: np.concatenate([np.ravel(grads[k]) for k in sorted(grads)
                               if k.startswith(g + ".")]) for g in GROUPS}


# ---------------------------------------------------------------------------
# inputs, shared by the ranks and the references (made once)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    x, probs = _cloud(jax.random.PRNGKey(12))
    xw, probs_w = _cloud(jax.random.PRNGKey(20))
    xw2 = np.asarray(xw + 0.05 * jax.random.normal(jax.random.PRNGKey(21), xw.shape))
    # the warm firing starts from the port's own unsharded cold potentials
    _, _, _, _, pots = sc.ot_resample_streaming(torch.tensor(xw), torch.tensor(probs_w),
                                                return_potentials=True, **K6_WARM)

    # both engines' initial variables in one compiled call (op by op they
    # take several times as long), as DPF.init and Trainer.init_state draw them
    f_vars, s_vars = _np_tree(jax.jit(lambda kf, ks: (
        JaxDPF(JaxConfig(**FILTER_CFG)).init(kf), JaxDPF(JaxConfig(**STEP_CFG)).init(ks)))(
        jax.random.PRNGKey(1), jax.random.PRNGKey(0)))
    s_params, s_rest = _split_variables(s_vars)
    b_f, b_s = FILTER_CFG["batch_size"], STEP_CFG["batch_size"]
    n_f, n_s = FILTER_CFG["num_particles"], STEP_CFG["num_particles"]
    t_f, t_s = FILTER_CFG["sequence_length"], STEP_CFG["sequence_length"]
    offset = np.asarray(jax.random.uniform(jax.random.PRNGKey(13), (2, 1), maxval=1.0 / 64))
    return dict(
        x=x, probs=probs, offset=offset, xw=xw, probs_w=probs_w, xw2=xw2,
        pots_cold=pots.numpy(),
        filter_vars=f_vars, filter_batch=_batch(0, b_f, t_f),
        filter_noise=_filter_noise(jax.random.PRNGKey(7), b_f, n_f, t_f),
        step_params=s_params, step_rest=s_rest, step_vars=s_vars,
        step_batch=_batch(1, b_s, t_s), step_key=jax.random.PRNGKey(5),
        step_noise=_step_noise(jax.random.PRNGKey(5), b_s, n_s, t_s),
        option_batch=_batch(8, OPTION_BASE["batch_size"], OPTION_BASE["sequence_length"]),
        option_noise=_option_noise(9, OPTION_BASE["batch_size"], OPTION_BASE["num_particles"],
                                   OPTION_BASE["sequence_length"]),
        bn_x=np.random.default_rng(3).standard_normal(BN_SHAPE).astype(np.float32) * 2 + 1,
        bn_g=np.random.default_rng(4).standard_normal(BN_SHAPE).astype(np.float32))


# the entry point on a 2×2 mesh: tiny flags, a gaussian measurement (its
# row maximum over the particle group) and both flows (their contexts)
CLI_ARGS = ["--use-pallas", "--NF-dyn", "--NF-cond", "--measurement", "gaussian",
            "--num-epochs", "1", "--num-particles", "8", "--batchsize", "8",
            "--sequence-length", "3"]
CLI_MESH = ["--mesh-data", "2", "--mesh-particle", "2"]


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    """The entry point's run directories; the ranks' thread makes the data."""
    root = tmp_path_factory.mktemp("cli")
    for run in ("mesh", "single"):
        (root / run).mkdir()
    return root


@pytest.fixture(scope="module")
def ranks(inputs, cli_dirs):
    """Every case on one group of 4 gloo ranks, started in a thread (which
    first makes the entry point's data): the references are computed
    meanwhile.  Returns a function that waits and gives the results by
    case name."""
    i = inputs
    data = ["--data-path", str(cli_dirs / "disks")]
    # in the order the tests read them; the one-process CLI run last, on
    # rank 0 alone, while the others have finished
    jobs = {
        **{f"step_{name}": (R.train_step_job, dict(
            settings=STEP_CFG, shape=shape, ranks=rk, batch=i["step_batch"],
            noise=i["step_noise"], variables=i["step_vars"]))
           for name, (shape, rk) in STEP_MESHES.items()},
        **{f"step64_{name}": (R.float64_step_job, dict(
            cases={"step": STEP_CFG}, shape=shape, ranks=rk, batch=i["step_batch"],
            noise=i["step_noise"], variables=i["step_vars"]))
           for name, (shape, rk) in STEP_MESHES.items()},
        **{f"options_{name}": (R.settings_steps_job, dict(
            cases={c: dict(OPTION_BASE, **OPTIONS[c]) for c in OPTIONS}, shape=shape, ranks=rk,
            batch=i["option_batch"], noise=i["option_noise"]))
           for name, shape, rk in (("2x1", (2, 1), [0, 1]), ("1x2", (1, 2), [2, 3]))},
        **{f"options64_{name}": (R.float64_step_job, dict(
            cases={c: dict(OPTION_BASE, **FLOAT64_OPTIONS[c]) for c in cases}, shape=shape,
            ranks=rk, batch=i["option_batch"], noise=i["option_noise"]))
           for name, shape, rk, cases in (("1x2", (1, 2), [0, 1], FLOAT64_OPTIONS),
                                          ("2x2", (2, 2), None, [FLOAT64_2X2]))},
        "cli": (R.main_job, dict(argv=CLI_ARGS + CLI_MESH + data,
                                 workdir=str(cli_dirs / "mesh"))),
        **{f"filter_p{p}": (R.filter_job, dict(
            settings=FILTER_CFG, shape=(WORLD // p, p), batch=i["filter_batch"],
            noise=i["filter_noise"], variables=i["filter_vars"])) for p in FILTER_AXES},
        **{f"soft_filter_p{p}": (R.filter_job, dict(
            settings=SOFT_FILTER_CFG, shape=(WORLD // p, p), batch=i["filter_batch"],
            noise=i["filter_noise"], variables=i["filter_vars"])) for p in SOFT_FILTER_AXES},
        **{f"firing_{name}": (R.firing_job, dict(
            shape=(1, 2), ranks=[2, 3], particles=i["x"], probs=i["probs"], resampler=resampler,
            kw=kw, offset=i["offset"])) for name, (resampler, kw) in FIRINGS.items()},
        "k6": (R.resample_job, dict(shape=(1, 4), particles=i["x"], probs=i["probs"],
                                    kw=K6_COLD)),
        "k6_cold": (R.resample_job, dict(shape=(1, 4), particles=i["xw"], probs=i["probs_w"],
                                         kw=K6_WARM, warm=(np.zeros((2, 2, 64)), False))),
        "k6_warm": (R.resample_job, dict(shape=(1, 4), particles=i["xw2"], probs=i["probs_w"],
                                         kw=K6_WARM, warm=(i["pots_cold"], True))),
        **{f"{name}_plain": (R.resample_job, dict(
            shape=(1, 4), particles=x, probs=probs, kw=kw, plain=True,
            warm=None if pots is None else (pots, valid)))
           for case in K6_CASES for name, x, probs, kw, pots, valid in _k6_runs(i, case)},
        "k6_2x2": (R.resample_job, dict(shape=(2, 2), particles=i["x"], probs=i["probs"],
                                        kw=K6_COLD)),
        "bn": (R.batchnorm_job, dict(shape=(4, 1), x=i["bn_x"], g=i["bn_g"])),
        "replicate": (R.replicate_job, dict(settings=STEP_CFG, variables=i["step_vars"])),
        "shapes": (R.mesh_shapes_job, dict(cases=[dict(particle=2),
                                                  dict(data=4, particle=1),
                                                  dict(particle=3), dict(data=2)])),
        "cli_single": (R.main_job, dict(argv=CLI_ARGS + data, workdir=str(cli_dirs / "single"),
                                        rank=0)),
    }
    box = {}

    def run():
        try:
            generate_dataset(str(cli_dirs / "disks"), num_examples=16, file_size=20,
                             num_distractors=25, pos_noise=2.0, sequence_length=3, seed=0,
                             device="cpu")
            out = R.spawn(WORLD, list(jobs.values()), timeout=600)
            box["results"] = dict(zip(jobs, out))
        except BaseException as err:      # raised in the tests that wait
            box["error"] = err

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait():
        thread.join(timeout=660)
        if "error" in box:
            raise box["error"]
        return box["results"]
    yield wait
    thread.join(timeout=660)


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------


_JAX_K6 = {}


def _jax_k6_fn(kw):
    """``ot_resample_pallas_sharded`` under shard_map over 4 devices, jitted
    once per setting."""
    key = tuple(sorted(kw.items()))
    if key in _JAX_K6:
        return _JAX_K6[key]
    mesh = JaxMesh(np.array(jax.devices()[:4]), ("particle",))
    pot_spec = P(None, None, "particle")
    fn = jax.shard_map(
        lambda p, w, po, v: sp.ot_resample_pallas_sharded(
            p, w, particle_axis="particle", warm_start=(po, v), return_extras=True, **kw),
        mesh=mesh,
        in_specs=(P(None, "particle", None), P(None, "particle"), pot_spec, P()),
        out_specs=(P(None, "particle", None), P(None, "particle"), P(None, "particle"),
                   {"potentials": pot_spec, "iters": P()}),
        check_vma=False)
    _JAX_K6[key] = jax.jit(fn)
    return _JAX_K6[key]


def _jax_k6(x, probs, kw, warm=None, grad=False):
    """JAX's K6 on 4 devices: its outputs and, with ``grad``, the gradient
    of Σ transported² to the particles."""
    fn = _jax_k6_fn(kw)
    pots, valid = warm if warm is not None else (np.zeros((2, 2, 64), np.float32), False)
    args = (jnp.asarray(probs), jnp.asarray(pots), jnp.asarray(valid))
    out, _, idx, ex = fn(jnp.asarray(x), *args)
    res = dict(particles=np.asarray(out), idx=np.asarray(idx),
               potentials=np.asarray(ex["potentials"]), iters=int(ex["iters"]))
    if grad:
        res["grad"] = np.asarray(jax.grad(lambda p: jnp.sum(fn(p, *args)[0] ** 2))(
            jnp.asarray(x)))
    return res


@pytest.fixture(scope="module")
def jax_step(inputs):
    """JAX's loss and gradients on a 2×2 mesh of the virtual devices."""
    i = inputs
    mesh = jax_make_mesh(data=2, particle=2, devices=jax.devices()[:4])
    trainer = JaxTrainer(JaxConfig(**STEP_CFG), mesh=mesh)
    params = jax_replicate(i["step_params"], mesh)
    rest = jax_replicate(i["step_rest"], mesh)
    batch = jax_shard_batch({k: jnp.asarray(v) for k, v in i["step_batch"].items()}, mesh)
    (loss, aux), grads = jax.jit(lambda p: jax.value_and_grad(trainer._loss, has_aux=True)(
        p, rest, batch, i["step_key"], True))(params)
    names = torch_state_from_jax({k: {"params": v} for k, v in _np_tree(grads).items()})
    return dict(loss=float(loss), sinkhorn_iters=float(aux["sinkhorn_iters"]), grads=names)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single_step(inputs):
    """The port's train step at world size 1 from the same weights and draws."""
    i = inputs
    trainer = Trainer(DPFConfig(**STEP_CFG), device="cpu")
    load_jax_variables(trainer.engine, i["step_vars"])
    metrics = trainer.train_step(i["step_batch"], noise={k: torch.tensor(v)
                                                         for k, v in i["step_noise"].items()})
    grads = {k: p.grad.numpy() for k, p in trainer.engine.named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in metrics.items()}, grads


@pytest.fixture(scope="module")
def step_float64(inputs):
    """The port's train step at world size 1 in float64, from the same
    weights, inputs and draws."""
    i = inputs
    return R.float64_step(STEP_CFG, i["step_batch"], i["step_noise"], i["step_vars"])


@pytest.fixture(scope="module")
def option_refs(inputs):
    """The port's train step at world size 1 for every setting of
    ``OPTIONS``."""
    i = inputs
    return {case: R.step_result(Trainer(DPFConfig(**dict(OPTION_BASE, **OPTIONS[case])), "cpu"),
                                i["option_batch"], i["option_noise"], "cpu")
            for case in OPTIONS}


@pytest.fixture(scope="module")
def option_float64(inputs):
    """The port's train step at world size 1 in float64 for every setting of
    ``FLOAT64_OPTIONS``."""
    i = inputs
    return {case: R.float64_step(dict(OPTION_BASE, **FLOAT64_OPTIONS[case]), i["option_batch"],
                                 i["option_noise"])
            for case in FLOAT64_OPTIONS}


@pytest.fixture(scope="module")
def firing_refs(inputs):
    """Each firing of ``FIRINGS`` at world size 1."""
    i = inputs
    return {name: R.firing(torch.tensor(i["x"]), torch.tensor(i["probs"]), resampler, kw,
                           torch.tensor(i["offset"]))
            for name, (resampler, kw) in FIRINGS.items()}


@pytest.mark.parametrize("mesh_name", sorted(STEP_MESHES))
def test_sharded_train_step_matches_jax_mesh_and_world_size_1(ranks, jax_step, single_step,
                                                              filter_refs, soft_filter_refs,
                                                              k6_refs, option_refs,
                                                              option_float64, firing_refs,
                                                              step_float64, mesh_name):
    """One train step (OT on the streaming kernels, K6 under the particle
    axis, both RealNVP flows, the CRNVP measurement) on a 2×1, 1×2 or 2×2
    mesh: every rank's loss, Sinkhorn iterations and gradient groups
    against JAX's step on a 2×2 mesh and the port at world size 1.  (It
    also takes the other tests' references, so that all are made while
    the ranks run.)"""
    metrics1, grads1 = single_step
    runs = [r for r in ranks()[f"step_{mesh_name}"] if r is not None]
    shape = STEP_MESHES[mesh_name][0]
    assert len(runs) == shape[0] * shape[1]
    refs = {"jax mesh": _groups(jax_step["grads"]), "world size 1": _groups(grads1)}
    for run in runs:
        m = run["metrics"]
        assert m["resample_count"] == STEP_CFG["sequence_length"]
        for ref in (jax_step, metrics1):
            assert m["sinkhorn_iters"] == ref["sinkhorn_iters"]
            np.testing.assert_allclose(m["loss"], ref["loss"], rtol=1e-5)
        assert set(run["grads"]) == set(grads1)
        got = _groups(run["grads"])
        for ref_name, ref in refs.items():
            for g in GROUPS:
                bound = (1e-2 if g == "decoder"
                         else 2e-3 if g == "encoder" and ref_name == "jax mesh" else 1e-3)
                assert _rel(got[g], ref[g]) < bound, (g, ref_name, _rel(got[g], ref[g]))


@pytest.mark.parametrize("mesh_name", sorted(STEP_MESHES))
def test_sharded_step_in_float64_equals_world_size_1(ranks, step_float64, mesh_name):
    """The train step of ``test_sharded_train_step_matches_jax_mesh_and_world_size_1``
    in float64 on each mesh against the port's float64 step at world size
    1: loss and every gradient group within 1e-9 (relative).  In float32
    the data axis moves the encoder's gradient by up to ~1e-3 (this
    gradient's own float32 rounding: the float32 step at world size 1 sits
    4.6e-4 from the float64 one, the 2×1 mesh's 1.1e-3, measured at these
    shapes); in float64 any fault of the mesh would stand out of the
    rounding by six orders."""
    exact = step_float64
    got = next(r for r in ranks()[f"step64_{mesh_name}"] if r is not None)["step"]
    np.testing.assert_allclose(got["loss"], exact["loss"], rtol=1e-9)
    assert set(got["grads"]) == set(exact["grads"])
    mine, want = _groups(got["grads"]), _groups(exact["grads"])
    for g in GROUPS:
        assert _rel(mine[g], want[g]) < 1e-9, (g, _rel(mine[g], want[g]))


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_single_card_settings_run_on_a_mesh(ranks, option_refs, case):
    """Every setting the port runs on one card runs on a 2×1 and on a 1×2
    mesh: the loss, the firings, the streaming and dense Sinkhorn
    iterations and each gradient group against world size 1.  Bounds as
    the train step's (loss rtol 1e-5, gradients 1e-3, decoder 1e-2); under
    bfloat16 those of ``tests/test_torch_options.py``'s bfloat16 step (loss
    1e-3, gradients 1e-1, decoder 2e-1): the split BatchNorm sums move
    bfloat16 roundings."""
    ref = option_refs[case]
    results = ranks()
    loss_tol, grad_tol, decoder_tol = (1e-3, 1e-1, 2e-1) if case == "bfloat16" else (
        1e-5, 1e-3, 1e-2)
    want = {g: np.concatenate([np.ravel(ref["grads"][k]) for k in sorted(ref["grads"])
                               if k.startswith(g + ".")]) for g in OPTION_GROUPS}
    for mesh_name in ("2x1", "1x2"):
        got = next(r for r in results[f"options_{mesh_name}"] if r is not None)[case]
        for key in ("resample_count", "sinkhorn_iters"):
            assert got["metrics"][key] == ref["metrics"][key], (mesh_name, key)
        assert got["dense_iters"] == ref["dense_iters"], mesh_name
        np.testing.assert_allclose(got["metrics"]["loss"], ref["metrics"]["loss"], rtol=loss_tol,
                                   err_msg=mesh_name)
        assert set(got["grads"]) == set(ref["grads"]), mesh_name
        for g in OPTION_GROUPS:
            mine = np.concatenate([np.ravel(got["grads"][k]) for k in sorted(got["grads"])
                                   if k.startswith(g + ".")])
            bound = decoder_tol if g == "decoder" else grad_tol
            assert _rel(mine, want[g]) < bound, (mesh_name, g, _rel(mine, want[g]))


@pytest.mark.parametrize("case", sorted(FLOAT64_OPTIONS))
def test_particle_axis_settings_in_float64_equal_world_size_1(ranks, option_float64, case):
    """Soft resampling, OT over materialised costs (with and without the
    transport's gradient) and SDPF on the soft resampler, whose ancestor
    walk crosses ranks, in float64 on a 1×2 mesh (and ``FLOAT64_2X2`` on a
    2×2 mesh) against the port's float64 step at world size 1: loss and
    every gradient group within 1e-9 (relative), as the train step's
    float64 meshes are held."""
    exact = option_float64[case]
    results = ranks()
    for mesh_name in ["1x2"] + (["2x2"] if case == FLOAT64_2X2 else []):
        got = next(r for r in results[f"options64_{mesh_name}"] if r is not None)[case]
        np.testing.assert_allclose(got["loss"], exact["loss"], rtol=1e-9, err_msg=mesh_name)
        assert set(got["grads"]) == set(exact["grads"]), mesh_name
        for g in OPTION_GROUPS:
            mine, want = (np.concatenate([np.ravel(grads[k]) for k in sorted(grads)
                                          if k.startswith(g + ".")])
                          for grads in (got["grads"], exact["grads"]))
            assert _rel(mine, want) < 1e-9, (mesh_name, g, _rel(mine, want))


@pytest.fixture(scope="module")
def filter_refs(inputs):
    """JAX's mesh filter for each particle axis (over 8 devices) and the
    port's at world size 1."""
    i = inputs
    batch = i["filter_batch"]
    refs = {}
    for particle_axis in FILTER_AXES:
        mesh = jax_make_mesh(particle=particle_axis)
        engine = JaxDPF(JaxConfig(**FILTER_CFG), mesh=mesh)
        v_repl = jax_replicate(i["filter_vars"], mesh)
        b_shard = jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
        refs[particle_axis], _, _ = jax.jit(lambda v, b: engine.filter(  # noqa: B023
            v, b["image"], b["start_state"], b["state"][..., 2:], jax.random.PRNGKey(7), False)
        )(v_repl, b_shard)
    single = DPF(DPFConfig(**FILTER_CFG), device="cpu")
    load_jax_variables(single, i["filter_vars"])
    single.eval()
    with torch.no_grad():
        own, _ = single.filter(torch.tensor(batch["image"]), torch.tensor(batch["start_state"]),
                               torch.tensor(batch["state"][..., 2:]),
                               {k: torch.tensor(v) for k, v in i["filter_noise"].items()})
    return refs, own


@pytest.mark.parametrize("particle_axis", FILTER_AXES)
def test_sharded_filter_matches_jax_mesh_and_world_size_1(ranks, filter_refs, particle_axis):
    """As ``test_sharding.py::test_sharded_filter_matches_single_device``:
    the eval filter with the particle axis over 1, 2 or 4 ranks (the data
    axis over the rest) against JAX's mesh filter (particle axis
    ``particle_axis`` over 8 devices) and the port's world size 1."""
    refs, own = filter_refs
    ref = refs[particle_axis]
    got = ranks()[f"filter_p{particle_axis}"][0]
    assert np.array_equal(got["sinkhorn_iters"], own.sinkhorn_iters.numpy())
    assert np.array_equal(got["sinkhorn_iters"], np.asarray(ref.sinkhorn_iters))
    for want in (np.asarray(ref.particles), own.particles.numpy()):
        np.testing.assert_allclose(got["particles"], want, rtol=1e-4, atol=1e-4)
    for want in (np.asarray(ref.weights), own.weights.numpy()):
        np.testing.assert_allclose(got["weights"], want, rtol=1e-3, atol=1e-6)


@pytest.fixture(scope="module")
def soft_filter_refs(inputs):
    """JAX's mesh filter with the soft resampler for each particle axis of
    ``SOFT_FILTER_AXES`` (over 8 devices; the offsets from the same keys the
    port's noise replays) and the port's at world size 1."""
    i = inputs
    batch = {k: jnp.asarray(v) for k, v in i["filter_batch"].items()}
    refs = {}
    for particle_axis in SOFT_FILTER_AXES:
        mesh = jax_make_mesh(particle=particle_axis)
        engine = JaxDPF(JaxConfig(**SOFT_FILTER_CFG), mesh=mesh)
        refs[particle_axis], _, _ = jax.jit(lambda v, b: engine.filter(  # noqa: B023
            v, b["image"], b["start_state"], b["state"][..., 2:], jax.random.PRNGKey(7), False)
        )(jax_replicate(i["filter_vars"], mesh), jax_shard_batch(batch, mesh))
    single = DPF(DPFConfig(**SOFT_FILTER_CFG), device="cpu")
    load_jax_variables(single, i["filter_vars"])
    single.eval()
    with torch.no_grad():
        own, _ = single.filter(*(torch.tensor(i["filter_batch"][k]) for k in ("image",
                                                                              "start_state")),
                               torch.tensor(i["filter_batch"]["state"][..., 2:]),
                               {k: torch.tensor(v) for k, v in i["filter_noise"].items()})
    return refs, own


@pytest.mark.parametrize("particle_axis", SOFT_FILTER_AXES)
def test_sharded_soft_filter_matches_jax_mesh_and_world_size_1(ranks, soft_filter_refs,
                                                               particle_axis):
    """As ``test_sharding.py::test_sharded_filter_matches_single_device``
    with its soft resampler: the eval filter (every step resampled) with
    the particle axis over 2 or 4 ranks against JAX's mesh filter
    (particles rtol/atol 1e-4, weights 1e-3 / 1e-6) and against the port at
    world size 1, whose ancestor indices it draws (global, every step
    resampling from other ranks' particles)."""
    refs, own = soft_filter_refs
    ref = refs[particle_axis]
    got = ranks()[f"soft_filter_p{particle_axis}"][0]
    assert np.array_equal(got["indices"], own.indices.numpy())
    assert np.array_equal(got["indices"], np.asarray(ref.indices))
    n = SOFT_FILTER_CFG["num_particles"]
    block = n // particle_axis
    assert (got["indices"] // block != np.arange(n) // block).any()
    for want in (np.asarray(ref.particles), own.particles.numpy()):
        np.testing.assert_allclose(got["particles"], want, rtol=1e-4, atol=1e-4)
    for want in (np.asarray(ref.weights), own.weights.numpy()):
        np.testing.assert_allclose(got["weights"], want, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("name", sorted(FIRINGS))
def test_dense_and_soft_firings_on_a_particle_mesh(ranks, firing_refs, name):
    """One firing on a 1×2 mesh against world size 1.  The dense OT: the
    loop's iterations and host syncs equal, particles rtol 1e-4 / atol
    1e-5, gradients to the particles (and with the transport's gradient
    to the weights) rtol 1e-3 / atol 1e-5 (K6's bounds), global indices;
    its collectives ``DENSE_GATHERS`` all-gathers and one an iteration of
    the loop, no all-reduce; no rank makes a tensor of B·N² elements (one
    rank makes the (B, N, N) cost).  The soft resampler: particles,
    weights and indices bit for bit, two all-gathers, no all-reduce."""
    got = next(r for r in ranks()[f"firing_{name}"] if r is not None)
    ref = firing_refs[name]
    b, n = got["weights"].shape
    assert np.array_equal(got["idx"], ref["idx"].numpy())
    assert np.array_equal(got["weights"], ref["weights"].numpy())
    if name == "soft":
        assert np.array_equal(got["particles"], ref["particles"].numpy())
        assert got["collectives"] == {"all_gather": 2, "all_reduce": 0, "broadcast": 0}
    else:
        np.testing.assert_array_equal(got["idx"], np.broadcast_to(np.arange(n), (b, n)))
        np.testing.assert_allclose(got["particles"], ref["particles"].numpy(), rtol=1e-4,
                                   atol=1e-5)
        assert got["loop"] == ref["loop"] and ref["loop"]["calls"] == 1
        loop_iters = got["loop"]["iters"] - 2
        assert got["collectives"] == {"all_gather": DENSE_GATHERS + loop_iters,
                                      "all_reduce": 0, "broadcast": 0}
        assert ref["largest"] == b * n * n
        assert max(got["largest"]) < b * n * n, got["largest"]
    for key in ("x_grad", "w_grad"):
        want = ref[key]
        if want is None:
            assert got[key] is None and name == "dense_ot", key
            continue
        np.testing.assert_allclose(got[key], want.numpy(), rtol=1e-3, atol=1e-5, err_msg=key)


def _k6_runs(inputs, case):
    """(job, particles, probs, settings, warm potentials, valid) of a case."""
    i = inputs
    if case == "cold":
        return [("k6", i["x"], i["probs"], K6_COLD, None, None)]
    return [("k6_cold", i["xw"], i["probs_w"], K6_WARM, None, None),
            ("k6_warm", i["xw2"], i["probs_w"], K6_WARM, i["pots_cold"], True)]


@pytest.fixture(scope="module")
def k6_refs(inputs):
    """Per K6 job: JAX's K6 on 4 devices, and the port's unsharded driver
    with the gradient of Σ transported²."""
    refs = {}
    for case in K6_CASES:
        for name, x, probs, kw, pots, valid in _k6_runs(inputs, case):
            warm = None if pots is None else (pots, valid)
            xt = torch.tensor(x, requires_grad=True)
            out, _, _, iters, own_pots = sc.ot_resample_streaming(
                xt, torch.tensor(probs), return_potentials=True,
                warm_start=None if pots is None else (torch.tensor(pots), True), **kw)
            (grad,) = torch.autograd.grad(torch.sum(out**2), [xt])
            refs[name] = (_jax_k6(x, probs, kw, warm, grad=case == "cold"),
                          dict(particles=out.detach().numpy(), potentials=own_pots.numpy(),
                               grad=grad.numpy(), iters=iters))
    return refs


@pytest.mark.parametrize("case", K6_CASES)
def test_k6_matches_jax_mesh_and_world_size_1(ranks, k6_refs, inputs, case):
    """K6 on 4 particle ranks against ``ot_resample_pallas_sharded`` on 4
    devices and against the unsharded driver: particles, potentials,
    global indices, iterations and the value gradient (JAX's for the cold
    case, as ``test_pallas.py`` checks it)."""
    results = ranks()
    for name, *_ in _k6_runs(inputs, case):
        got = results[name][0]
        assert [r["iters"] for r in results[name]] == [got["iters"]] * WORLD
        jx, own = k6_refs[name]
        out, own_pots, grad, iters = (own["particles"], own["potentials"], own["grad"],
                                      own["iters"])
        assert got["iters"] == jx["iters"] == iters, name
        assert np.array_equal(got["idx"], np.broadcast_to(np.arange(64), (2, 64))), name
        assert np.array_equal(jx["idx"], got["idx"]), name
        for ref in (jx["particles"], out):
            np.testing.assert_allclose(got["particles"], ref, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        for ref in (jx["potentials"], own_pots):
            np.testing.assert_allclose(got["potentials"], ref, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        for ref in ([jx["grad"]] if "grad" in jx else []) + [grad]:
            np.testing.assert_allclose(got["grad"], ref, rtol=1e-3, atol=1e-5, err_msg=name)
        assert got["launches"]["sharded_resample"] == 0      # counted on CUDA launches only


@pytest.mark.parametrize("case", K6_CASES)
def test_k6_equals_its_plain_version_with_one_gather_an_iteration(ranks, k6_refs, inputs, case):
    """K6 (K1 on the local rows, one all-gather of its output, the update
    over all N) against its plain version (the JAX body's order: the
    potentials gathered and max|Δ| all-reduced every iteration) on 4
    particle ranks: potentials and iterations bit for bit, particles and
    the value gradient within the K6 tolerances, the plain version against
    JAX's K6 as well.  Collectives of the forward call: K6 one all-gather an
    iteration it launches (``loop_chunk(64)`` = 8 between two host reads of
    its done flag, frozen ones included) and no all-reduce; the plain
    version one all-gather and one all-reduce an iteration."""
    results = ranks()
    chunk = sc.loop_chunk(64)
    for name, *_ in _k6_runs(inputs, case):
        new, plain = results[name][0], results[f"{name}_plain"][0]
        assert [r["iters"] for r in results[f"{name}_plain"]] == [plain["iters"]] * WORLD
        iters = new["iters"]
        assert plain["iters"] == iters == k6_refs[name][0]["iters"], name
        assert np.array_equal(new["potentials"], plain["potentials"]), name
        assert np.array_equal(new["idx"], plain["idx"]), name
        np.testing.assert_allclose(new["particles"], plain["particles"], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(new["grad"], plain["grad"], rtol=1e-3, atol=1e-5,
                                   err_msg=name)
        jx = k6_refs[name][0]
        np.testing.assert_allclose(plain["particles"], jx["particles"], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        reads = new["loop"]["host_reads"]
        assert new["loop"] == {"calls": 1, "iters": iters, "host_reads": -(-iters // chunk)}
        assert new["collectives"] == {"all_gather": K6_GATHERS + chunk * reads,
                                      "all_reduce": 0, "broadcast": 0}, name
        assert plain["collectives"] == {"all_gather": K6_GATHERS + iters, "all_reduce": iters,
                                        "broadcast": 0}, name


def test_k6_on_a_data_and_particle_mesh(ranks, k6_refs):
    """K6 on a 2×2 mesh (the batch over 2 data ranks, the particles over 2):
    the update never freezes and the stop test is one all-reduce over the
    data group an iteration, beside the iteration's one all-gather.
    Particles, potentials, iterations and the value gradient against JAX's
    K6 on 4 particle devices and the port's unsharded driver (the K6
    tolerances), on every rank the same iterations."""
    results = ranks()
    got = results["k6_2x2"][0]
    jx, own = k6_refs["k6"]
    iters = got["iters"]
    assert [r["iters"] for r in results["k6_2x2"]] == [iters] * WORLD
    assert iters == jx["iters"] == own["iters"] < K6_COLD["max_iter"] - 1
    assert np.array_equal(got["idx"], np.broadcast_to(np.arange(64), (2, 64)))
    for ref in (jx, own):
        for key in ("particles", "potentials"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(got["grad"], ref["grad"], rtol=1e-3, atol=1e-5)
    assert got["loop"] == {"calls": 1, "iters": iters, "host_reads": iters}
    assert got["collectives"] == {"all_gather": K6_GATHERS + iters, "all_reduce": iters,
                                  "broadcast": 0}


def test_batchnorm_statistics_are_global(ranks, inputs):
    """BatchNorm in train mode with the batch over 4 data ranks: output,
    running statistics and gradients equal the whole batch's, against
    flax's BatchNorm on a 4-device data mesh and the port's one module."""
    i = inputs
    x, g = i["bn_x"], i["bn_g"]
    got = ranks()["bn"][0]

    bn = FlaxBatchNorm(BN_SHAPE[1])
    xt = torch.tensor(x, requires_grad=True)
    out = bn(xt)
    torch.sum(out * torch.tensor(g)).backward()
    own = {"out": out.detach().numpy(), "x_grad": xt.grad.numpy(),
           "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy(),
           "weight_grad": bn.weight.grad.numpy(), "bias_grad": bn.bias.grad.numpy()}

    mesh = JaxMesh(np.array(jax.devices()[:4]), ("data",))
    module = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    x_nhwc = jax.device_put(jnp.asarray(x.transpose(0, 2, 3, 1)), NamedSharding(mesh, P("data")))
    g_nhwc = jnp.asarray(g.transpose(0, 2, 3, 1))
    variables = module.init(jax.random.PRNGKey(0), x_nhwc)

    def loss(params, xx):
        y, upd = module.apply({"params": params, **{"batch_stats": variables["batch_stats"]}},
                              xx, mutable=["batch_stats"])
        return jnp.sum(y * g_nhwc), (y, upd)

    (_, (y, upd)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables["params"], x_nhwc)
    ref = {"out": np.asarray(y).transpose(0, 3, 1, 2), "x_grad": np.asarray(gx).transpose(0, 3, 1, 2),
           "running_mean": np.asarray(upd["batch_stats"]["mean"]),
           "running_var": np.asarray(upd["batch_stats"]["var"]),
           "weight_grad": np.asarray(gp["scale"]), "bias_grad": np.asarray(gp["bias"])}
    for key in own:
        for want in (ref[key], own[key]):
            np.testing.assert_allclose(got[key], want, rtol=1e-5, atol=1e-5, err_msg=key)


def test_bridge_weights_are_replicated_on_every_rank(ranks, inputs):
    """Each rank loads the JAX weights through the bridge (each copy first
    perturbed by its rank); after ``replicate`` every rank holds rank 0's,
    the JAX weights' own, bits."""
    digests = ranks()["replicate"]
    engine = DPF(DPFConfig(**STEP_CFG), device="cpu")
    load_jax_variables(engine, inputs["step_vars"])
    digest = hashlib.sha256()
    for name, t in engine.state_dict().items():
        digest.update(name.encode())
        digest.update(t.numpy().tobytes())
    assert digests == [digest.hexdigest()] * WORLD


def test_make_mesh_shapes_and_errors(ranks):
    """As ``test_sharding.py::test_mesh_construction``, on 4 ranks and on
    one process; JAX lays out 4 devices alike."""
    assert jax_make_mesh(particle=2, devices=jax.devices()[:4]).shape == {"data": 2,
                                                                          "particle": 2}
    single = make_mesh()
    assert single.shape == {"data": 1, "particle": 1} and single.group is None
    with pytest.raises(ValueError):
        make_mesh(data=2)
    for shapes in ranks()["shapes"]:
        assert shapes[:2] == [{"data": 2, "particle": 2}, {"data": 4, "particle": 1}]
        assert all(s.startswith("ValueError") for s in shapes[2:]), shapes


def test_cli_on_a_mesh_matches_one_process(ranks, cli_dirs):
    """``main`` with ``--mesh-data 2 --mesh-particle 2`` on 4 ranks (data
    staged a half per data rank, the batches put together across them)
    writes, from rank 0, the artifacts of the one-process run (made on
    rank 0 alone), with its eval and test losses (rtol 1e-5)."""
    results = ranks()
    # rank 0's listings once it has written all; the logger's files carry
    # the time and host in their names
    seen, want = ([f for f in results[job][0] if "/logger/" not in f]
                  for job in ("cli", "cli_single"))
    assert seen == want and any(f.endswith("test_result.npz") for f in want)
    run = want[0].split("/")[1]
    for name in ("eval_loss_epoch.npy", "test_loss_epoch.npy"):
        got = np.load(cli_dirs / "mesh" / "logs" / run / "data" / name)
        np.testing.assert_allclose(got, np.load(cli_dirs / "single" / "logs" / run / "data" / name),
                                   rtol=1e-5, err_msg=name)


class _FakeParticleMesh:
    """A mesh whose particle axis has 2 ranks, for building DPF without a
    process group (building touches no collective)."""

    def axis_size(self, axis):
        return 2 if axis == "particle" else 1


PARTICLE_AXIS_SETTINGS = {
    "soft": dict(resampler_type="soft"),
    "dense_ot": dict(use_pallas=False),
    "transport_grad": dict(ot_transport_grad=True),
    "sdpf": dict(train_type="SDPF"),
}


@pytest.mark.parametrize("case", sorted(PARTICLE_AXIS_SETTINGS))
def test_particle_axis_refuses_item_23(case):
    """Soft resampling, OT over materialised costs and SDPF, refused under
    a particle axis until this slice, build on a data and on a particle
    axis (``test_single_card_settings_run_on_a_mesh`` runs them); what a
    particle axis still refuses is a particle count it does not divide."""
    settings = dict(STEP_CFG, **PARTICLE_AXIS_SETTINGS[case])
    for mesh in (dict(mesh_data=2), dict(mesh_particle=2)):
        check_supported(DPFConfig(**dict(settings, **mesh)))
    DPF(DPFConfig(**settings), device="cpu", mesh=_FakeParticleMesh())
    with pytest.raises(ValueError, match="not divisible"):
        DPF(DPFConfig(**dict(settings, num_particles=15)), device="cpu",
            mesh=_FakeParticleMesh())
