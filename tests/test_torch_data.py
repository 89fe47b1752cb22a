"""nfdpf_torch's simulator and dataset pipeline vs the JAX package: the
dynamics step, the rasteriser pixel for pixel, a 50-step sequence from the
JAX key schedule's draws, and shards that one package writes loading in the
other's ``DiskDataset`` with the same batches."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfdpf_tpu.data import simulator as jsim
from nfdpf_tpu.data.dataset import DiskDataset as JaxDiskDataset
from nfdpf_tpu.data.dataset import iterate_batches as jax_iterate_batches
from nfdpf_tpu.data.skew_t_plot import hansen_skew_t_pdf as jax_hansen_skew_t_pdf
from nfdpf_torch.data import skew_t_plot
from nfdpf_torch.data import simulator as tsim
from nfdpf_torch.data.dataset import FIELDS, DiskDataset, iterate_batches


def test_process_model_matches_jax():
    """Spring 0.1, drag 0.0075, the JAX package's operation order: rtol
    1e-6 (equal bits seen), at every sign of the velocity and at 0."""
    rng = np.random.default_rng(0)
    state = (rng.standard_normal((64, 4)) * 30).astype(np.float32)
    state[:4, 2:] = 0.0
    noise = (rng.standard_normal((64, 2)) * 2).astype(np.float32)
    want = np.asarray(jsim.process_model(jnp.asarray(state), jnp.asarray(noise)))
    got = tsim.process_model(torch.from_numpy(state), torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _render_case(seed, frames, k):
    rng = np.random.default_rng(seed)
    state = rng.uniform(-70, 70, (frames, 4)).astype(np.float32)
    d_state = rng.uniform(-70, 70, (frames, k, 4)).astype(np.float32)
    d_state[0, 0] = state[0]                    # a distractor right over the red disk
    radii = rng.integers(3, 10, (frames, k)).astype(np.float32)
    colors = np.asarray(jsim.DISTRACTOR_COLORS)[rng.integers(0, 6, (frames, k))]
    return state, d_state, radii, colors


@pytest.mark.parametrize("k", [1, 3, 25])
def test_render_frame_matches_jax_pixel_for_pixel(k):
    """Frames with the disks partly off the canvas, overlapping, and one
    distractor over the red disk: every pixel and the visible count equal
    JAX's, rendered one frame at a time there and in one batched call
    here."""
    state, d_state, radii, colors = _render_case(k, 12, k)
    got, vis = tsim.render_frame(*(torch.from_numpy(a) for a in (state, d_state, radii, colors)))
    assert got.dtype == torch.uint8 and vis.dtype == torch.int32
    render = jax.jit(jsim.render_frame)
    for f in range(len(state)):
        im, v = render(state[f], d_state[f], radii[f], colors[f])
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(im))
        assert int(vis[f]) == int(v)
    assert int(vis[0]) < int(vis.max())         # the occluded red disk shows less


def test_render_frame_occlusion():
    """The red disk at the centre under a green distractor of radius 5: the
    centre is green, a red ring shows between radius 5 and 7."""
    im, vis = tsim.render_frame(torch.zeros(4), torch.zeros(1, 4), torch.tensor([5.0]),
                                torch.tensor([[0.0, 255.0, 0.0]]))
    im = im.numpy()
    assert im.shape == (128, 128, 3)
    np.testing.assert_array_equal(im[64, 64], [0, 255, 0])
    np.testing.assert_array_equal(im[64, 64 + 6], [255, 0, 0])
    red = (im[..., 0] == 255) & (im[..., 1] == 0) & (im[..., 2] == 0)
    assert int(vis) == int(red.sum()) > 0


@functools.partial(jax.jit, static_argnums=0)
def _jax_draws(sim, key):
    """Every draw of ``DiskSimulator.generate_sequence(key)``, by its key
    schedule (simulator.py:128-152), compiled as that function is: op by op,
    JAX's uniform sits an ulp away from its compiled self."""
    half = sim.im_size // 2
    k = jax.random.split(key, 6)
    nd = sim.num_distractors
    keys_t = jax.random.split(jax.random.fold_in(key, 77), sim.sequence_length)

    def step_noise(key_t):
        kr, kd = jax.random.split(key_t)
        return jnp.concatenate([(sim.pos_noise * jax.random.normal(kr, (2,)))[None],
                                sim.pos_noise * jax.random.normal(kd, (nd, 2))])

    return {"pos0": jax.random.uniform(k[0], (2,), minval=-half, maxval=half),
            "vel0": jax.random.normal(k[1], (2,)) * 3.0,
            "d_pos0": jax.random.uniform(k[2], (nd, 2), minval=-half, maxval=half),
            "d_vel0": jax.random.normal(k[3], (nd, 2)) * 3.0,
            "radii": jax.random.randint(k[4], (nd,), 3, 10),
            "color_index": jax.random.randint(k[5], (nd,), 0, len(jsim.DISTRACTOR_COLORS)),
            "noise": jax.vmap(step_noise)(keys_t)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sequence_from_jax_draws(seed):
    """A 50-step, 25-distractor sequence from the draws of JAX's key
    schedule against ``generate_sequence``:

    * every frame and visible count equal;
    * the states equal JAX's op-by-op ``process_model`` chain bit for bit,
      and the compiled ``generate_sequence`` within atol 1e-4: XLA fuses the
      compiled scan's update and parts from its own op-by-op result by up
      to 1.5e-5 over 50 steps;
    * start state, q and dtypes as JAX's.
    """
    sim = jsim.DiskSimulator(sequence_length=50, num_distractors=25)
    key = jax.random.PRNGKey(seed)
    want = jax.device_get(jax.jit(sim.generate_sequence)(key))
    draws = {k: torch.from_numpy(np.asarray(v)[None].copy()) for k, v in _jax_draws(sim, key).items()}
    got = tsim.DiskSimulator(sequence_length=50, num_distractors=25).sequence_from_draws(draws)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape[1:] == v.shape and got[k].numpy().dtype == v.dtype, k
    for k in ("start_image", "image", "visible", "start_state", "q"):
        np.testing.assert_array_equal(got[k][0].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["state"][0].numpy(), want["state"], rtol=0, atol=1e-4)

    red = jnp.asarray(want["start_state"])
    for t in range(50):
        red = jsim.process_model(red, jnp.asarray(draws["noise"][0, t, 0].numpy()))
        np.testing.assert_array_equal(got["state"][0, t].numpy(), np.asarray(red))


def test_draws_and_shapes():
    """``draw_sequence``'s draws have the JAX distributions' supports and
    shapes; a record of ``num`` sequences has JAX's layout per sequence."""
    sim = tsim.DiskSimulator(sequence_length=5, num_distractors=3)
    draws = sim.draw_sequence(torch.Generator().manual_seed(0), num=4)
    assert draws["noise"].shape == (4, 5, 4, 2)
    assert int(draws["radii"].min()) >= 3 and int(draws["radii"].max()) <= 9
    assert int(draws["color_index"].min()) >= 0 and int(draws["color_index"].max()) <= 5
    assert float(draws["d_pos0"].abs().max()) <= 64.0
    rec = sim.sequence_from_draws(draws)
    shapes = {"start_image": (128, 128, 3), "start_state": (4,), "image": (5, 128, 128, 3),
              "state": (5, 4), "q": (5, 4), "visible": (5,)}
    assert {k: tuple(v.shape[1:]) for k, v in rec.items()} == shapes
    np.testing.assert_allclose(rec["q"][0, 0].numpy(), [2.0, 2.0, 2.0, 2.0])


def _gen_kwargs():
    return dict(num_examples=16, file_size=10, num_distractors=2, pos_noise=2.0,
                sequence_length=3, seed=0)


def test_generate_dataset_layout_matches_jax(tmp_path):
    """The port's shards: JAX's file names, per-shard 80/10/10 splits and
    fields and dtypes, deterministic for a seed, and they load alike in
    both packages' ``DiskDataset``."""
    tsim.generate_dataset(str(tmp_path / "port"), device="cpu", **_gen_kwargs())
    jsim.generate_dataset(str(tmp_path / "jax"), **_gen_kwargs())
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    tsim.generate_dataset(str(tmp_path / "again"), device="cpu", **_gen_kwargs())
    name = "toy_pn=2.0_d=2_const"
    for split in ("train_data", "val_data", "test_data"):
        ours = DiskDataset(str(tmp_path / "port"), name, split)
        theirs = JaxDiskDataset(str(tmp_path / "port"), name, split)
        again = DiskDataset(str(tmp_path / "again"), name, split)
        ref = JaxDiskDataset(str(tmp_path / "jax"), name, split)
        assert len(ours) == len(ref)
        for k in FIELDS:
            assert ours.data[k].dtype == ref.data[k].dtype
            assert ours.data[k].shape == ref.data[k].shape
            np.testing.assert_array_equal(ours.data[k], theirs.data[k])
            np.testing.assert_array_equal(ours.data[k], again.data[k])
    train = DiskDataset(str(tmp_path / "port"), name, "train_data")
    assert len(train) == 16


def test_jax_shards_load_in_the_port(tmp_path):
    """Shards the JAX simulator writes load in the port's ``DiskDataset``
    (``max_files`` too) and give ``iterate_batches`` the JAX batches."""
    jsim.generate_dataset(str(tmp_path), **_gen_kwargs())
    name = "toy_pn=2.0_d=2_const"
    ours = DiskDataset(str(tmp_path), name, "train_data")
    ref = JaxDiskDataset(str(tmp_path), name, "train_data")
    assert len(ours) == len(ref) == 16
    assert [a.shape for a in ours[0]] == [a.shape for a in ref[0]]
    for shuffle, drop_last in ((True, True), (False, False)):
        got = list(iterate_batches(ours, 3, shuffle=shuffle, drop_last=drop_last, seed=4))
        want = list(jax_iterate_batches(ref, 3, shuffle=shuffle, drop_last=drop_last, seed=4))
        assert len(got) == len(want) == (5 if drop_last else 6)
        for a, b in zip(got, want):
            for k in FIELDS:
                np.testing.assert_array_equal(a[k], b[k])
    assert len(DiskDataset(str(tmp_path), name, "train_data", max_files=1)) == len(
        JaxDiskDataset(str(tmp_path), name, "train_data", max_files=1)) == 8
    with pytest.raises(FileNotFoundError):
        DiskDataset(str(tmp_path), "absent", "train_data")


def test_cli_writes_the_shards(tmp_path, monkeypatch):
    """``python -m nfdpf_torch.data.simulator`` passes its flags through to
    ``generate_dataset`` (here on the CPU: the CLI runs on the card)."""
    import nfdpf_torch.models.dpf as dpf

    monkeypatch.setattr(dpf, "resolve_device", lambda device=None: torch.device("cpu"))
    tsim._cli(["--out-dir", str(tmp_path), "--num-examples", "8", "--file-size", "10",
               "--num-distractors", "2", "--sequence-length", "3", "--seed", "1"])
    assert sorted(os.listdir(tmp_path)) == [f"toy_pn=2.0_d=2_const0_{s}.npz"
                                            for s in ("test", "train", "val")]
    ds = DiskDataset(str(tmp_path), "toy_pn=2.0_d=2_const", "train_data")
    assert ds.data["image"].shape == (8, 3, 128, 128, 3)


@pytest.mark.parametrize("eta,lam", [(30.0, 0.0), (5.0, 0.0), (5.0, 0.5), (5.0, -0.5), (2.5, 0.9)])
def test_skew_t_pdf_equals_jax_and_integrates_to_one(eta, lam):
    """Hansen's skewed-t density: bit for bit JAX's numpy function, and the
    properties tests/test_utils_extra.py checks (non-negative, integral 1
    within 1e-2 over [−30, 30], symmetric at λ = 0)."""
    x = np.linspace(-30, 30, 20001)
    pdf = skew_t_plot.hansen_skew_t_pdf(x, eta, lam)
    np.testing.assert_array_equal(pdf, jax_hansen_skew_t_pdf(x, eta, lam))
    assert np.all(pdf >= 0) and abs(np.trapezoid(pdf, x) - 1.0) < 1e-2
    if lam == 0.0:
        np.testing.assert_allclose(pdf, pdf[::-1], rtol=1e-10)


def test_skew_t_main_writes_its_png(tmp_path):
    out = str(tmp_path / "skew.png")
    skew_t_plot.main(out)
    with open(out, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
