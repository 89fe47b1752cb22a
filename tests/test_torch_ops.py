"""nfdpf_torch ops vs the JAX package: density and Sinkhorn helpers, the plain
versions of the two streaming-Sinkhorn kernels, and the streaming OT
resampler.  Inputs come from numpy with a seed; the JAX Pallas kernels run in
interpret mode (as in tests/test_pallas.py), the port on the CPU through the
kernels' plain versions.  The CUDA kernels themselves are held to the plain
versions by tests/test_torch_cuda.py on a GPU."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfdpf_tpu.ops.density as jd
import nfdpf_tpu.ops.pallas.sinkhorn_pallas as sp
import nfdpf_tpu.ops.sinkhorn as js
import nfdpf_torch.ops.density as td
import nfdpf_torch.ops.sinkhorn as ts
from nfdpf_torch.ops.cuda import build as cuda_build
from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(sp, "_INTERPRET", True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _cloud(seed, b=2, n=40, scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, n, 2)) * scale).astype(np.float32)
    lw = rng.standard_normal((b, n)).astype(np.float32)
    probs = (np.exp(lw) / np.exp(lw).sum(-1, keepdims=True)).astype(np.float32)
    return x, probs


# ---------------------------------------------------------------------------
# density helpers (tolerance: float32 round-off, rtol 1e-5 / atol 1e-6)
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(0)
_LOGW = (_rng.standard_normal((3, 7)) * 50).astype(np.float32)
_NOISE4 = _rng.standard_normal((3, 7, 4)).astype(np.float32)
_NOISE2 = _rng.standard_normal((3, 7, 2)).astype(np.float32)
_A = _rng.standard_normal((3, 1, 5)).astype(np.float32)
_B = _rng.standard_normal((3, 7, 5)).astype(np.float32)
_P = (np.abs(_rng.standard_normal((3, 7))) + 0.1).astype(np.float32)
_X = _rng.standard_normal((3, 7, 2)).astype(np.float32)

DENSITY_CASES = {
    "normalize_log_weights": lambda m, f: m.normalize_log_weights(f(_LOGW)),
    "effective_sample_size": lambda m, f: m.effective_sample_size(f(_P / _P.sum(-1, keepdims=True))),
    "log_normal_density_d2": lambda m, f: m.log_normal_density(f(_NOISE2), 20.0, 20.0),
    "log_normal_density_d4": lambda m, f: m.log_normal_density(f(_NOISE4), 2.0, 3.0),
    "cosine_distance": lambda m, f: m.cosine_distance(f(_A), f(_B)),
    "weighted_mean": lambda m, f: m.weighted_mean(f(_X), f(_P)),
    "uniform_log_weights": lambda m, f: m.uniform_log_weights(3, 7),
}


@pytest.mark.parametrize("case", sorted(DENSITY_CASES))
def test_density_helper_matches_jax(case):
    fn = DENSITY_CASES[case]
    ref = np.asarray(fn(jd, _j))
    got = fn(td, _t).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_normalize_log_weights_gradient_through_max():
    """The max shift is differentiable in both packages (tolerance 1e-5)."""
    probe = _rng.standard_normal(_LOGW.shape).astype(np.float32)
    g_ref = jax.grad(lambda lw: jnp.sum(jd.normalize_log_weights(lw) * probe))(_j(_LOGW))
    lw = _t(_LOGW).requires_grad_()
    torch.sum(td.normalize_log_weights(lw) * _t(probe)).backward()
    np.testing.assert_allclose(lw.grad.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Sinkhorn geometry helpers (tolerance rtol 1e-5 / atol 1e-5)
# ---------------------------------------------------------------------------

_XS, _ = _cloud(3, b=3, n=11)
_YS, _ = _cloud(4, b=3, n=13)
_F = _rng.standard_normal((3, 13)).astype(np.float32)
_EPS = np.array([0.3, 1.0, 2.5], np.float32)
_CONST = np.ones((3, 11, 2), np.float32)   # zero spread: diameter floors at 1

SINKHORN_CASES = {
    "squared_distances": lambda m, f: m.squared_distances(f(_XS), f(_YS)),
    "cost": lambda m, f: m.cost(f(_XS), f(_YS)),
    "diameter": lambda m, f: m.diameter(f(_XS), f(_YS)),
    "diameter_zero_spread": lambda m, f: m.diameter(f(_CONST), f(_CONST)),
    "max_min": lambda m, f: m.max_min(f(_XS), f(_YS)),
    "softmin": lambda m, f: m.softmin(f(_EPS), m.cost(f(_XS), f(_YS)), f(_F)),
    "softmin_scalar_eps": lambda m, f: m.softmin(0.7, m.cost(f(_XS), f(_YS)), f(_F)),
}


@pytest.mark.parametrize("case", sorted(SINKHORN_CASES))
def test_sinkhorn_helper_matches_jax(case):
    fn = SINKHORN_CASES[case]
    ref = np.asarray(fn(js, _j))
    got = fn(ts, _t).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K1 plain version vs the Pallas _lse_kernel (tolerance 1e-5, as
# tests/test_pallas.py holds the kernel to the dense softmin)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,g", [(40, 40, 2), (37, 37, 1), (37, 53, 2), (100, 37, 2),
                                   (37, 4097, 1), (1, 40, 2), (40, 1, 1)])
def test_lse_plain_matches_pallas_kernel(n, m, g):
    rng = np.random.default_rng(n * 100 + m + g)
    b = 3
    x = (rng.standard_normal((b, n, 2)) * 0.5).astype(np.float32)
    y = (rng.standard_normal((b, m, 2)) * 0.5).astype(np.float32)
    fs = rng.standard_normal((b, g, m)).astype(np.float32)
    eps = np.array([0.1, 0.37, 1.3], np.float32)
    ref = np.asarray(sp.streaming_lse_multi(_j(eps), _j(x), _j(y), _j(fs)))
    got = sc.streaming_lse_multi(_t(eps), _t(x), _t(y), _t(fs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # softmin wrappers are −ε·lse of the same
    ref_sm = np.asarray(sp.streaming_softmin(_j(eps), _j(x), _j(y), _j(fs[:, 0])))
    got_sm = sc.streaming_softmin(_t(eps), _t(x), _t(y), _t(fs[:, 0])).numpy()
    np.testing.assert_allclose(got_sm, ref_sm, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K2 plain version vs the Pallas _apply_kernel, forward and VJP
# (tolerance rtol 1e-4 / atol 1e-5, as tests/test_pallas.py)
# ---------------------------------------------------------------------------


def _apply_inputs(seed, b, n, m):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, n, 2)) * 0.5).astype(np.float32)
    y = (rng.standard_normal((b, m, 2)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, m, 2)) * 30).astype(np.float32)
    r = (rng.standard_normal((b, n)) * 0.1).astype(np.float32)
    c = (rng.standard_normal((b, m)) * 0.1 - math.log(m)).astype(np.float32)
    eps = np.linspace(0.2, 0.9, b).astype(np.float32)
    return eps, x, y, v, r, c


@pytest.mark.parametrize("n,m", [(24, 24), (37, 37), (37, 29), (100, 37), (37, 4097),
                                 (1, 24), (24, 1)])
def test_transport_apply_plain_matches_pallas_kernel(n, m):
    eps, x, y, v, r, c = _apply_inputs(n + m, 2, n, m)
    ref = np.asarray(sp.transport_apply_rc(_j(v), _j(eps), _j(x), _j(y), _j(r), _j(c)))
    got = sc.transport_apply_rc(_t(v), _t(eps), _t(x), _t(y), _t(r), _t(c)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,m", [(16, 16), (37, 29), (100, 37), (1, 24), (24, 1)])
def test_transport_apply_vjp_matches_pallas(n, m):
    """Backward is Tᵀg for ``values`` and nothing for the other inputs."""
    eps, x, y, v, r, c = _apply_inputs(7 * n + m, 2, n, m)
    probe = np.random.default_rng(1).standard_normal((2, n, 2)).astype(np.float32)

    def loss(values):
        out = sp.transport_apply_rc(values, _j(eps), _j(x), _j(y), _j(r), _j(c))
        return jnp.sum(out * probe)

    g_ref = np.asarray(jax.grad(loss)(_j(v)))
    tv = _t(v).requires_grad_()
    others = [_t(a).requires_grad_() for a in (eps, x, y, r, c)]
    out = sc.transport_apply_rc(tv, *others)
    grads = torch.autograd.grad(torch.sum(out * _t(probe)), [tv, *others],
                                allow_unused=True)
    np.testing.assert_allclose(grads[0].numpy(), g_ref, rtol=1e-4, atol=1e-5)
    assert all(g is None for g in grads[1:])


# ---------------------------------------------------------------------------
# the streaming OT resampler vs ot_resample_pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n,convergence", [(0, 37, "all"), (4, 37, "all"),
                                                (2, 32, "any")])
def test_ot_resample_streaming_matches_pallas(seed, n, convergence):
    """Same iteration count, same transported particles (atol 1e-4 on
    coordinates of magnitude ~60: float32 round-off through ~70 iterations)."""
    x, probs = _cloud(seed, b=3, n=n, scale=20.0)
    kw = dict(eps=0.1, scaling=0.75, threshold=1e-3, max_iter=100,
              convergence=convergence)
    p_ref, w_ref, i_ref, extras = sp.ot_resample_pallas(
        _j(x), _j(probs), return_extras=True, **kw)
    p, w, idx, iters = sc.ot_resample_streaming(_t(x), _t(probs), **kw)
    assert iters == int(extras["iters"]) > 0
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))


def test_ot_resample_streaming_respects_max_iter():
    x, probs = _cloud(5, b=2, n=16, scale=10.0)
    _, _, _, extras = sp.ot_resample_pallas(_j(x), _j(probs), max_iter=4,
                                            return_extras=True)
    _, _, _, iters = sc.ot_resample_streaming(_t(x), _t(probs), max_iter=4)
    assert iters == int(extras["iters"]) == 3


# the chunked loop: LOOP_CHUNK iterations between two host reads, the state
# frozen on the loop's own last iteration (one CUDA-graph replay on the card;
# the same chunks on the plain versions here).  max_iter 1, 2, k and k + 1
# for each k below, and a bound the loop never meets
CHUNK_MAX_ITERS = (1, 2, 3, 4, 8, 9, 100)


def _chunk_cases(conv, pots, k=None):
    """(max_iter, warm_start, JAX reference key) of the chunked-loop test:
    cold at 1, 2, k, k + 1 and 100 (every such max_iter for k ∈ {1, 3, 8}
    when k is None), warm valid and invalid at 2 and 100."""
    cold = CHUNK_MAX_ITERS if k is None else sorted({1, 2, k, k + 1, 100})
    return ([(mi, None, "cold") for mi in cold]
            + [(mi, (pots, valid), "warm" if valid else "cold")
               for mi in (2, 100) for valid in (True, False)])


@pytest.fixture(scope="module")
def chunk_refs():
    """JAX's ``ot_resample_pallas`` (interpret mode) on one cloud: cold for
    each max_iter and convergence mode, and warm (valid) from its own
    unbounded cold potentials at max_iter 2 and 100; and the port's eager
    loop (``ot_resample_streaming_plain``) at each case, which no chunk size
    changes.  Torch runs on one thread here: the tensors are tiny."""
    saved, sp._INTERPRET = sp._INTERPRET, True
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        x, probs = _cloud(21, b=3, n=24, scale=20.0)
        refs, eager = {}, {}
        for conv in ("all", "any"):
            for mi in CHUNK_MAX_ITERS:
                out = sp.ot_resample_pallas(_j(x), _j(probs), max_iter=mi, convergence=conv,
                                            return_extras=True)
                refs[conv, mi, "cold"] = (np.array(out[0]), int(out[3]["iters"]),
                                          np.array(out[3]["potentials"]))
            pots = _j(refs[conv, 100, "cold"][2])
            for mi in (2, 100):
                out = sp.ot_resample_pallas(_j(x), _j(probs), max_iter=mi, convergence=conv,
                                            warm_start=(pots, jnp.asarray(True)),
                                            return_extras=True)
                refs[conv, mi, "warm"] = (np.array(out[0]), int(out[3]["iters"]),
                                          np.array(out[3]["potentials"]))
            for mi, warm, _ in _chunk_cases(conv, _t(refs[conv, 100, "cold"][2])):
                eager[conv, mi, None if warm is None else warm[1]] = \
                    sc.ot_resample_streaming_plain(_t(x), _t(probs), max_iter=mi,
                                                   convergence=conv, warm_start=warm,
                                                   return_potentials=True)
    finally:
        sp._INTERPRET = saved
        torch.set_num_threads(threads)
    return x, probs, refs, eager


@pytest.mark.parametrize("k", [1, 3, 8])
def test_chunked_loop_matches_eager_loop_and_jax(monkeypatch, chunk_refs, k):
    """Chunks of k iterations against the eager loop that tests after every
    iteration (``ot_resample_streaming_plain``, the parent's loop): the same
    iterations, potentials and particles bit for bit.  Against JAX: the same
    iterations, potentials within rtol/atol 1e-5 (the dense loop's bound in
    tests/test_torch_resampling.py), particles rtol 1e-5 / atol 1e-4.  Cold
    at max_iter 1, 2, k, k + 1 and 100, both convergence modes; warm valid
    (from JAX's potentials) and invalid (the cold start) at 2 and 100."""
    monkeypatch.setattr(sc, "LOOP_CHUNK", k)
    x, probs, refs, eager = chunk_refs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for conv in ("all", "any"):
            for mi, warm, ref_key in _chunk_cases(conv, _t(refs[conv, 100, "cold"][2]), k):
                got = sc.ot_resample_streaming(_t(x), _t(probs), max_iter=mi, convergence=conv,
                                               warm_start=warm, return_potentials=True)
                want = eager[conv, mi, None if warm is None else warm[1]]
                case = (conv, mi, ref_key, warm is not None)
                assert got[3] == want[3], case
                assert torch.equal(got[4], want[4]) and torch.equal(got[0], want[0]), case
                p_ref, it_ref, pot_ref = refs[conv, mi, ref_key]
                assert got[3] == it_ref, case
                np.testing.assert_allclose(got[4].numpy(), pot_ref, rtol=1e-5, atol=1e-5)
                np.testing.assert_allclose(got[0].numpy(), p_ref, rtol=1e-5, atol=1e-4)
    finally:
        torch.set_num_threads(threads)


def test_chunked_loop_reads_the_host_once_a_chunk(monkeypatch):
    """One host read per chunk of ``LOOP_CHUNK`` iterations (⌈iters / k⌉),
    where the eager loop reads once per loop test (iters + 1); none when
    max_iter leaves no iteration."""
    x, probs = _cloud(3, b=2, n=20, scale=20.0)
    monkeypatch.setattr(sc, "LOOP_CHUNK", 4)
    for mi in (1, 100):
        sc.reset_streaming_loop()
        iters = sc.ot_resample_streaming(_t(x), _t(probs), max_iter=mi)[3]
        assert sc.STREAMING_LOOP == {"calls": 1, "iters": iters, "host_reads": -(-iters // 4)}
        sc.reset_streaming_loop()
        assert sc.ot_resample_streaming_plain(_t(x), _t(probs), max_iter=mi)[3] == iters
        assert sc.STREAMING_LOOP == {"calls": 1, "iters": iters,
                                     "host_reads": iters + 1 if mi > 1 else 0}
    assert iters > 4


def test_chunked_loop_keeps_the_inputs_dtype():
    """In float64 (the CPU ranks' witness of the mesh steps) the chunked loop
    keeps float64 state: the eager loop's iterations and bits."""
    x, probs = _cloud(4, b=2, n=20, scale=20.0)
    x64, p64 = _t(x).double(), _t(probs).double()
    got = sc.ot_resample_streaming(x64, p64, return_potentials=True)
    eager = sc.ot_resample_streaming_plain(x64, p64, return_potentials=True)
    assert got[4].dtype == torch.float64 and got[3] == eager[3] > 0
    assert torch.equal(got[4], eager[4]) and torch.equal(got[0], eager[0])


def test_ot_resample_streaming_gradient_topology():
    """Gradient reaches the particles only through T @ particles (matching
    JAX, rtol 1e-4) and never the weights (mirrors
    tests/test_pallas.py::test_ot_resample_pallas_gradient_topology)."""
    x, probs = _cloud(11, b=1, n=16)
    probe = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def loss_p(p):
        out, _, _ = sp.ot_resample_pallas(p, _j(probs), max_iter=10)
        return jnp.sum(out * probe)

    g_ref = np.asarray(jax.grad(loss_p)(_j(x)))
    tx = _t(x).requires_grad_()
    tw = _t(probs).requires_grad_()
    out, w, _, _ = sc.ot_resample_streaming(tx, tw, max_iter=10)
    g_x, g_w = torch.autograd.grad(torch.sum(out * _t(probe)) + torch.sum(w),
                                   [tx, tw], allow_unused=True)
    assert float(g_x.abs().sum()) > 0
    np.testing.assert_allclose(g_x.numpy(), g_ref, rtol=1e-4, atol=1e-5)
    assert g_w is None


def test_launch_counters_untouched_on_cpu():
    """The CPU path runs the plain versions: no kernel launch is counted."""
    sc.reset_launches()
    x, probs = _cloud(1, b=2, n=12)
    sc.ot_resample_streaming(_t(x), _t(probs), max_iter=5)
    assert sc.LAUNCHES == {k: 0 for k in sc.LAUNCHES}


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a GPU is refused, never
    silently computed by the plain version."""
    eps = torch.ones(2, device="meta")
    x = torch.empty((2, 8, 2), device="meta")
    with pytest.raises(ValueError, match="device"):
        sc.streaming_lse_multi(eps, x, x, torch.empty((2, 1, 8), device="meta"))
    with pytest.raises(ValueError, match="device"):
        sc.transport_apply_rc(x, eps, x, x, torch.empty((2, 8), device="meta"),
                              torch.empty((2, 8), device="meta"))


def test_wrappers_check_shapes():
    eps = torch.ones(2)
    with pytest.raises(ValueError, match="bad shapes"):
        sc.streaming_lse_multi(eps, torch.zeros(2, 5, 3), torch.zeros(2, 5, 3),
                               torch.zeros(2, 1, 5))
    with pytest.raises(ValueError, match="bad shapes"):
        sc.transport_apply_rc(torch.zeros(2, 4, 2), eps, torch.zeros(2, 5, 2),
                              torch.zeros(2, 4, 2), torch.zeros(2, 5), torch.zeros(2, 3))


def test_read_launch_note_decodes_the_library_record():
    """A library's launch note (csrc/launch_note.cuh) as the Python side
    reads it: the ten numbers and the kernel's name, or the cudaError_t."""
    from nfdpf_torch.ops.cuda._common import read_launch_note

    def entry(slot, out, name, size):
        assert slot == 2 and size > len("chain_ctx_share_kernel<16>")
        for i, v in enumerate((40, 1024, 2048, 3, 2, 1, 256, 1, 1, 7)):
            out[i] = v
        name.value = b"chain_ctx_share_kernel<16>"
        return 0

    assert read_launch_note(entry, 2) == {
        "kernel": "chain_ctx_share_kernel<16>", "registers": 40, "smem_static_bytes": 1024,
        "smem_dynamic_bytes": 2048, "grid": [3, 2, 1], "block": [256, 1, 1], "launches": 7}
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        read_launch_note(lambda out, name, size: 1)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("sinkhorn")
