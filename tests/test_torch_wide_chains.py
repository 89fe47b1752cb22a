"""The packed chains that only the wide pair of coupling kernels runs on the
card (hidden above 16, more than 8 blocks, four or more blocks at 9-16),
held to the JAX package on the CPU: the port's ``fused_coupling_chain``
(on the CPU its plain version, ``chain_apply_packed_plain``) against JAX's
``FlowChain`` (dense XLA) and, at one chain, against JAX's fused Pallas
kernels in interpret mode, forward and inverse, log-det and gradients; the
parameters cross by the bridge.  The wide pair itself is held to the same
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase ``chain_kernels_wide``)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfdpf_tpu.ops.pallas.coupling_pallas as cp
from nfdpf_tpu.ops.flows import realnvp_chain as jax_realnvp_chain
from nfdpf_torch.bridge import flow_chain_state_from_jax
from nfdpf_torch.ops.cuda import coupling_cuda as cc
from nfdpf_torch.ops.flows import realnvp_chain

B, N = 2, 10


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """torch on one intra-op thread for each test here, restored after it:
    the test workers share the machine's cores, and at 8 threads each the
    port's 64- and 256-wide matrix products spend their time waiting on
    one another (tests/test_torch_models.py's ``one_intra_op_thread``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _std(hidden):
    """0.3 at hidden 8, scaled to the fan-in above: a 256-wide chain at 0.3
    saturates every tanh and its exp(s) reach e^15, where float32 rounding
    alone moves the outputs by 1e-3 of their size."""
    return 0.3 * math.sqrt(8 / max(8, hidden))


def _case(n_blocks, hidden, ctx_dim, seed, b=B):
    """A JAX chain and its variables (drawn with numpy in flax's layout, the
    weights N(0, ``_std(hidden)``²), the biases N(0, 0.1²): flax's own
    initialisers, run op by op, cost seconds at 48 nets), the port's chain
    loaded with them through the bridge, and (b, N) inputs."""
    rng = np.random.default_rng(seed)
    std = _std(hidden)

    def dense(fan_in, fan_out):
        return {"kernel": (rng.standard_normal((fan_in, fan_out)) * std).astype(np.float32),
                "bias": (rng.standard_normal(fan_out) * 0.1).astype(np.float32)}

    params = {f"flows_{k}": {net: {"Dense_0": dense(1 + ctx_dim, hidden),
                                   "Dense_1": dense(hidden, hidden),
                                   "Dense_2": dense(hidden, 1)}
                             for net in ("t1", "s1", "t2", "s2")}
              for k in range(n_blocks)}
    variables = {"params": params}
    jchain = jax_realnvp_chain(n_blocks, 2, hidden)
    tchain = realnvp_chain(n_blocks, 2, hidden, ctx_dim=ctx_dim)
    tchain.load_state_dict({k: torch.tensor(v)
                            for k, v in flow_chain_state_from_jax(variables).items()})
    x = rng.standard_normal((b, N, 2)).astype(np.float32)
    ctx = rng.standard_normal((b, N, ctx_dim)).astype(np.float32) if ctx_dim else None
    return jchain, variables, tchain, x, ctx


def _loss_terms(y, ld, lib):
    return lib.sum(lib.sin(y)) + lib.sum(ld * ld)


def _port(tchain, x, ctx, inverse):
    """(y, log_det, gradients of Σ sin(y) + Σ ld² in x, ctx, the packed
    weights and biases) through the port's fused_coupling_chain."""
    with torch.no_grad():
        w, b = cc.pack_chain_params(tchain)
    assert not cc.narrow_pair_takes(w.shape[0], w.shape[-1])
    leaves = [torch.tensor(x), None if ctx is None else torch.tensor(ctx), w, b]
    leaves = [None if t is None else t.clone().requires_grad_() for t in leaves]
    y, ld = cc.fused_coupling_chain(*leaves, inverse)
    wanted = [t for t in leaves if t is not None]
    grads = torch.autograd.grad(_loss_terms(y, ld, torch), wanted)
    return [y.detach(), ld.detach()] + [g.numpy() for g in grads]


def _close(got, ref, what, rtol, atol_scale):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=atol_scale * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


@pytest.mark.parametrize("n_blocks,hidden,ctx_dim", [(9, 32, 4), (12, 64, 36), (2, 256, 4)])
def test_wide_chain_matches_jax_flowchain(n_blocks, hidden, ctx_dim):
    """Forward and inverse outputs and log-dets against JAX's FlowChain to
    rtol 1e-5, atol 1e-5 of the largest (float32 products of up to 256
    terms in another order); in the inverse, the direction the filter runs
    most, the gradients of Σ sin(y) + Σ ld² in x, the context and every
    packed weight and bias (JAX's, packed by its own ``pack_chain_params``:
    the pack is linear) to rtol 1e-4, atol 1e-5 of the largest.  The
    forward's gradients are held to the same plain version's on the card
    and, at four blocks of 32, here to JAX's fused kernels."""
    jchain, variables, tchain, x, ctx = _case(n_blocks, hidden, ctx_dim, n_blocks + hidden)
    jx, jc = jnp.asarray(x), jnp.asarray(ctx)

    def loss(v, x_, c_):
        y, ld = jchain.apply(v, x_, c_, method=jchain.inverse)
        return _loss_terms(y, ld, jnp), (y, ld)

    (_, (y_ref, ld_ref)), (gv, gx, gc) = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                            has_aux=True)(variables, jx, jc)
    gw, gb = cp.pack_chain_params(gv, n_blocks, ctx_dim, hidden)
    got = _port(tchain, x, ctx, True)
    for what, a, r in zip(("y", "log_det"), got[:2], (y_ref, ld_ref)):
        _close(a.numpy(), r, what, 1e-5, 1e-5)
    for what, a, r in zip(("x", "ctx", "weights", "biases"), got[2:], (gx, gc, gw, gb)):
        _close(a, r, what, 1e-4, 1e-5)
    z_ref, _, ldf_ref = jchain.apply(variables, jx, jc, method=jchain.forward)
    with torch.no_grad():
        w, b = cc.pack_chain_params(tchain)
        z, ldf = cc.fused_coupling_chain(torch.tensor(x), torch.tensor(ctx), w, b, False)
    _close(z.numpy(), z_ref, "forward y", 1e-5, 1e-5)
    _close(ldf.numpy(), ldf_ref, "forward log_det", 1e-5, 1e-5)


def test_wide_chain_matches_jax_fused_kernels(monkeypatch):
    """Four blocks at hidden 32 with a 4-wide context, as the dynamics flow
    passes it, forward and inverse: against JAX's fused Pallas kernel
    (interpret mode, as ``tests/test_pallas_coupling.py`` runs it) to
    rtol/atol 1e-5 (the tolerance of ``tests/test_torch_flows.py`` at
    hidden 8); in the forward also the gradients of Σ sin(y) + Σ ld²
    against autodiff of JAX's dense version on the packed weights
    (``chain_apply_packed_dense``, the fused kernel's own reference) to
    rtol/atol 2e-5.  (JAX's fused backward in interpret mode takes ~14 s
    here; ``tests/test_pallas_coupling.py`` holds it to that same dense
    version.)"""
    _, variables, tchain, x, ctx = _case(4, 32, 4, 3, b=1)
    w_ref, b_ref = cp.pack_chain_params(variables, 4, 4, 32)
    jx, jc = jnp.asarray(x), jnp.asarray(ctx)
    monkeypatch.setattr(cp, "_INTERPRET", True)
    for inverse in (False, True):
        y_ref, ld_ref = cp.fused_coupling_chain(jx, jc, w_ref, b_ref, inverse)
        got = _port(tchain, x, ctx, inverse)
        for what, a, r in zip(("y", "log_det"), got[:2], (y_ref, ld_ref)):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{what} inverse={inverse}")

    def loss(x_, c_, w_, b_):
        y, ld = cp.chain_apply_packed_dense(x_, c_, w_, b_, False)
        return _loss_terms(y, ld, jnp)

    # compiled once: op by op every slice of the packed weights compiles apart
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(jx, jc, w_ref, b_ref)
    for what, a, r in zip(("x", "ctx", "weights", "biases"), _port(tchain, x, ctx, False)[2:],
                          grads):
        np.testing.assert_allclose(a, np.asarray(r), rtol=2e-5, atol=2e-5, err_msg=what)
