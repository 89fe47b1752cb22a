"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: each test skips where no CUDA device is present.  This
file imports no JAX, so it also runs where JAX is not installed; there,
skip the repository's conftest (which sets JAX up for the other tests):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from nfdpf_torch.ops.cuda import sinkhorn_cuda as sc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and launch the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, n, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, n, 2, generator=gen) * 0.5
    v = torch.randn(b, n, 2, generator=gen) * 30
    r = torch.randn(b, n, generator=gen) * 0.1
    c = torch.randn(b, n, generator=gen) * 0.1 - math.log(n)
    probe = torch.randn(b, n, 2, generator=gen)
    return x, v, r, c, probe, gen


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(32, 100), (4, 4097)])
@pytest.mark.parametrize("groups", [1, 2])
def test_lse_kernel_matches_plain(cuda, b, n, groups):
    """K1 to rtol/atol 1e-5 at the main path's shape and a ragged one."""
    x, _, _, _, _, gen = _inputs(b, n, b + n)
    fs = torch.randn(b, groups, n, generator=gen).to(cuda)
    x = x.to(cuda)
    eps = torch.linspace(0.1, 2.0, b).to(cuda)
    sc.reset_launches()
    got = sc.streaming_lse_multi(eps, x, x, fs)
    torch.cuda.synchronize()
    assert sc.LAUNCHES["sinkhorn_lse"] == 1
    torch.testing.assert_close(got, sc.lse_multi_plain(eps, x, x, fs), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(32, 100), (4, 4097)])
def test_apply_kernel_forward_and_backward_match_plain(cuda, b, n):
    """K2 forward and its VJP (the same kernel, roles swapped) to 1e-4
    relative to the output's scale."""
    x, v, r, c, probe, _ = (t.to(cuda) if torch.is_tensor(t) else t
                            for t in _inputs(b, n, 7 * b + n))
    eps = torch.linspace(0.1, 2.0, b).to(cuda)
    v = v.requires_grad_()
    sc.reset_launches()
    out = sc.transport_apply_rc(v, eps, x, x, r, c)
    ref = sc.transport_apply_plain(v, eps, x, x, r, c)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * float(ref.detach().abs().max()))
    (g_k,) = torch.autograd.grad(torch.sum(out * probe), [v])
    (g_p,) = torch.autograd.grad(torch.sum(ref * probe), [v])
    torch.cuda.synchronize()
    assert sc.LAUNCHES["transport_apply"] == 1 and sc.LAUNCHES["transport_apply_bwd"] == 1
    torch.testing.assert_close(g_k, g_p, rtol=1e-4, atol=1e-4 * float(g_p.abs().max()))


@pytest.mark.cuda
def test_ot_resample_on_kernels_matches_cpu(cuda):
    """The resampler on the kernels against the same on the CPU's plain
    versions: same iteration count, particles within atol 1e-3 (magnitude 60)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 100, 2, generator=gen) * 20
    probs = torch.softmax(torch.randn(8, 100, generator=gen), dim=-1)
    p_cpu, _, _, it_cpu = sc.ot_resample_streaming(x, probs)
    p_gpu, _, _, it_gpu = sc.ot_resample_streaming(x.to(cuda), probs.to(cuda))
    assert it_gpu == it_cpu > 0
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-5, atol=1e-3)
