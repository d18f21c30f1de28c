"""tpureg_torch's CUDA kernels against their plain PyTorch versions, on the
card. Without a card every test here skips (the check is made in a fixture,
so every process collects the same tests).

This file imports neither JAX nor tpureg, so it also runs where JAX is not
installed:  python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from tpureg_torch.ops import correlation, correlation_cuda, correlation_reference
from tpureg_torch.ops import cuda_lib
from tpureg_torch.ops import sample2d, sample2d_cuda, sample2d_gather

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda_lib.load()  # builds the kernels on first use
    return torch.device("cuda")


def _bf16_close(got, want):
    """Both sides round the same fp32 sums, added in another order, to bf16:
    they may differ by one bf16 step, 2^-8 of the value."""
    got, want = got.float(), want.float()
    bound = 2.0 ** -7 * want.abs() + 1e-6
    assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())


# ---------------------------------------------------------------------------
# K1: correlation

@pytest.mark.parametrize("shape,md,s2", [
    ((8, 256, 32, 32), 20, 2),   # FlowNetC at 256²
    ((2, 64, 16, 20), 4, 1),     # PWC's configuration
    ((1, 40, 9, 37), 20, 2),     # ragged column tile
    ((1, 16, 12, 45), 20, 1),    # K = 41: two tiles of displacements
])
def test_correlation_fp32_matches_plain(dev, shape, md, s2):
    g = torch.Generator(device=dev).manual_seed(0)
    f1 = torch.randn(shape, device=dev, generator=g)
    f2 = torch.randn(shape, device=dev, generator=g)
    got = correlation_cuda(f1, f2, md, s2)
    want = correlation_reference(f1, f2, md, s2)
    torch.cuda.synchronize()
    # fp32 sums of C unit products in another order: ~1e-6 of sqrt(C)/C
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_correlation_bf16_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    f1 = torch.randn((8, 256, 32, 32), device=dev, generator=g).bfloat16()
    f2 = torch.randn((8, 256, 32, 32), device=dev, generator=g).bfloat16()
    got = correlation_cuda(f1, f2, 20, 2)
    assert got.dtype == torch.bfloat16
    _bf16_close(got, correlation_reference(f1, f2, 20, 2))


def test_correlation_dispatch_launches_kernel(dev):
    f1 = torch.randn((1, 8, 6, 6), device=dev)
    before = correlation_cuda.launches
    correlation(f1, f1, 2, 1)
    assert correlation_cuda.launches == before + 1


def test_correlation_refuses_what_the_kernel_does_not_take(dev):
    f = torch.randn((1, 8, 6, 6), device=dev)
    with pytest.raises(TypeError):
        correlation(f.half(), f.half(), 2, 1)
    with pytest.raises(ValueError):
        correlation_cuda(f[:, :, :, ::2], f[:, :, :, ::2], 2, 1)
    f1 = f.clone().requires_grad_()
    out = correlation(f1, f, 2, 1)
    with pytest.raises(NotImplementedError, match="K2"):
        out.sum().backward()


# ---------------------------------------------------------------------------
# K3: bilinear warp

def _positions(dev, b, h, w, scale, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    flow = torch.randn((b, 2, h, w), device=dev, generator=g) * scale
    px = torch.arange(w, device=dev, dtype=torch.float32) + flow[:, 0]
    py = torch.arange(h, device=dev, dtype=torch.float32)[:, None] + flow[:, 1]
    return px.reshape(b, -1).contiguous(), py.reshape(b, -1).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1, 256, 256), (2, 3, 37, 53)])
def test_warp_matches_plain(dev, dtype, shape):
    b, c, h, w = shape
    g = torch.Generator(device=dev).manual_seed(2)
    img = torch.rand(shape, device=dev, generator=g).to(dtype)
    px, py = _positions(dev, b, h, w, scale=0.4 * max(h, w), seed=3)
    assert float(px.min()) < 0 and float(px.max()) > w
    got = sample2d_cuda(img, px, py)
    want = sample2d_gather(img.float(), px, py).reshape(b, c, -1)
    torch.cuda.synchronize()
    # products and sums are rounded one at a time in the plain version's
    # order: equal to the last bit
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_warp_non_finite_positions_give_zero(dev):
    img = torch.ones((1, 1, 4, 4), device=dev)
    px = torch.tensor([[float("nan"), float("inf"), -1e30, 1.5]], device=dev)
    py = torch.tensor([[0.0, 0.0, 0.0, 1e30]], device=dev)
    out = sample2d_cuda(img, px, py)
    assert torch.equal(out, torch.zeros_like(out))


def test_warp_dispatch_launches_kernel_and_casts(dev):
    img = torch.rand((2, 1, 8, 8), device=dev).bfloat16()
    px = torch.rand((2, 5, 5), device=dev) * 8
    before = sample2d_cuda.launches
    out = sample2d(img, px, px)
    assert sample2d_cuda.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (2, 1, 5, 5)
    with pytest.raises(TypeError):
        sample2d(img.half(), px, px)
    px_g = px.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="K4"):
        sample2d(img.float(), px_g, px).sum().backward()
