"""tpureg_torch's CUDA kernels against their plain PyTorch versions, on the
card. Without a card every test here skips (the check is made in a fixture,
so every process collects the same tests).

This file imports neither JAX nor tpureg, so it also runs where JAX is not
installed:  python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from tpureg_torch.ops import (
    correlation,
    correlation_bwd_cuda,
    correlation_bwd_reference,
    correlation_cuda,
    correlation_reference,
    cuda_lib,
    sample2d,
    sample2d_cuda,
    sample2d_dimg_cuda,
    sample2d_dimg_reference,
    sample2d_dpos_cuda,
    sample2d_dpos_reference,
    sample2d_gather,
    sample2d_taps_reference,
    sample3d,
    sample3d_cuda,
    sample3d_dpos_cuda,
    sample3d_dpos_reference,
    sample3d_dvol_cuda,
    sample3d_dvol_reference,
    sample3d_gather,
    warp3d,
)
from tpureg_torch.classical import exp_velocity3d
from tpureg_torch.classical.syn import _compose
from tpureg_torch.ops import warp as warp_ops
from tpureg_torch.ops.library import OPS
from tpureg_torch.ops.warp import warp2d

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda_lib.load()  # builds the kernels on first use
    return torch.device("cuda")


def _bf16_close(got, want, atol=1e-6):
    """Both sides round the same fp32 sums, added in another order, to bf16:
    they may differ by one bf16 step, 2^-8 of the value."""
    got, want = got.float(), want.float()
    bound = 2.0 ** -7 * want.abs() + atol
    assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())


# ---------------------------------------------------------------------------
# K1: correlation

K1_CASES = [
    ((8, 256, 32, 32), 20, 2),   # FlowNetC at 256²
    ((2, 64, 16, 20), 4, 1),     # PWC's configuration
    ((1, 40, 9, 37), 20, 2),     # ragged column tile
    ((1, 16, 12, 45), 20, 1),    # K = 41: two tiles of displacements
    ((1, 32, 16, 80), 20, 2),    # the window outgrows the widest tile
    ((8, 196, 4, 4), 4, 1),      # PWC's levels: 4², 32², 64²
    ((8, 64, 32, 32), 4, 1),
    ((2, 32, 64, 64), 4, 1),
    ((2, 24, 13, 29), 3, 2),     # s2 does not divide md: no parity classes
    ((1, 16, 7, 33), 20, 2),     # H = 7: not a multiple of a block's rows
    ((2, 40, 16, 16), 4, 2),     # C = 40, not a multiple of 16
    ((1, 1280, 4, 40), 4, 1),    # channels in chunks: more than shared memory holds
]


def _k1_inputs(dev, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, device=dev, generator=g),
            torch.randn(shape, device=dev, generator=g))


@pytest.mark.parametrize("shape,md,s2", K1_CASES)
def test_correlation_fp32_matches_plain(dev, shape, md, s2):
    f1, f2 = _k1_inputs(dev, shape, 0)
    got = correlation_cuda(f1, f2, md, s2)
    want = correlation_reference(f1, f2, md, s2)
    torch.cuda.synchronize()
    # fp32 sums of C unit products in another order (the products in three
    # TF32 passes, each good to ~2^-22 of its size): ~1e-6 of sqrt(C)/C
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,md,s2", K1_CASES)
def test_correlation_bf16_matches_plain(dev, shape, md, s2):
    f1, f2 = (t.bfloat16() for t in _k1_inputs(dev, shape, 1))
    got = correlation_cuda(f1, f2, md, s2)
    assert got.dtype == torch.bfloat16
    _bf16_close(got, correlation_reference(f1, f2, md, s2))


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
    with pytest.raises(ValueError):
        correlation_bwd_cuda(f, f, torch.zeros((1, 9, 6, 7), device=dev), 1, 1)
    # K1 takes a band of at most 8 n8 tiles a tile of 16 output columns
    # (md 20 at s2 1 on any width); md 28 at s2 1 on a wide map is refused
    wide = torch.randn((1, 8, 4, 100), device=dev)
    with pytest.raises(RuntimeError):
        correlation_cuda(wide, wide, 28, 1)


# ---------------------------------------------------------------------------
# K2: correlation backward

K2_CASES = [
    ((8, 256, 32, 32), 20, 2),   # FlowNetC at 256²
    ((2, 64, 16, 20), 4, 1),     # PWC's configuration
    ((1, 40, 9, 37), 20, 2),     # ragged column tile and channel chunk
    ((1, 70, 12, 45), 20, 1),    # K = 41: more shared memory than 48 KB
    ((2, 64, 64, 64), 4, 1),     # PWC at a width of two column tiles
    ((1, 32, 16, 80), 20, 2),    # three column tiles, windows clipped at both ends
    # PWC's five levels at 256², batch 8
    ((8, 196, 4, 4), 4, 1),
    ((8, 128, 8, 8), 4, 1),
    ((8, 96, 16, 16), 4, 1),
    ((8, 64, 32, 32), 4, 1),
    ((8, 32, 64, 64), 4, 1),
]


def _k2_inputs(dev, shape, md, s2, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    f1 = torch.randn(shape, device=dev, generator=g)
    f2 = torch.randn(shape, device=dev, generator=g)
    k = 2 * (md // s2) + 1
    grad = torch.randn((shape[0], k * k, *shape[2:]), device=dev, generator=g)
    return f1, f2, grad


@pytest.mark.parametrize("shape,md,s2", K2_CASES)
def test_correlation_backward_fp32_matches_plain(dev, shape, md, s2):
    f1, f2, grad = _k2_inputs(dev, shape, md, s2, 5)
    got = correlation_bwd_cuda(f1, f2, grad, md, s2)
    want = correlation_bwd_reference(f1, f2, grad, md, s2)
    torch.cuda.synchronize()
    # fp32 sums of up to K² unit products in another order, over C (the
    # products in three TF32 passes, each good to ~2^-22 of its size)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,md,s2", K2_CASES)
def test_correlation_backward_bf16_matches_plain(dev, shape, md, s2, gdtype):
    f1, f2, grad = _k2_inputs(dev, shape, md, s2, 6)
    f1, f2, grad = f1.bfloat16(), f2.bfloat16(), grad.to(gdtype)
    got = correlation_bwd_cuda(f1, f2, grad, md, s2)
    want = correlation_bwd_reference(f1, f2, grad, md, s2)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        # one bf16 rounding of fp32 sums taken in another order (whose own
        # difference reaches ~1e-6 on sums of 441 unit products)
        _bf16_close(a, b, atol=1e-5)


def test_correlation_autograd_runs_k2(dev):
    g = torch.Generator(device=dev).manual_seed(7)
    f1 = torch.randn((2, 16, 8, 8), device=dev, generator=g).requires_grad_()
    f2 = torch.randn((2, 16, 8, 8), device=dev, generator=g).requires_grad_()
    before = correlation_bwd_cuda.launches
    out = correlation(f1, f2, 2, 1)
    (out * out).sum().backward()
    assert correlation_bwd_cuda.launches == before + 1
    want = correlation_bwd_reference(f1.detach(), f2.detach(), 2 * out.detach(), 2, 1)
    torch.testing.assert_close(f1.grad, want[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(f2.grad, want[1], atol=1e-5, rtol=1e-5)


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


def _offset_view(t):
    """A contiguous copy of ``t`` one element into its storage: 4 bytes past
    an 8-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,scale,offset", [
    ((8, 1, 256, 256), 0.7, False),   # the eval path's shape: float2 rows
    ((2, 3, 37, 53), 20.0, False),    # C = 3, odd W, odd P
    ((1, 1, 5, 3), 2.0, False),       # P = 15: the last thread's row is 1 long
    ((8, 1, 256, 256), 0.7, True),    # rows 4 bytes off an 8-byte boundary
    ((2, 3, 37, 53), 20.0, True),
], ids=["float2", "c3-odd-w-tail", "short-tail", "offset1", "offset1-c3"])
def test_warp_k3_equals_plain_and_k4_at_any_alignment(dev, dtype, shape, scale, offset):
    b, c, h, w = shape
    g = torch.Generator(device=dev).manual_seed(13)
    img = torch.rand(shape, device=dev, generator=g).to(dtype)
    px, py = _positions(dev, b, h, w, scale=scale, seed=14)
    if offset:
        px, py = _offset_view(px), _offset_view(py)
        assert px.storage_offset() == 1 and px.is_contiguous()
    got = sample2d_cuda(img, px, py)
    want = sample2d_gather(img.float(), px, py).reshape(b, c, -1)
    grad = torch.randn((b, c, px.shape[1]), device=dev, generator=g)
    dpos = sample2d_dpos_cuda(grad, img, px, py)
    torch.cuda.synchronize()
    # the same roundings in the same order whatever the load path
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # K4 reads the same positions (rows of any alignment) one at a time
    _assert_dpos_close(dpos, grad, img, px, py)


def test_warp_non_finite_positions_give_zero(dev):
    img = torch.ones((1, 1, 4, 4), device=dev)
    px = torch.tensor([[float("nan"), float("inf"), -1e30, 1.5]], device=dev)
    py = torch.tensor([[0.0, 0.0, 0.0, 1e30]], device=dev)
    out = sample2d_cuda(img, px, py)
    assert torch.equal(out, torch.zeros_like(out))
    # K4: a position with no tap in the image gets 0, NaN fractions too
    for dtype in (torch.float32, torch.bfloat16):
        dpos = sample2d_dpos_cuda(torch.ones((1, 3, 4), device=dev),
                                  img.expand(1, 3, 4, 4).contiguous().to(dtype), px, py)
        for t in dpos:
            assert torch.equal(t, torch.zeros_like(t))


def test_warp_dispatch_launches_kernel_and_casts(dev):
    img = torch.rand((2, 1, 8, 8), device=dev).bfloat16()
    px = torch.rand((2, 5, 5), device=dev) * 8
    before = sample2d_cuda.launches
    out = sample2d(img, px, px)
    assert sample2d_cuda.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (2, 1, 5, 5)
    with pytest.raises(TypeError):
        sample2d(img.half(), px, px)


# ---------------------------------------------------------------------------
# K4: the positions' cotangent Σ_c g·∂out/∂p; K5: the image cotangent

WARP_GRAD_CASES = [((8, 1, 256, 256), 60.0), ((8, 1, 256, 256), 0.7),
                   ((2, 3, 37, 53), 20.0)]


def _assert_dpos_close(dpos, grad, img, px, py):
    """K4 against its plain version. Each channel's basis is the same
    differences of tap values, associated otherwise than autograd's chain
    (and contracted to fused multiply-adds): a few fp32 roundings, within
    1e-6 abs + 1e-5 rel of the basis; the contraction weights channel c's by
    |g_c|. So |K4 - plain| <= Σ_c |g_c| (1e-6 + 1e-5 |basis_c|) at each
    position (the fp32 contraction's own roundings sit inside 1e-5 rel)."""
    want = sample2d_dpos_reference(grad, img, px, py)
    _, *bases = sample2d_taps_reference(img, px, py)
    torch.cuda.synchronize()
    for k, r, base in zip(dpos, want, bases):
        assert k.dtype == torch.float32 and k.shape == px.shape
        tol = (grad.abs() * (1e-6 + 1e-5 * base.abs())).sum(1)
        assert bool(((k - r).abs() <= tol).all()), float((k - r).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,scale", WARP_GRAD_CASES)
def test_warp_taps_matches_k3_and_plain(dev, dtype, shape, scale):
    """K4 (the positions' cotangent from the image's taps) against its plain
    version at scattered (often out-of-image), smooth and C = 3 positions,
    with far-away and non-finite positions mixed in; K3's sample at the
    same positions is the plain one, to the last bit."""
    b, c, h, w = shape
    g = torch.Generator(device=dev).manual_seed(8)
    img = torch.rand(shape, device=dev, generator=g).to(dtype)
    px, py = _positions(dev, b, h, w, scale=scale, seed=9)
    torch.testing.assert_close(sample2d_cuda(img, px, py),
                               sample2d_gather(img.float(), px, py), atol=0, rtol=0)
    grad = torch.randn((b, c, h * w), device=dev, generator=g)
    dpos = sample2d_dpos_cuda(grad, img, px, py)
    _assert_dpos_close(dpos, grad, img, px, py)
    # far-away and non-finite positions give 0, the rest stays as it was
    far = px.clone(), py.clone()
    far[0][:, :4] = torch.tensor([1e30, -1e30, float("nan"), float("inf")], device=dev)
    far[1][:, 4:6] = torch.tensor([float("-inf"), 1e30], device=dev)
    fx, fy = sample2d_dpos_cuda(grad, img, *far)
    torch.cuda.synchronize()
    for t, k in ((fx, dpos[0]), (fy, dpos[1])):
        assert torch.equal(t[:, :6], torch.zeros_like(t[:, :6]))
        assert torch.equal(t[:, 6:], k[:, 6:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,scale", WARP_GRAD_CASES)
def test_warp_dimg_matches_plain(dev, dtype, shape, scale):
    b, c, h, w = shape
    g = torch.Generator(device=dev).manual_seed(10)
    px, py = _positions(dev, b, h, w, scale=scale, seed=11)
    grad = torch.randn((b, c, h * w), device=dev, generator=g)
    got = sample2d_dimg_cuda(grad, px, py, shape, dtype)
    want = sample2d_dimg_reference(grad, px, py, shape, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    if dtype == torch.float32:
        # fp32 sums of the same products, added by atomics in an order that
        # changes from run to run: a few roundings of sums of order 1-10
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        _bf16_close(got, want, atol=1e-5)


def _smooth_flow(dev, b, h, w, amp, seed):
    """A smooth displacement [B, 2, h, w] of about ``amp`` px (bicubic
    upsampling of noise on a grid 16 times coarser)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    coarse = torch.randn((b, 2, max(h // 16, 2), max(w // 16, 2)), device=dev,
                         generator=g) * amp
    return torch.nn.functional.interpolate(coarse, size=(h, w), mode="bicubic",
                                           align_corners=True)


def _smooth_positions(dev, b, h, w, amp, seed):
    """The pixel grid plus ``_smooth_flow``."""
    flow = _smooth_flow(dev, b, h, w, amp, seed)
    px = torch.arange(w, device=dev, dtype=torch.float32) + flow[:, 0]
    py = torch.arange(h, device=dev, dtype=torch.float32)[:, None] + flow[:, 1]
    return px.reshape(b, -1).contiguous(), py.reshape(b, -1).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,layout", [
    ((1, 2, 256, 256), "smooth"),      # SyN's compose of a 2-channel field
    ((8, 32, 64, 64), "smooth"),       # PWC's level-2 feature warp
    ((2, 3, 40, 70), "identity"),      # every position on its pixel
    ((2, 3, 40, 70), "subpixel"),      # a uniform sub-pixel shift
    ((2, 3, 64, 64), "permuted"),      # smooth positions in a random order
    ((512, 1, 16, 16), "P=81"),        # RAFT's lookups: P != H * W
])
def test_warp_dimg_any_layout_matches_plain(dev, dtype, shape, layout):
    b, c, h, w = shape
    px, py = _smooth_positions(dev, b, h, w, 2.0, seed=15)
    if layout == "identity":
        base = torch.arange(h * w, device=dev)
        px = (base % w).float().expand(b, -1).contiguous()
        py = (base // w).float().expand(b, -1).contiguous()
    elif layout == "subpixel":
        base = torch.arange(h * w, device=dev)
        px = ((base % w).float() + 0.3).expand(b, -1).contiguous()
        py = ((base // w).float() - 0.6).expand(b, -1).contiguous()
    elif layout == "permuted":
        perm = torch.randperm(h * w, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(16))
        px, py = px[:, perm].contiguous(), py[:, perm].contiguous()
    elif layout == "P=81":
        px, py = px[:, :81].contiguous(), py[:, :81].contiguous()
    grad = torch.randn((b, c, px.shape[1]), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(17))
    got = sample2d_dimg_cuda(grad, px, py, shape, dtype)
    want = sample2d_dimg_reference(grad, px, py, shape, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    if dtype == torch.float32:
        # fp32 sums of the same products, merged in registers and added by
        # atomics in an order that changes from run to run
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        _bf16_close(got, want, atol=1e-5)


def _lookup_positions(dev, b, h, w, seed):
    """RAFT's lookup positions [B, 81]: a centre a map, uniform over the map
    and 2 px past each border, plus the offsets -4..4 in x and y, dy-major,
    so that many taps fall outside."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cx = torch.rand((b, 1), device=dev, generator=g) * (w + 3) - 2
    cy = torch.rand((b, 1), device=dev, generator=g) * (h + 3) - 2
    d = torch.arange(-4, 5, device=dev, dtype=torch.float32)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return ((cx + dx.reshape(1, -1)).contiguous(),
            (cy + dy.reshape(1, -1)).contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,layout", [(65536, "P=81"), (65537, "P=81"),
                                      (65537, "grid")])
def test_warp_kernels_take_any_batch(dev, dtype, b, layout):
    """K3, K4 and K5 over more batch rows than the grid's y axis holds
    (65535), which they launch in chunks of rows: one-channel 4 x 4 maps at
    RAFT's 81 lookup positions (65536 is RAFT's lookup at batch 16, 256²)
    and at the pixel grid plus noise (P = H·W, K5's other layout). K3 equals
    the plain gather, K4 and K5 agree with theirs at the tolerances above,
    and the rows of the last chunk give what a launch of them alone gives."""
    shape = (b, 1, 4, 4)
    g = torch.Generator(device=dev).manual_seed(b)
    img = torch.rand(shape, device=dev, generator=g).to(dtype)
    if layout == "grid":
        px, py = _positions(dev, b, 4, 4, scale=1.5, seed=18)
    else:
        px, py = _lookup_positions(dev, b, 4, 4, seed=18)
    got = sample2d_cuda(img, px, py)
    torch.testing.assert_close(got, sample2d_gather(img.float(), px, py), atol=0, rtol=0)
    grad = torch.randn((b, 1, px.shape[1]), device=dev, generator=g)
    dpos = sample2d_dpos_cuda(grad, img, px, py)
    _assert_dpos_close(dpos, grad, img, px, py)
    dimg = sample2d_dimg_cuda(grad, px, py, shape, dtype)
    want = sample2d_dimg_reference(grad, px, py, shape, dtype)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(dimg, want, atol=1e-5, rtol=1e-5)
    else:
        _bf16_close(dimg, want, atol=1e-5)
    tail = slice(65530, b)
    part = [t[tail].contiguous() for t in (img, px, py, grad)]
    assert torch.equal(got[tail], sample2d_cuda(*part[:3]))
    for k, alone in zip(dpos, sample2d_dpos_cuda(part[3], *part[:3])):
        assert torch.equal(k[tail], alone)


def test_warp_autograd_runs_k4_and_k5(dev):
    g = torch.Generator(device=dev).manual_seed(12)
    img = torch.rand((2, 3, 16, 24), device=dev, generator=g).requires_grad_()
    flow = (torch.randn((2, 2, 16, 24), device=dev, generator=g) * 3
            ).requires_grad_()
    px = torch.arange(24, device=dev, dtype=torch.float32) + flow[:, 0]
    py = torch.arange(16, device=dev, dtype=torch.float32)[:, None] + flow[:, 1]
    counts = (sample2d_cuda.launches, sample2d_dpos_cuda.launches,
              sample2d_dimg_cuda.launches)
    out = sample2d(img, px, py)
    (out.sin()).sum().backward()
    # K3 forward; K4 and K5 backward
    assert (sample2d_cuda.launches, sample2d_dpos_cuda.launches,
            sample2d_dimg_cuda.launches) == (counts[0] + 1, counts[1] + 1,
                                             counts[2] + 1)
    img2 = img.detach().requires_grad_()
    flow2 = flow.detach().requires_grad_()
    px2 = torch.arange(24, device=dev, dtype=torch.float32) + flow2[:, 0]
    py2 = torch.arange(16, device=dev, dtype=torch.float32)[:, None] + flow2[:, 1]
    sample2d_gather(img2, px2, py2).sin().sum().backward()
    torch.testing.assert_close(img.grad, img2.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(flow.grad, flow2.grad, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 2, 64, 64), (1, 2, 256, 256)])
def test_warp_k4_and_k5_at_syn_compositions(dev, shape):
    """SyN's composition of a 2-channel field with itself: at the
    optimisation level of (10, 0, 0) on 256² (64²) and at full size."""
    b, c, h, w = shape
    g = torch.Generator(device=dev).manual_seed(27)
    field = torch.randn(shape, device=dev, generator=g) * 2.0
    px, py = _smooth_positions(dev, b, h, w, 2.0, seed=28)
    out = sample2d_cuda(field, px, py)
    want = sample2d_gather(field, px, py)
    grad = torch.randn((b, c, h * w), device=dev, generator=g)
    dpos = sample2d_dpos_cuda(grad, field, px, py)
    dimg = sample2d_dimg_cuda(grad, px, py, shape)
    dimg_want = sample2d_dimg_reference(grad, px, py, shape)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    # the bases: a few fp32 roundings of differences of values of order 2
    _assert_dpos_close(dpos, grad, field, px, py)
    # fp32 sums by atomics in an order that changes from run to run
    torch.testing.assert_close(dimg, dimg_want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 128, 8, 8), (8, 96, 16, 16),
                                   (8, 64, 32, 32), (8, 32, 64, 64)])
def test_warp_kernels_at_pwc_feature_warps(dev, dtype, shape):
    """PWC's four feature warps at 256², batch 8, at the "pwc" positions of
    a smooth flow, (flow + xy)·size/(size - 1) - 0.5: K3's sample the plain
    one to the last bit, K4 and K5 as in the tests above (W = 8 and 16 take
    K3's and K5's ragged paths; K4 splits C = 32-128 over 4-32 warps)."""
    b, c, h, w = shape
    flow = _smooth_flow(dev, b, h, w, 2.0, seed=30)
    px = (torch.arange(w, device=dev) + flow[:, 0]) * (w / (w - 1)) - 0.5
    py = (torch.arange(h, device=dev)[:, None] + flow[:, 1]) * (h / (h - 1)) - 0.5
    px, py = px.reshape(b, -1).contiguous(), py.reshape(b, -1).contiguous()
    g = torch.Generator(device=dev).manual_seed(31)
    img = torch.rand(shape, device=dev, generator=g).to(dtype)
    want = sample2d_gather(img.float(), px, py)
    k3 = sample2d_cuda(img, px, py)
    grad = torch.randn((b, c, h * w), device=dev, generator=g)
    dpos = sample2d_dpos_cuda(grad, img, px, py)
    dimg = sample2d_dimg_cuda(grad, px, py, shape, dtype)
    dimg_want = sample2d_dimg_reference(grad, px, py, shape, dtype)
    torch.cuda.synchronize()
    torch.testing.assert_close(k3, want, atol=0, rtol=0)
    _assert_dpos_close(dpos, grad, img, px, py)
    if dtype == torch.float32:
        torch.testing.assert_close(dimg, dimg_want, atol=1e-5, rtol=1e-5)
    else:
        _bf16_close(dimg, dimg_want, atol=1e-5)


@pytest.mark.parametrize("threshold", [0.9999, 0.999])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pwc_warp_samples_its_mask_on_k3(dev, dtype, threshold):
    """The "pwc" warp through autograd on the card: the features' sample and
    the mask's ones image (its positions detached) on K3, in the features'
    dtype; the features' cotangents on K4 (positions) and K5 (image); output,
    mask and both cotangents agree with the CPU's plain path (masks
    equal)."""
    g = torch.Generator(device=dev).manual_seed(32)
    img = torch.rand((2, 32, 16, 16), device=dev, generator=g).to(dtype)
    flow = _smooth_flow(dev, 2, 16, 16, 2.0, seed=33)
    cot = torch.randn((2, 32, 16, 16), device=dev, generator=g)
    counts = lambda: (sample2d_cuda.launches, sample2d_dpos_cuda.launches,
                      sample2d_dimg_cuda.launches)
    before = counts()
    x, f = img.clone().requires_grad_(), flow.clone().requires_grad_()
    out, mask = warp2d(x, f, "pwc", return_mask=True, mask_threshold=threshold)
    assert mask.dtype == dtype and mask.grad_fn is None
    gx, gf = torch.autograd.grad(out, (x, f), cot.to(dtype))
    torch.cuda.synchronize()
    assert counts() == (before[0] + 2, before[1] + 1, before[2] + 1)
    xc, fc = img.cpu().requires_grad_(), flow.cpu().requires_grad_()
    oc, mc = warp2d(xc, fc, "pwc", return_mask=True, mask_threshold=threshold)
    gxc, gfc = torch.autograd.grad(oc, (xc, fc), cot.cpu().to(dtype))
    assert torch.equal(mask.cpu(), mc)
    tol = {"atol": 1e-5, "rtol": 1e-5} if dtype == torch.float32 else \
        {"atol": 1e-2, "rtol": 1e-2}
    torch.testing.assert_close(out.cpu().float(), oc.float(), **tol)
    torch.testing.assert_close(gx.cpu().float(), gxc.float(), **tol)
    torch.testing.assert_close(gf.cpu().float(), gfc.float(), **tol)


def test_syn_compose_autograd_runs_k4_and_k5_once(dev):
    """classical/syn.py's _compose(flow, flow), as scaling and squaring calls
    it: the sample's positions and the sampled field both come from the one
    field, so one forward launches K3 and its backward K4 and K5; both
    cotangents reach the field and agree with the plain path's."""
    g = torch.Generator(device=dev).manual_seed(29)
    coarse = torch.randn((1, 2, 8, 8), device=dev, generator=g) * 3.0
    flow = torch.nn.functional.interpolate(coarse, size=(64, 64), mode="bicubic",
                                           align_corners=True).requires_grad_()
    weights = torch.randn((1, 2, 64, 64), device=dev, generator=g)
    counts = lambda: (sample2d_cuda.launches, sample2d_dpos_cuda.launches,
                      sample2d_dimg_cuda.launches)
    before = counts()
    out = _compose(flow, flow)
    (out * weights).sum().backward()
    assert tuple(n - m for n, m in zip(counts(), before)) == (1, 1, 1)
    flow_cpu = flow.detach().cpu().requires_grad_()
    want = _compose(flow_cpu, flow_cpu)
    (want * weights.cpu()).sum().backward()
    torch.testing.assert_close(out.detach().cpu(), want.detach(), atol=0, rtol=0)
    # the image cotangent's atomics and the bases' association: fp32
    # roundings of sums of order 1-10
    torch.testing.assert_close(flow.grad.cpu(), flow_cpu.grad, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(8, 1, 256, 256), (8, 128, 8, 8), (8, 32, 64, 64)])
def test_warp_k4_repeats_bit_for_bit(dev, shape):
    """K4 adds its channels' products in a fixed order (no atomics): two
    launches give the same dpx and dpy, bit for bit, where one warp takes
    every channel (C = 1) and where 4 or 32 warps split them."""
    b, c, h, w = shape
    g = torch.Generator(device=dev).manual_seed(34)
    img = torch.rand(shape, device=dev, generator=g)
    px, py = _smooth_positions(dev, b, h, w, 2.0, seed=35)
    grad = torch.randn((b, c, h * w), device=dev, generator=g)
    first = [t.clone() for t in sample2d_dpos_cuda(grad, img, px, py)]
    second = sample2d_dpos_cuda(grad, img, px, py)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("need_img", [False, True], ids=["positions", "both"])
def test_warp_node_saves_no_per_channel_tensor(dev, need_img):
    """What the 2-D node keeps for its backward: the image (K4 gathers its
    taps again) and the positions, nothing [B, C, P]; counted in bytes by
    ``saved_tensors_hooks``, at PWC's level-4 feature warp."""
    b, c, h, w = 8, 96, 16, 16
    g = torch.Generator(device=dev).manual_seed(36)
    img = torch.rand((b, c, h, w), device=dev, generator=g).requires_grad_(need_img)
    flow = (torch.randn((b, 2, h, w), device=dev, generator=g) * 2).requires_grad_()
    px = torch.arange(w, device=dev, dtype=torch.float32) + flow[:, 0]
    py = torch.arange(h, device=dev, dtype=torch.float32)[:, None] + flow[:, 1]
    px, py = px.reshape(b, -1).contiguous(), py.reshape(b, -1).contiguous()
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = torch.ops.tpureg.sample2d(img, px, py)
    # two fp32 bases [B, C, P] beside the positions would exceed this bound
    assert 0 < sum(saved) <= img.numel() * img.element_size() + 2 * px.numel() * 4
    out.sum().backward()
    assert flow.grad is not None and bool(torch.isfinite(flow.grad).all())


# ---------------------------------------------------------------------------
# K6a, K6b, K6c: the trilinear 3-D warp, its bases and its volume cotangent

def _positions3d(dev, b, d, h, w, scale, seed, dz=0.0):
    """Positions at the voxel grid plus N(0, scale²) displacements (and a
    uniform z shift ``dz``), [B, P] each."""
    g = torch.Generator(device=dev).manual_seed(seed)
    flow = torch.randn((b, 3, d, h, w), device=dev, generator=g) * scale
    zz, yy, xx = torch.meshgrid(*(torch.arange(n, device=dev, dtype=torch.float32)
                                  for n in (d, h, w)), indexing="ij")
    pos = (xx + flow[:, 0], yy + flow[:, 1], zz + flow[:, 2] + dz)
    return [p.reshape(b, -1).contiguous() for p in pos]


def _rearrange3d(pos, mode, seed):
    """K6c's position layouts: "grid" as made; "outliers", every 97th
    position moved up to 40 voxels away, so that some bricks' corners
    overflow K6c's shared-memory window and others do not; "permuted", one
    random order of the positions (P = D·H·W, but no brick is compact);
    "prefix", the positions without their last 37 (P ≠ D·H·W)."""
    dev = pos[0].device
    g = torch.Generator(device=dev).manual_seed(seed)
    if mode == "outliers":
        far = torch.zeros_like(pos[0], dtype=torch.bool)
        far[:, ::97] = True
        return [torch.where(far, p + (torch.rand(p.shape, device=dev, generator=g) - 0.5)
                            * 80, p).contiguous() for p in pos]
    if mode == "permuted":
        order = torch.randperm(pos[0].shape[1], device=dev, generator=g)
        return [p[:, order].contiguous() for p in pos]
    if mode == "prefix":
        return [p[:, :-37].contiguous() for p in pos]
    return pos


# (shape, displacement std, uniform z shift, position layout): the final
# warp's volume at a reduced size, a composition's 3-channel field, fault
# C1's configuration (d = 32, dz = ±8.5), scattered positions far beyond any
# TPU window, K6c's layouts (sub-voxel displacements, whose merged sums go
# straight to global atomics; ragged bricks at C = 1 and 3; outliers;
# permuted positions; P ≠ D·H·W), and more batch rows than one launch's
# grid holds (65535)
WARP3D_CASES = [((2, 1, 44, 64, 64), 0.7, 0.0, "grid"),
                ((2, 3, 22, 32, 32), 0.5, 0.0, "grid"),
                ((1, 1, 32, 64, 64), 0.3, -8.5, "grid"),
                ((1, 1, 32, 64, 64), 0.3, 8.5, "grid"),
                ((2, 3, 13, 17, 19), 12.0, 0.0, "grid"),
                ((2, 3, 22, 32, 32), 0.05, 0.0, "grid"),
                ((2, 1, 13, 17, 19), 0.4, 0.0, "grid"),
                ((2, 3, 11, 20, 36), 0.5, 0.0, "grid"),
                ((2, 3, 22, 32, 32), 0.5, 0.0, "outliers"),
                ((1, 3, 16, 24, 40), 0.5, 0.0, "permuted"),
                ((2, 3, 11, 20, 36), 0.5, 0.0, "prefix"),
                ((65536, 1, 2, 2, 2), 0.5, 0.0, "grid")]
WARP3D_IDS = ["final", "composition", "c1-neg", "c1-pos", "scattered", "sub-voxel",
              "ragged-c1", "ragged-c3", "outliers", "permuted", "prefix", "batch-65536"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,scale,dz,mode", WARP3D_CASES, ids=WARP3D_IDS)
def test_warp3d_kernels_match_plain(dev, dtype, shape, scale, dz, mode):
    b, c, d, h, w = shape
    g = torch.Generator(device=dev).manual_seed(20)
    vol = torch.rand(shape, device=dev, generator=g).to(dtype)
    px, py, pz = _rearrange3d(_positions3d(dev, b, d, h, w, scale, 21, dz), mode, 27)
    got = sample3d_cuda(vol, px, py, pz)
    want = sample3d_gather(vol.float(), px, py, pz)
    torch.cuda.synchronize()
    # K6a: the plain version's roundings in its order
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    grad = torch.randn((b, c, px.shape[1]), device=dev, generator=g)
    dpos = sample3d_dpos_cuda(grad, vol, px, py, pz)
    ref = sample3d_dpos_reference(grad, vol, px, py, pz)
    torch.cuda.synchronize()
    # K6b: the bases are the same products of corner values, summed as
    # tpureg's _gather_taps sums them and not as autograd's chain does, and
    # contracted with g in channel order; a bf16 volume's values are exact in
    # fp32, so both dtypes take the same tolerance
    for k, r in zip(dpos, ref):
        assert k.shape == (b, px.shape[1])
        torch.testing.assert_close(k, r, atol=1e-6, rtol=1e-5)
    dvol = sample3d_dvol_cuda(grad, px, py, pz, shape, dtype)
    dref = sample3d_dvol_reference(grad, px, py, pz, shape, dtype)
    torch.cuda.synchronize()
    assert dvol.dtype == dtype
    if dtype == torch.float32:
        # the same products added by atomics in an order that changes from
        # run to run: fp32 roundings of sums of order 1-10
        torch.testing.assert_close(dvol, dref, atol=1e-5, rtol=1e-5)
    else:
        _bf16_close(dvol, dref, atol=1e-5)


def test_warp3d_non_finite_positions_give_zero(dev):
    vol = torch.ones((1, 2, 3, 4, 4), device=dev)
    px = torch.tensor([[float("nan"), float("inf"), -1e30, 1.5]], device=dev)
    py = torch.tensor([[0.0, 0.0, 0.0, 1e30]], device=dev)
    out = sample3d_cuda(vol, px, py, py.clone())
    assert torch.equal(out, torch.zeros_like(out))
    # K6b: a corner outside the volume is skipped, so NaN fractions give 0
    for dtype in (torch.float32, torch.bfloat16):
        dpos = sample3d_dpos_cuda(torch.ones((1, 2, 4), device=dev), vol.to(dtype),
                                  px, py, py.clone())
        for t in dpos:
            assert torch.equal(t, torch.zeros_like(t))


def test_warp3d_dispatch_counts_and_refusals(dev):
    g = torch.Generator(device=dev).manual_seed(22)
    vol = torch.rand((2, 3, 6, 8, 10), device=dev, generator=g)
    flow = (torch.randn((2, 3, 6, 8, 10), device=dev, generator=g) * 1.5)
    counts = lambda: (sample3d_cuda.launches, sample3d_dpos_cuda.launches,
                      sample3d_dvol_cuda.launches)
    before = counts()
    with torch.no_grad():
        warp3d(vol, flow)
    assert counts() == (before[0] + 1, before[1], before[2])
    f = flow.clone().requires_grad_()
    warp3d(f, f).square().sum().backward()  # a composition: field and positions
    assert counts() == (before[0] + 2, before[1] + 1, before[2] + 1)
    f2 = flow.clone().requires_grad_()
    warp3d(vol, f2).sum().backward()        # the final warp: positions only
    assert counts() == (before[0] + 3, before[1] + 2, before[2] + 1)
    out = sample3d(vol.bfloat16(), *(t.reshape(2, 6, 8, 10) for t in
                                     _positions3d(dev, 2, 6, 8, 10, 1.0, 23)))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3, 6, 8, 10)
    with pytest.raises(TypeError):
        sample3d(vol.half(), vol[:, 0], vol[:, 0], vol[:, 0])
    with pytest.raises(ValueError):
        sample3d_cuda(vol, *(t[:, ::2] for t in _positions3d(dev, 2, 6, 8, 10, 1.0, 24)))
    with pytest.raises(ValueError):  # the cotangent must be [B, C, P]
        sample3d_dpos_cuda(torch.zeros((2, 1, 480), device=dev), vol,
                           *_positions3d(dev, 2, 6, 8, 10, 1.0, 24))


def test_warp3d_deform_integration_launches(dev):
    """VoxelMorph3D's warps at a small size: 7 scaling-and-squaring
    compositions and the final warp each run K6a forward and K6b backward;
    the compositions' warped fields also run K6c."""
    g = torch.Generator(device=dev).manual_seed(26)
    v = (torch.randn((1, 3, 6, 8, 10), device=dev, generator=g) * 2).requires_grad_()
    moving = torch.rand((1, 1, 6, 8, 10), device=dev, generator=g)
    counts = lambda: (sample3d_cuda.launches, sample3d_dpos_cuda.launches,
                      sample3d_dvol_cuda.launches)
    before = counts()
    warp3d(moving, exp_velocity3d(v, 7)).square().sum().backward()
    assert tuple(n - m for n, m in zip(counts(), before)) == (8, 8, 7)
    assert bool(torch.isfinite(v.grad).all())
    v_cpu = v.detach().cpu().requires_grad_()
    warp3d(moving.cpu(), exp_velocity3d(v_cpu, 7)).square().sum().backward()
    # seven compositions, each summing in another order on the card
    torch.testing.assert_close(v.grad.cpu(), v_cpu.grad, atol=1e-5, rtol=1e-4)


def test_warp3d_slabs_match_whole_volume(dev):
    """The spatially sharded composition at its full-width shape, (2, 3, 88,
    128, 128), H split in two slabs, run in one process by slicing: each
    slab's warp of the whole field at its global rows (``h_offset``) gives
    that slab of the whole-volume warp (K6a, to the bit), its positions'
    cotangent that slab of the whole's (K6b), and the two slabs' field
    cotangents summed, as the gather's backward sums them over the ranks,
    the whole's (K6c, atomics in another order)."""
    g = torch.Generator(device=dev).manual_seed(28)
    shape = (2, 3, 88, 128, 128)
    field = (torch.randn(shape, device=dev, generator=g) * 0.5).requires_grad_()
    cot = torch.randn(shape, device=dev, generator=g)
    whole = warp3d(field, field)
    (dfield_whole,) = torch.autograd.grad((whole * cot).sum(), field)
    counts = lambda: (sample3d_cuda.launches, sample3d_dpos_cuda.launches,
                      sample3d_dvol_cuda.launches)
    before = counts()
    vol = field.detach().requires_grad_()   # the gathered field
    slabs = [field.detach()[:, :, :, r * 64:(r + 1) * 64].clone().requires_grad_()
             for r in range(2)]
    outs = [warp3d(vol, f, h_offset=r * 64) for r, f in enumerate(slabs)]
    grads = torch.autograd.grad(
        sum((o * cot[:, :, :, r * 64:(r + 1) * 64]).sum() for r, o in enumerate(outs)),
        [vol, *slabs])
    torch.cuda.synchronize()
    assert tuple(n - m for n, m in zip(counts(), before)) == (2, 2, 2)
    torch.testing.assert_close(torch.cat(outs, 3), whole.detach(), atol=0, rtol=0)
    # the field's cotangent: its own positions' rows (K6b, on the slab) plus
    # the sample's cotangent into the whole field (K6c)
    got = grads[0] + torch.cat(grads[1:], 3)
    torch.testing.assert_close(got, dfield_whole, atol=1e-5, rtol=1e-5)


def test_warp3d_kernel_gradients_against_fp64_differences(dev):
    """gradcheck's test of the op tpureg::sample3d: its analytic gradients (fp32
    kernels on the card) against central differences of the plain version
    in fp64, at positions at least 0.05 from a voxel plane (the trilinear
    sample is smooth between them)."""
    g = torch.Generator(device=dev).manual_seed(25)
    b, c, d, h, w = 1, 2, 4, 5, 6
    vol = torch.rand((b, c, d, h, w), device=dev, generator=g, dtype=torch.float64)
    pos = [torch.rand((b, 7), device=dev, generator=g, dtype=torch.float64)
           * (n + 1) - 1.0 for n in (w, h, d)]
    pos = [torch.floor(p) + 0.05 + 0.9 * (p - torch.floor(p)) for p in pos]
    weights = torch.randn((b, c, 7), device=dev, generator=g, dtype=torch.float64)

    def plain(v, x, y, z):
        return (sample3d_gather(v, x, y, z) * weights).sum()

    args = [vol.float().requires_grad_()] + [p.float().requires_grad_() for p in pos]
    (torch.ops.tpureg.sample3d(*args) * weights.float()).sum().backward()
    eps = 1e-6
    inputs = [vol] + pos
    for i, (x, a) in enumerate(zip(inputs, args)):
        num = torch.zeros_like(x)
        flat = num.view(-1)
        for j in range(x.numel()):
            hi = [t.clone() for t in inputs]
            lo = [t.clone() for t in inputs]
            hi[i].view(-1)[j] += eps
            lo[i].view(-1)[j] -= eps
            flat[j] = (plain(*hi) - plain(*lo)) / (2 * eps)
        # fp32 kernels against fp64 differences: fp32 roundings of O(1) values
        torch.testing.assert_close(a.grad.double(), num, atol=1e-5, rtol=1e-4)
    # and the plain version itself passes gradcheck in fp64
    assert torch.autograd.gradcheck(
        lambda v, x, y, z: sample3d_gather(v, x, y, z),
        [vol.requires_grad_()] + [p.requires_grad_() for p in pos])


# ---------------------------------------------------------------------------
# each kernel through its op (tpureg_torch/ops/library.py)

def _op_cases(dev, dtype):
    """Each op's operands at a shape of the main path: FlowNetC's correlation
    at 64², the stn warp of a 256² batch, PWC's level-3 feature warp, the
    deform step's 3-D warp at 16 x 64 x 64."""
    g = torch.Generator(device=dev).manual_seed(40)
    f1, f2 = (torch.randn((2, 256, 16, 16), device=dev, generator=g).to(dtype)
              for _ in range(2))
    kk = 21 * 21
    dcor = torch.randn((2, kk, 16, 16), device=dev, generator=g).to(dtype)
    px, py = _positions(dev, 8, 64, 64, scale=3.0, seed=41)
    img = torch.rand((8, 32, 64, 64), device=dev, generator=g).to(dtype)
    g2 = torch.randn((8, 32, px.shape[1]), device=dev, generator=g)
    vol = torch.rand((1, 3, 16, 64, 64), device=dev, generator=g).to(dtype)
    p3 = _positions3d(dev, 1, 16, 64, 64, 2.0, 42)
    g3 = torch.randn((1, 3, p3[0].shape[1]), device=dev, generator=g)
    return {
        "correlation": (f1, f2, 20, 2),
        "correlation_bwd": (f1, f2, dcor, 20, 2),
        "sample2d": (img, px, py),
        "sample2d_dpos": (g2, img, px, py),
        "sample2d_dimg": (g2, px, py, list(img.shape), dtype),
        "sample3d": (vol, *p3),
        "sample3d_dpos": (g3, vol, *p3),
        "sample3d_dvol": (g3, *p3, list(vol.shape), dtype),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,kernel", [(n, k) for n, k, _ in OPS])
def test_op_equals_its_launch_function(dev, name, kernel, dtype):
    """The op launches its kernel once, through its launch function, and
    gives that function's result bit for bit; K5 and K6c, whose atomics
    add in an order that changes from run to run, within their tolerance
    against the plain version (fp32 1e-5; bf16 one step)."""
    launch = dict((n, f) for n, _, f in OPS)[name]
    args = _op_cases(dev, dtype)[name]
    want = launch(*args)
    before = launch.launches
    got = getattr(torch.ops.tpureg, name)(*args)
    torch.cuda.synchronize()
    assert launch.launches == before + 1
    got, want = ((got,), (want,)) if isinstance(got, torch.Tensor) else (got, want)
    assert len(got) == len(want)
    for a, b_ in zip(got, want):
        assert a.dtype == b_.dtype and a.shape == b_.shape
        if kernel in ("K5", "K6c"):
            if dtype == torch.float32:
                torch.testing.assert_close(a, b_, atol=1e-5, rtol=1e-5)
            else:
                _bf16_close(a, b_, atol=1e-5)
        else:
            assert torch.equal(a, b_), kernel


# ---------------------------------------------------------------------------
# the data-parallel train step over an NCCL group of one


def test_dp_step_of_one_rank_equals_single_process_step(dev):
    """FlowNetC's data-parallel train step (``make_train_step(group=)``)
    over an NCCL group of one on the card, at 64², batch 4, fp32, against
    the single-process step from the same weights on the same batch, cuDNN
    deterministic: the all-reduces of one rank copy, so the metrics, the
    weights and the running statistics are equal to the bit, and the step
    launches the kernels the single-process step does."""
    import socket

    import torch.distributed as dist

    from tpureg_torch.reg import OpticalFlowReg
    from tpureg_torch.serving import deterministic_cudnn
    from tpureg_torch.train import create_train_state, make_train_step

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    imgs = torch.rand(4, 64, 64, 2, generator=torch.Generator().manual_seed(7)).to(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        out = []
        for group in (None, dist.group.WORLD):
            model = OpticalFlowReg("flownetc", generator=torch.Generator().manual_seed(5))
            state = create_train_state(model.to(dev))
            step = make_train_step(state, group=group)
            with deterministic_cudnn():
                torch.cuda.synchronize()
                before = {fn: fn.launches for _, _, fn in OPS}
                metrics = step(imgs)
                torch.cuda.synchronize()
            launches = {fn: fn.launches - before[fn] for _, _, fn in OPS}
            out.append((metrics, state.model.state_dict(), launches))
    finally:
        dist.destroy_process_group()
    (m1, sd1, l1), (m2, sd2, l2) = out
    assert l1 == l2 and l1[correlation_cuda] == 1 and l1[sample2d_cuda] > 0
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for k in sd1:
        assert torch.equal(sd1[k], sd2[k]), k
