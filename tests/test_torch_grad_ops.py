"""The functions of kernels K2, K4 and K5 (the correlation's and the warp's
gradients) in tpureg_torch against tpureg's on the CPU, and the BatchNorm
running statistics against flax's. K4 is the warp's positions' cotangent
``Σ_c g·∂out/∂p`` (``sample2d_dpos_reference``), the contraction of tpureg's
bases (``_fwd_taps_kernel``) with the cotangent.

On the CPU the port's gradients are autograd of its plain versions
(``correlation_reference``, ``sample2d_gather``), the very functions the card
kernels are held against in ``test_torch_kernels_gpu.py``. Here they are held
against ``jax.vjp`` of tpureg's references and against tpureg's Pallas
kernels run by the Pallas interpreter, as ``test_pallas_interpret.py`` runs
them. Inputs come from numpy; the port is NCHW, tpureg NHWC.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from tpureg.ops import correlation_pallas as cp
from tpureg.ops import warp_pallas as wp
from tpureg.ops.correlation import correlation_reference as jax_corr
from tpureg.ops.warp import sample2d_gather as jax_sample
from tpureg.ops.warp import sample2d_nearest as jax_nearest
from tpureg_torch.nn import BatchNorm2d, batch_norm
from tpureg_torch.ops import (
    correlation,
    correlation_bwd_reference,
    sample2d,
    sample2d_dimg_reference,
    sample2d_dpos_reference,
    sample2d_gather,
    sample2d_nearest,
    sample2d_taps_reference,
)

# fp32 sums of at most a few hundred unit-scale products, in another order
ATOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _corr_inputs(seed, shape, md, s2):
    rng = np.random.default_rng(seed)
    f1, f2 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    k = 2 * (md // s2) + 1
    g = rng.standard_normal((*shape[:3], k * k)).astype(np.float32)
    return f1, f2, g


def _port_corr_grads(f1, f2, g, md, s2):
    """The port's CPU route: autograd through ``correlation``."""
    a = _nchw(f1).requires_grad_()
    b = _nchw(f2).requires_grad_()
    correlation(a, b, md, s2).backward(_nchw(g))
    return _nhwc(a.grad), _nhwc(b.grad)


# ---------------------------------------------------------------------------
# K2: correlation backward

@pytest.mark.parametrize("shape,md,s2", [
    ((2, 12, 14, 16), 4, 1),    # PWC's configuration
    ((1, 16, 16, 24), 20, 2),   # FlowNetC's, displacements past every edge
    ((1, 9, 11, 5), 3, 2),      # md not a multiple of s2
])
def test_correlation_grads_match_jax_vjp(shape, md, s2):
    f1, f2, g = _corr_inputs(0, shape, md, s2)
    got = _port_corr_grads(f1, f2, g, md, s2)
    _, vjp = jax.vjp(lambda a, b: jax_corr(a, b, md, s2), jnp.asarray(f1),
                     jnp.asarray(f2))
    for a, b in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("force_split", [False, True], ids=["fused", "split"])
@pytest.mark.parametrize("md,s2", [(2, 1), (4, 2)])
def test_correlation_grads_match_pallas_interpret(md, s2, force_split):
    """Against tpureg's fused and split backward kernels (K2b, K2c)."""
    f1, f2, g = _corr_inputs(1, (1, 8, 128, 8), md, s2)
    want = cp._corr_bwd_pallas(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(g),
                               md, s2, interpret=True, force_split=force_split)
    for a, b in zip(_port_corr_grads(f1, f2, g, md, s2), want):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("c", [8, 160], ids=["one-slab", "multislab"])
def test_correlation_grads_match_banded_interpret(c):
    """Against tpureg's banded backward (K2a, the TPU's default), at
    HIGHEST precision for fp32 operands as the TPU path requests; C = 160
    exercises its channel-slab grid axis."""
    md, s2 = 2, 1
    f1, f2, g = _corr_inputs(2, (1, 8, 128, c), md, s2)
    want = cp._corr_bwd_banded(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(g),
                               md, s2, interpret=True,
                               precision=jax.lax.Precision.HIGHEST)
    for a, b in zip(_port_corr_grads(f1, f2, g, md, s2), want):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=0)


def test_correlation_grads_multislab_match_pallas_interpret():
    """C > 128 through the fused VPU kernel's slab axis too."""
    md, s2 = 2, 1
    f1, f2, g = _corr_inputs(3, (1, 8, 128, 160), md, s2)
    want = cp._corr_bwd_pallas(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(g),
                               md, s2, interpret=True)
    for a, b in zip(_port_corr_grads(f1, f2, g, md, s2), want):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=0)


def test_correlation_bwd_reference_is_the_cpu_route():
    """K2's plain version (what the card kernel is held against) is the CPU
    route's autograd; in bf16 it returns the operands' dtype, one rounding
    from the fp32 gradient."""
    f1, f2, g = _corr_inputs(4, (1, 6, 7, 12), 2, 1)
    want = _port_corr_grads(f1, f2, g, 2, 1)
    got = correlation_bwd_reference(_nchw(f1), _nchw(f2), _nchw(g), 2, 1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_nhwc(a), b)
    got16 = correlation_bwd_reference(_nchw(f1).bfloat16(), _nchw(f2).bfloat16(),
                                      _nchw(g), 2, 1)
    ref16 = correlation_bwd_reference(_nchw(f1).bfloat16().float(),
                                      _nchw(f2).bfloat16().float(), _nchw(g), 2, 1)
    for a, b in zip(got16, ref16):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b.bfloat16(), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# K4 and K5: the warp's gradients

H, W = 8, 128
P = wp.PBLK


def _warp_inputs(seed, b=1, c=1, p=P, scale=1.3):
    """Positions spanning in-image and out-of-image taps on every side."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, H, W, c)).astype(np.float32)
    px = rng.uniform(-2.0, (W - 1) * scale, (b, p)).astype(np.float32)
    py = rng.uniform(-2.0, (H - 1) * scale, (b, p)).astype(np.float32)
    g = rng.standard_normal((b, p, c)).astype(np.float32)
    return img, px, py, g


def _port_warp_grads(img, px, py, g):
    """The port's CPU route: autograd through ``sample2d`` at positions
    [B, 1, P]; returns (dimg NHWC, dpx, dpy)."""
    im = _nchw(img).requires_grad_()
    x = torch.from_numpy(px)[:, None].requires_grad_()
    y = torch.from_numpy(py)[:, None].requires_grad_()
    out = sample2d(im, x, y)                            # [B, C, 1, P]
    out.backward(torch.from_numpy(np.ascontiguousarray(
        np.transpose(g, (0, 2, 1))))[:, :, None])
    return _nhwc(im.grad), x.grad[:, 0].numpy(), y.grad[:, 0].numpy()


@pytest.mark.parametrize("c", [1, 2, 3, 32])   # K5's channel counts: SyN 2, PWC 32
def test_warp_grads_match_jax_vjp(c):
    img, px, py, g = _warp_inputs(5, b=2, c=c)
    got = _port_warp_grads(img, px, py, g)
    _, vjp = jax.vjp(lambda im, a, b: jax_sample(im, a[:, None], b[:, None]),
                     jnp.asarray(img), jnp.asarray(px), jnp.asarray(py))
    want = vjp(jnp.asarray(g)[:, None])
    # d/dimg sums up to 4·P/(H·W) ≈ 4 weighted cotangents per pixel; the
    # position gradients are 4 products each
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=1e-6)


def test_warp_position_grads_match_pallas_interpret(monkeypatch):
    """Against tpureg's warp2d_pallas VJP (K4's bases times the cotangent)
    under the Pallas interpreter. Its forward rounds through a bf16 hi/lo
    split, hence tpureg's own 1e-4 bound (test_pallas_interpret.py:199)."""
    monkeypatch.setattr(wp, "_INTERPRET", True)
    img, px, py, g = _warp_inputs(6)
    _, vjp = jax.vjp(lambda a, b: wp.warp2d_pallas(jnp.asarray(img[..., 0]), a, b),
                     jnp.asarray(px), jnp.asarray(py))
    want_px, want_py = vjp(jnp.asarray(g[..., 0]))
    _, got_px, got_py = _port_warp_grads(img, px, py, g)
    np.testing.assert_allclose(got_px, np.asarray(want_px), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_py, np.asarray(want_py), atol=1e-4, rtol=1e-4)


def test_warp_taps_bases_match_pallas_interpret(monkeypatch):
    """K4's function: sample and bases against tpureg's _fwd_taps_kernel."""
    monkeypatch.setattr(wp, "_INTERPRET", True)
    img, px, py, _ = _warp_inputs(7)
    want = wp._fwd_with_taps(jnp.asarray(img[..., 0]), jnp.asarray(px),
                             jnp.asarray(py))
    got = sample2d_taps_reference(_nchw(img), torch.from_numpy(px),
                                  torch.from_numpy(py))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[:, 0].numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def test_warp_image_grad_matches_pallas_interpret(monkeypatch):
    """K5's function against tpureg's _dimg_kernel. That kernel rounds its
    operands to bf16 by design (test_pallas_interpret.py:205-220), hence the
    loose bound; the port's K5 is held to the fp32 gather's autograd."""
    monkeypatch.setattr(wp, "_INTERPRET", True)
    img, px, py, g = _warp_inputs(8)
    _, res = wp._vjp_fwd(jnp.asarray(img[..., 0]), jnp.asarray(px),
                         jnp.asarray(py))
    want, _, _ = wp._vjp_bwd(res, jnp.asarray(g[..., 0]))
    got = sample2d_dimg_reference(
        torch.from_numpy(np.ascontiguousarray(np.transpose(g, (0, 2, 1)))),
        torch.from_numpy(px), torch.from_numpy(py), (1, 1, H, W))
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want), atol=5e-2,
                               rtol=5e-2)
    dimg, _, _ = _port_warp_grads(img, px, py, g)
    np.testing.assert_array_equal(dimg[..., 0], got[:, 0].numpy())


def test_warp_plain_versions_are_the_cpu_route():
    """The plain versions K4 and K5 are held against on the card are the
    CPU route's autograd, channel by channel."""
    img, px, py, g = _warp_inputs(9, b=2, c=3, p=300)
    dimg, dpx, dpy = _port_warp_grads(img, px, py, g)
    x, y = torch.from_numpy(px), torch.from_numpy(py)
    out, bx, by = sample2d_taps_reference(_nchw(img), x, y)
    gt = torch.from_numpy(np.ascontiguousarray(np.transpose(g, (0, 2, 1))))
    np.testing.assert_array_equal(
        out.numpy(), sample2d_gather(_nchw(img), x, y).numpy())
    np.testing.assert_allclose((gt * bx).sum(1).numpy(), dpx, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose((gt * by).sum(1).numpy(), dpy, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(
        _nhwc(sample2d_dimg_reference(gt, x, y, (2, 3, H, W))), dimg)


def _dpos_args(img, px, py, g):
    """numpy NHWC image, [B, P] positions and [B, P, C] cotangent as
    ``sample2d_dpos_reference``'s arguments (grad [B,C,P], NCHW image)."""
    gt = torch.from_numpy(np.ascontiguousarray(np.transpose(g, (0, 2, 1))))
    return gt, _nchw(img), torch.from_numpy(px), torch.from_numpy(py)


def _jax_dpos(img, px, py, g):
    """``jax.vjp`` of tpureg's ``sample2d_gather`` to px and py."""
    _, vjp = jax.vjp(lambda a, b: jax_sample(jnp.asarray(img), a[:, None], b[:, None]),
                     jnp.asarray(px), jnp.asarray(py))
    return [np.asarray(t) for t in vjp(jnp.asarray(g)[:, None])]


@pytest.mark.parametrize("c", [1, 2, 32])   # FlowNet2's images, SyN's fields, PWC
def test_dpos_reference_matches_jax_vjp(c):
    """K4's function against tpureg's VJP to the positions, with positions
    past every side of the image (out-of-image taps included)."""
    img, px, py, g = _warp_inputs(20, b=2, c=c)
    assert px.min() < 0 and px.max() > W and py.min() < 0 and py.max() > H
    got = sample2d_dpos_reference(*_dpos_args(img, px, py, g))
    # C products of O(1) bases and unit cotangents each, summed in another
    # order: fp32 roundings of sums of order sqrt(C)
    for k, want in zip(got, _jax_dpos(img, px, py, g)):
        assert k.dtype == torch.float32 and k.shape == px.shape
        np.testing.assert_allclose(k.numpy(), want, atol=1e-5, rtol=1e-5)


def test_dpos_reference_matches_pallas_interpret(monkeypatch):
    """At C = 1, against tpureg's warp2d_pallas VJP (its taps kernel's bases
    times the cotangent) under the Pallas interpreter. Its forward rounds
    the image through a bf16 hi/lo split (2^-16 of a value): differences of
    up to 2.4e-5 here, within 1e-5 abs + 1e-5 rel of these O(1) values."""
    monkeypatch.setattr(wp, "_INTERPRET", True)
    img, px, py, g = _warp_inputs(21)
    _, vjp = jax.vjp(lambda a, b: wp.warp2d_pallas(jnp.asarray(img[..., 0]), a, b),
                     jnp.asarray(px), jnp.asarray(py))
    want = vjp(jnp.asarray(g[..., 0]))
    got = sample2d_dpos_reference(*_dpos_args(img, px, py, g))
    for k, w in zip(got, want):
        np.testing.assert_allclose(k.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("c", [1, 32])
def test_dpos_reference_reads_bf16_taps_in_fp32(c):
    """A bf16 image: its taps are read in fp32, so the cotangent is the fp32
    image's with the same (bf16-rounded) values, bit for bit, and agrees
    with tpureg's VJP on those values."""
    img, px, py, g = _warp_inputs(22, b=2, c=c)
    gt, im, x, y = _dpos_args(img, px, py, g)
    got = sample2d_dpos_reference(gt, im.bfloat16(), x, y)
    rounded = im.bfloat16().float()
    for k, r in zip(got, sample2d_dpos_reference(gt, rounded, x, y)):
        assert k.dtype == torch.float32
        torch.testing.assert_close(k, r, atol=0, rtol=0)
    for k, want in zip(got, _jax_dpos(_nhwc(rounded), px, py, g)):
        np.testing.assert_allclose(k.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("c", [1, 3, 32])
def test_dpos_reference_is_the_cpu_route(c):
    """The port's CPU ``sample2d`` route (autograd through the gather) gives
    the positions the same cotangent as K4's plain version."""
    img, px, py, g = _warp_inputs(23, b=2, c=c)
    _, dpx, dpy = _port_warp_grads(img, px, py, g)
    got = sample2d_dpos_reference(*_dpos_args(img, px, py, g))
    for k, want in zip(got, (dpx, dpy)):
        np.testing.assert_allclose(k.numpy(), want, atol=1e-5, rtol=1e-5)


def test_sample2d_nearest_matches_tpureg():
    rng = np.random.default_rng(10)
    img = rng.integers(0, 4, (2, 16, 20, 1)).astype(np.float32)
    px = (rng.random((2, 9, 7)) * 30 - 6).astype(np.float32)
    py = (rng.random((2, 9, 7)) * 26 - 6).astype(np.float32)
    px[0, 0, :3] = [2.5, 3.5, -0.5]  # halves round to even, as jnp.rint does
    got = sample2d_nearest(_nchw(img), torch.from_numpy(px), torch.from_numpy(py))
    want = jax_nearest(jnp.asarray(img), jnp.asarray(px), jnp.asarray(py))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


# ---------------------------------------------------------------------------
# BatchNorm: running statistics as flax keeps them

def _flax_bn_step(x_nhwc, scale, bias, mean, var):
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    y, upd = bn.apply(variables, jnp.asarray(x_nhwc), mutable=["batch_stats"])
    return np.asarray(y), upd["batch_stats"]


@pytest.mark.parametrize("shape", [(4, 6, 5, 5), (2, 3, 1, 1), (1, 4, 1, 1)],
                         ids=["spatial", "one-pixel", "one-value"])
def test_batchnorm_running_stats_match_flax(shape):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(shape) * 1.7 + 0.4).astype(np.float32)
    c = shape[1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    mean = rng.standard_normal(c).astype(np.float32) * 0.1
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bn = batch_norm(c)
    assert isinstance(bn, BatchNorm2d)
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var),
                        "num_batches_tracked": torch.tensor(0)})
    bn.train()
    y = bn(torch.from_numpy(x))
    want_y, want = _flax_bn_step(np.transpose(x, (0, 2, 3, 1)), scale, bias,
                                 mean, var)
    # fp32 statistics of at most 100 values per channel, in another order:
    # relative 1e-6 of each running statistic (an unbiased variance would be
    # off by n/(n-1), 1% here)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want["mean"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(want["var"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(_nhwc(y), want_y, atol=1e-5, rtol=1e-5)
    assert int(bn.num_batches_tracked) == 1


def test_batchnorm_bf16_keeps_fp32_statistics():
    """A bf16 activation: fp32 statistics, output in bf16, normalised in fp32
    (within one bf16 rounding of the fp32 input's normalisation)."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((4, 3, 5, 5)).astype(np.float32))
    xb = x.bfloat16()
    bn16, bn32 = batch_norm(3).train(), batch_norm(3).train()
    y16, y32 = bn16(xb), bn32(xb.float())
    assert y16.dtype == torch.bfloat16
    assert bn16.running_var.dtype == torch.float32
    torch.testing.assert_close(bn16.running_mean, bn32.running_mean, atol=0, rtol=0)
    torch.testing.assert_close(bn16.running_var, bn32.running_var, atol=0, rtol=0)
    torch.testing.assert_close(y16.float(), y32, atol=1e-6, rtol=2**-8)
