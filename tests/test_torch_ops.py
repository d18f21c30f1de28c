"""tpureg_torch ops against tpureg's on the CPU: correlation, warp,
channelnorm and resize.

Inputs come from numpy and pass between the frameworks as arrays; the port
is NCHW, tpureg NHWC, so each comparison transposes. Tolerances are fp32
accumulation-order noise: 1e-5 absolute for sums over at most a few hundred
products of unit-scale values, which is ~100 ulp of the results.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpureg.ops import correlation_pallas as cp
from tpureg.ops import warp_pallas as wp
from tpureg.ops.channelnorm import channelnorm as jax_channelnorm
from tpureg.ops.correlation import correlation_reference as jax_corr
from tpureg.ops.resize import resize2d as jax_resize
from tpureg.ops.warp import sample2d_gather as jax_sample
from tpureg.ops.warp import warp2d as jax_warp2d
from tpureg_torch.ops import (
    channelnorm,
    correlation,
    correlation_reference,
    displacement_count,
    resize2d,
    sample2d,
    sample2d_gather,
    warp2d,
)

ATOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _feats(seed, shape=(2, 24, 24, 32)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


# ---------------------------------------------------------------------------
# correlation

@pytest.mark.parametrize("md,s2", [(20, 2), (4, 1)])
def test_correlation_matches_tpureg(md, s2):
    f1, f2 = _feats(0)
    got = correlation_reference(_nchw(f1), _nchw(f2), md, s2)
    k = displacement_count(md, s2)
    assert got.shape == (2, k * k, 24, 24)
    want = np.asarray(jax_corr(jnp.asarray(f1), jnp.asarray(f2), md, s2))
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=0)


def test_correlation_matches_pallas_interpret():
    """The port's plain version against the TPU kernel's own body, run by the
    Pallas interpreter (as tests/test_pallas_interpret.py runs it)."""
    f1, f2 = _feats(1, (1, 8, 128, 8))
    got = correlation_reference(_nchw(f1), _nchw(f2), 4, 2)
    want = np.asarray(cp._corr_fwd_pallas(jnp.asarray(f1), jnp.asarray(f2), 4,
                                          2, interpret=True))
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("md,s2", [(20, 2), (4, 1)])
def test_correlation_bf16_matches_banded_pallas_interpret(md, s2):
    """K1b's function: the port's plain version on bf16 operands against
    tpureg's banded-MXU forward (``_corr_fwd_banded``) run by the Pallas
    interpreter, at tpureg's own tolerance for it
    (tests/test_pallas_interpret.py:48-56): tpureg rounds the product M to
    bf16 once per channel slab, the port rounds the fp32 sum once."""
    f1, f2 = _feats(4, (1, 16, 16, 24))
    a, b = (jnp.asarray(x).astype(jnp.bfloat16) for x in (f1, f2))
    want = cp._corr_fwd_banded(a, b, md, s2, interpret=True)
    assert want.dtype == jnp.bfloat16
    got = correlation_reference(_nchw(f1).bfloat16(), _nchw(f2).bfloat16(), md, s2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got.float()), np.asarray(want, np.float32),
                               atol=3e-2, rtol=2e-2)


def test_correlation_cpu_dispatch_is_the_plain_version():
    f1, f2 = (_nchw(a) for a in _feats(2, (1, 6, 6, 4)))
    assert torch.equal(correlation(f1, f2, 2, 1),
                       correlation_reference(f1, f2, 2, 1))


def test_correlation_bf16_output_dtype():
    f1, f2 = (_nchw(a).bfloat16() for a in _feats(3, (1, 6, 6, 8)))
    got = correlation_reference(f1, f2, 2, 1)
    assert got.dtype == torch.bfloat16
    want = correlation_reference(f1.float(), f2.float(), 2, 1)
    # bf16 keeps 8 bits of mantissa: the output rounding is ≤ 2^-8 relative
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=2**-8,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# warp

def _oob_flow(seed, b, h, w, scale=None):
    """Flows that push taps past every edge, negative positions included."""
    rng = np.random.default_rng(seed)
    scale = scale or max(h, w) * 0.4
    return (rng.standard_normal((b, h, w, 2)) * scale).astype(np.float32)


def test_sample2d_gather_matches_tpureg():
    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, 16, 20, 3)).astype(np.float32)
    px = (rng.random((2, 9, 7)) * 30 - 6).astype(np.float32)
    py = (rng.random((2, 9, 7)) * 26 - 6).astype(np.float32)
    assert px.min() < 0 and py.min() < 0 and px.max() > 20 and py.max() > 16
    got = sample2d_gather(_nchw(img), torch.from_numpy(px), torch.from_numpy(py))
    want = np.asarray(jax_sample(jnp.asarray(img), jnp.asarray(px),
                                 jnp.asarray(py)))
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=0)
    assert torch.equal(
        sample2d(_nchw(img), torch.from_numpy(px), torch.from_numpy(py)), got)


@pytest.mark.parametrize("convention", ["stn", "pixel"])
def test_warp2d_matches_tpureg(convention):
    rng = np.random.default_rng(5)
    img = rng.standard_normal((2, 24, 32, 1)).astype(np.float32)
    flow = _oob_flow(6, 2, 24, 32)
    got = warp2d(_nchw(img), _nchw(flow), convention)
    want = np.asarray(jax_warp2d(jnp.asarray(img), jnp.asarray(flow),
                                 convention))
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=0)


def test_warp2d_unknown_convention_raises():
    img = torch.zeros(1, 1, 4, 4)
    with pytest.raises(ValueError):
        warp2d(img, torch.zeros(1, 2, 4, 4), "bogus")


def test_sample2d_matches_pallas_interpret(monkeypatch):
    """The port's warp against the TPU kernel under the Pallas interpreter at
    the smallest shape ``supported()`` takes: (1, 32, 128), P = 4096."""
    monkeypatch.setattr(wp, "_INTERPRET", True)
    rng = np.random.default_rng(7)
    b, h, w = 1, 32, 128
    assert wp.supported((b, h, w, 1), h * w)
    img = rng.random((b, h, w)).astype(np.float32)
    flow = _oob_flow(8, b, h, w, scale=12.0)
    px = np.arange(w, dtype=np.float32)[None, None] + flow[..., 0]
    py = np.arange(h, dtype=np.float32)[None, :, None] + flow[..., 1]
    want = np.asarray(wp.warp2d_pallas(jnp.asarray(img),
                                       jnp.asarray(px.reshape(b, -1)),
                                       jnp.asarray(py.reshape(b, -1))))
    got = sample2d(torch.from_numpy(img)[:, None], torch.from_numpy(px),
                   torch.from_numpy(py))
    np.testing.assert_allclose(got.reshape(b, -1).numpy(), want, atol=ATOL,
                               rtol=0)


def test_sample2d_bf16_image_returns_bf16():
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.random((1, 2, 8, 8)).astype(np.float32))
    px = torch.from_numpy((rng.random((1, 5, 5)) * 10 - 1).astype(np.float32))
    py = torch.from_numpy((rng.random((1, 5, 5)) * 10 - 1).astype(np.float32))
    got = sample2d(img.bfloat16(), px, py)
    assert got.dtype == torch.bfloat16
    want = sample2d(img.bfloat16().float(), px, py)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=2**-8,
                               atol=0)


# ---------------------------------------------------------------------------
# channelnorm and resize

def test_channelnorm_matches_tpureg():
    x = np.random.default_rng(10).standard_normal((2, 8, 9, 3)).astype(np.float32)
    x[0, 0, 0] = 0.0  # the eps inside the sqrt keeps this finite
    got = channelnorm(_nchw(x))
    want = np.asarray(jax_channelnorm(jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("size,method,align", [
    ((17, 23), "bilinear", True),
    ((17, 23), "bilinear", False),
    ((5, 6), "bilinear", False),
    ((48, 40), "nearest", False),  # ×4 nearest, FlowNet2's S2 / SD upsample
    ((48, 40), "bilinear", False),  # ×4 bilinear, FlowNet2's C / S1 upsample
])
def test_resize_matches_tpureg(size, method, align):
    x = np.random.default_rng(11).standard_normal((2, 12, 10, 2)).astype(np.float32)
    got = resize2d(_nchw(x), size, method, align_corners=align)
    want = np.asarray(jax_resize(jnp.asarray(x), size, method,
                                 align_corners=align))
    # tpureg resizes with fp32 matmuls of weights computed in float64;
    # F.interpolate computes its weights in fp32: ~1e-6 on unit-scale data
    np.testing.assert_allclose(_nhwc(got), want, atol=2e-6, rtol=1e-6)


def test_resize_same_size_is_identity():
    x = torch.randn(1, 2, 5, 5)
    assert resize2d(x, (5, 5)) is x
