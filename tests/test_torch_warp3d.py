"""The 3-D warp of tpureg_torch (kernel K6's plain versions, ``sample3d``,
``warp3d``), ``resize_nd``, ``exp_velocity3d``, ``apply_flow3d`` and the
volumetric losses against tpureg's on the CPU.

On the CPU the port's trilinear sample is its plain gather
``sample3d_gather`` and autograd: the very functions the card kernels K6a,
K6b and K6c are held against in ``test_torch_kernels_gpu.py``. Here they are
held against tpureg's gather (``sample3d_gather``, ``_gather_taps``, their
``jax.vjp``) and, once, against tpureg's Pallas kernel run by the Pallas
interpreter where its guard holds. Fault C1 of the reference (its guard
accepts a slab-relative z of -1, warp3d_pallas.py:368) is a case of the
kernel's slab, which the port does not have: its C1 test holds the port
against the gather only. Inputs come from numpy; the port is NCDHW, tpureg
NDHWC.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpureg.classical.syn3d import apply_flow3d as jax_apply_flow3d
from tpureg.classical.syn3d import exp_velocity3d as jax_exp_velocity3d
from tpureg.losses import Affloss as JaxAffloss
from tpureg.losses import DEFloss3D as JaxDEFloss3D
from tpureg.ops import warp3d_pallas as wp3
from tpureg.ops.resize import resize_nd as jax_resize_nd
from tpureg.ops.warp import sample3d_gather as jax_sample3d
from tpureg.ops.warp import warp3d as jax_warp3d
from tpureg_torch.classical import apply_flow3d, exp_velocity3d
from tpureg_torch.losses import Affloss, DEFloss3D
from tpureg_torch.ops import (
    resize_nd,
    sample3d,
    sample3d_dvol_reference,
    sample3d_gather,
    sample3d_taps_reference,
    warp3d,
)


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _ndhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _scattered(seed, b, c, d, h, w, scale):
    """A random volume [B, D, H, W, C] and positions at the voxel grid plus
    N(0, scale²) displacements, many corners outside the volume."""
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((b, d, h, w, c)).astype(np.float32)
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    pos = [(g + rng.standard_normal((b, d, h, w)) * scale).astype(np.float32)
           for g in (xx, yy, zz)]
    return vol, pos


def _smooth_flow(seed, b, d, h, w, amp):
    """[B, D, H, W, 3] smooth displacement (sums of low sinusoids)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(np.arange(d) / d, np.arange(h) / h,
                             np.arange(w) / w, indexing="ij")
    flow = np.empty((b, d, h, w, 3), np.float32)
    for i in range(b):
        for k in range(3):
            f = rng.uniform(0.5, 1.5, 3)
            ph = rng.uniform(0, 2 * np.pi)
            flow[i, ..., k] = amp * np.sin(2 * np.pi * (f[0] * xx + f[1] * yy
                                                        + f[2] * zz) + ph)
    return flow


# ---------------------------------------------------------------------------
# K6a's plain version: the gather

@pytest.mark.parametrize("c,scale", [(1, 3.0), (3, 6.0)])
def test_sample3d_gather_equals_tpureg(c, scale):
    vol, (px, py, pz) = _scattered(0, 2, c, 6, 7, 9, scale)
    want = jax_sample3d(jnp.asarray(vol), *(jnp.asarray(p) for p in (px, py, pz)))
    got = sample3d_gather(_ncdhw(vol), *(torch.from_numpy(p) for p in (px, py, pz)))
    # the same roundings in the same order: equal to the last bit
    np.testing.assert_array_equal(_ndhwc(got), np.asarray(want))


def test_sample3d_gather_bf16_volume_equals_tpureg():
    vol, (px, py, pz) = _scattered(1, 1, 2, 5, 6, 7, 2.0)
    vol16 = jnp.asarray(vol).astype(jnp.bfloat16)
    want = jax_sample3d(vol16, *(jnp.asarray(p) for p in (px, py, pz)))
    got = sample3d_gather(_ncdhw(vol).bfloat16(),
                          *(torch.from_numpy(p) for p in (px, py, pz)))
    assert got.dtype == torch.bfloat16
    # fp32 sums of the bf16 values, rounded once to bf16 on both sides
    np.testing.assert_array_equal(_ndhwc(got.float()),
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# K6b's and K6c's plain versions

def _flat(vol, pos):
    b = vol.shape[0]
    return [torch.from_numpy(p.reshape(b, -1)) for p in pos]


@pytest.mark.parametrize("scale", [0.6, 4.0], ids=["smooth", "scattered"])
def test_taps_reference_matches_gather_taps(scale):
    vol, pos = _scattered(2, 2, 1, 6, 8, 10, scale)
    b = vol.shape[0]
    want = wp3._gather_taps(jnp.asarray(vol[..., 0]),
                            *(jnp.asarray(p.reshape(b, -1)) for p in pos), True)
    got = sample3d_taps_reference(_ncdhw(vol), *_flat(vol, pos))
    # _gather_taps weights a tap as ((v·cx)·cy)·cz, the gather as
    # v·((cx·cy)·cz); the bases are the same products of tap values summed
    # as autograd's chain sums them: a few fp32 roundings of values of order 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:, 0].numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-5)


def test_taps_reference_per_channel():
    vol, pos = _scattered(3, 1, 3, 5, 6, 7, 2.0)
    got = sample3d_taps_reference(_ncdhw(vol), *_flat(vol, pos))
    for c in range(3):
        one = sample3d_taps_reference(_ncdhw(vol[..., c:c + 1]), *_flat(vol, pos))
        for a, b in zip(got, one):
            np.testing.assert_array_equal(a[:, c].numpy(), b[:, 0].numpy())


@pytest.mark.parametrize("c", [1, 3])
def test_dvol_reference_matches_jax_vjp(c):
    vol, pos = _scattered(4, 2, c, 6, 7, 8, 3.0)
    g = np.random.default_rng(5).standard_normal(vol.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jax_sample3d(v, *(jnp.asarray(p) for p in pos)),
                     jnp.asarray(vol))
    (want,) = vjp(jnp.asarray(g))
    b = vol.shape[0]
    got = sample3d_dvol_reference(_ncdhw(g).reshape(b, c, -1), *_flat(vol, pos),
                                  _ncdhw(vol).shape)
    # scatter-adds of the same products in another order: fp32 roundings of
    # sums of at most 8 terms of order 1
    np.testing.assert_allclose(_ndhwc(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_sample3d_autograd_matches_jax_grad():
    """The composition case: a 3-channel field warped by itself, both the
    field and the positions differentiated."""
    d, h, w = 6, 8, 10
    flow = _smooth_flow(6, 2, d, h, w, 1.3)
    weights = np.random.default_rng(7).standard_normal(flow.shape).astype(np.float32)

    def jax_loss(f):
        return jnp.sum(jnp.asarray(weights) * jax_warp3d(f, f))

    want = jax.grad(jax_loss)(jnp.asarray(flow))
    f = _ncdhw(flow).requires_grad_()
    (warp3d(f, f) * _ncdhw(weights)).sum().backward()
    # gradients through floor taken at the same positions, summed in
    # another order
    np.testing.assert_allclose(_ndhwc(f.grad), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# against tpureg's Pallas kernel, in interpret mode, where its guard holds

def test_gather_matches_pallas_kernel_interpret(monkeypatch):
    monkeypatch.setattr(wp3, "_INTERPRET", True)
    d, h, w = 24, 64, 64   # the kernel's smallest geometry (D == S)
    rng = np.random.default_rng(8)
    vol = rng.standard_normal((1, d, h, w, 1)).astype(np.float32)
    flow = _smooth_flow(9, 1, d, h, w, 1.7)
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    pos = [(g + flow[..., k]).astype(np.float32) for k, g in enumerate((xx, yy, zz))]
    flat = [jnp.asarray(p.reshape(1, -1)) for p in pos]
    assert wp3.supported((1, d, h, w)) and bool(wp3._guard3(flat[1], flat[2], d, h, w))
    out, bx, by, bz = wp3._grid_call(jnp.asarray(vol[..., 0]), *flat, with_taps=True)
    got = sample3d_taps_reference(_ncdhw(vol), *_flat(vol, pos))
    # the TPU kernel selects with one-hot bf16 products of a hi/lo split:
    # its own tolerance against the gather (test_pallas_interpret.py)
    np.testing.assert_allclose(got[0][:, 0].numpy(), np.asarray(out), atol=3e-5,
                               rtol=1e-5)
    for g, want in zip(got[1:], (bx, by, bz)):
        np.testing.assert_allclose(g[:, 0].numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# fault C1's configuration: d >= 32 with z shifts of ±8.5

@pytest.mark.parametrize("dz", [-8.5, 8.5])
def test_c1_configuration_against_gather(dz):
    d, h, w = 32, 64, 64
    rng = np.random.default_rng(10)
    vol = rng.standard_normal((1, d, h, w, 1)).astype(np.float32)
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    pos = [xx.astype(np.float32)[None], yy.astype(np.float32)[None],
           (zz + dz).astype(np.float32)[None]]
    flat = [jnp.asarray(p.reshape(1, -1)) for p in pos]
    # for dz < 0 tpureg's dispatch sends this case to its kernel, whose slab
    # misses the taps there (ADVICE.md:3); the port has no slab
    assert wp3.supported((1, d, h, w))
    assert bool(wp3._guard3(flat[1], flat[2], d, h, w)) == (dz < 0)
    want = jax_sample3d(jnp.asarray(vol), *(jnp.asarray(p) for p in pos))
    port = [torch.from_numpy(p) for p in pos]
    got = sample3d(_ncdhw(vol), *port)
    np.testing.assert_array_equal(_ndhwc(got), np.asarray(want))
    # half the taps of every position lie half a voxel from a slice: the
    # sample is the mean of two slices dz ± 0.5 away, zero outside
    shifted = np.zeros_like(vol)
    lo, hi = int(np.floor(dz)), int(np.floor(dz)) + 1
    for k, wt in ((lo, 0.5), (hi, 0.5)):
        src = np.arange(d) + k
        ok = (src >= 0) & (src < d)
        shifted[:, ok] += wt * vol[:, src[ok]]
    np.testing.assert_allclose(_ndhwc(got), shifted, atol=1e-6)


# ---------------------------------------------------------------------------
# warp3d, resize_nd, exp_velocity3d, apply_flow3d

def test_warp3d_matches_tpureg():
    vol = np.random.default_rng(11).standard_normal((2, 6, 8, 10, 2)).astype(np.float32)
    flow = _smooth_flow(12, 2, 6, 8, 10, 2.5)
    want = jax_warp3d(jnp.asarray(vol), jnp.asarray(flow))
    got = warp3d(_ncdhw(vol), _ncdhw(flow))
    np.testing.assert_array_equal(_ndhwc(got), np.asarray(want))


@pytest.mark.parametrize("src,dst,method,align", [
    ((3, 4, 5), (6, 8, 10), "nearest", False),      # VoxelMorph's ×2 upsample
    ((4, 5, 6), (8, 10, 12), "linear", True),       # the flow's upsample
    ((13, 11, 11), (11, 16, 16), "linear", False),  # the volume resize
], ids=["nearest-x2", "linear-align", "linear-half-pixel"])
def test_resize_nd_matches_tpureg(src, dst, method, align):
    x = np.random.default_rng(13).standard_normal((2, *src, 3)).astype(np.float32)
    want = jax_resize_nd(jnp.asarray(x), dst, method, align_corners=align)
    got = resize_nd(_ncdhw(x), dst, method, align_corners=align)
    if method == "nearest":
        np.testing.assert_array_equal(_ndhwc(got), np.asarray(want))
    else:
        # trilinear in one pass against three separable products with
        # weights from float64: fp32 roundings of values up to ~4
        np.testing.assert_allclose(_ndhwc(got), np.asarray(want), atol=5e-6,
                                   rtol=0)


def test_exp_velocity3d_matches_tpureg():
    v = _smooth_flow(14, 2, 8, 8, 12, 6.0)
    want = jax_exp_velocity3d(jnp.asarray(v), 7)
    got = exp_velocity3d(_ncdhw(v), 7)
    # seven compositions, each a gather in the same order: the floors
    # agree, so the result does to fp32 rounding of the additions
    np.testing.assert_allclose(_ndhwc(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_apply_flow3d_nearest_matches_tpureg():
    rng = np.random.default_rng(15)
    seg = rng.integers(0, 4, (1, 6, 7, 8, 1)).astype(np.float32)
    flow = (rng.standard_normal((1, 6, 7, 8, 3)) * 2).astype(np.float32)
    want = jax_apply_flow3d(jnp.asarray(seg), jnp.asarray(flow), "nearest")
    got = apply_flow3d(_ncdhw(seg), _ncdhw(flow), "nearest")
    np.testing.assert_array_equal(_ndhwc(got), np.asarray(want))
    np.testing.assert_array_equal(
        _ndhwc(apply_flow3d(_ncdhw(seg), _ncdhw(flow))),
        np.asarray(jax_apply_flow3d(jnp.asarray(seg), jnp.asarray(flow))))


# ---------------------------------------------------------------------------
# volumetric losses

def test_defloss3d_and_affloss_match_tpureg():
    rng = np.random.default_rng(16)
    fixed = rng.random((2, 5, 6, 7, 1)).astype(np.float32)
    warped = rng.random((2, 5, 6, 7, 1)).astype(np.float32)
    flow = _smooth_flow(17, 2, 5, 6, 7, 1.5)
    want = JaxDEFloss3D(jnp.asarray(flow), jnp.asarray(warped), jnp.asarray(fixed))
    got = DEFloss3D(_ncdhw(flow), _ncdhw(warped), _ncdhw(fixed))
    # fp32 sums of a few hundred terms in another order
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    want = JaxAffloss(jnp.asarray(warped), jnp.asarray(fixed), lamb_da=0.7, gamma=2.0)
    got = Affloss(_ncdhw(warped), _ncdhw(fixed), lamb_da=0.7, gamma=2.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    # a constant volume has no correlation: the guard gives corr = 1
    const = np.full_like(fixed, 0.5)
    got = Affloss(_ncdhw(const), _ncdhw(fixed))
    assert float(got[1]) == 0.0
