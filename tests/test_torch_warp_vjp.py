"""The backward of tpureg_torch's trilinear sample on the CPU: K6b's plain
version (the positions' cotangent) against tpureg's ``jax.vjp``, and the
wiring of ``_Sample3dKernel`` and ``_Sample2dKernel``, the card's autograd
nodes, with their kernel launchers replaced by their plain versions.

On the card, ``_Sample3dKernel`` runs K6a in the forward and, in the
backward, K6b (``sample3d_dpos_cuda``) for the positions and K6c
(``sample3d_dvol_cuda``) for the volume; it saves the volume (only when the
positions need a gradient) and the positions, never a per-channel basis.
``_Sample2dKernel`` is its 2-D twin: K3 forward, K4 (``sample2d_dpos_cuda``)
and K5 (``sample2d_dimg_cuda``) backward. Inputs come from numpy; the port
is NCDHW, tpureg NDHWC.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpureg.ops.warp import sample3d_gather as jax_sample3d
from tpureg_torch.ops import warp as warp_ops
from tpureg_torch.ops import (
    sample2d_dimg_reference,
    sample2d_dpos_reference,
    sample2d_gather,
    sample3d_dpos_reference,
    sample3d_dvol_reference,
    sample3d_gather,
)


def _positions(seed, b, d, h, w, scale, smooth):
    """Positions [B, D, H, W] (x, y, z) at the voxel grid plus a smooth
    sinusoidal or a scattered N(0, scale²) displacement, off the voxel
    planes by at least 0.05 (non-integer)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
    pos = []
    for g in (xx, yy, zz):
        if smooth:
            f = rng.uniform(0.5, 1.5, 3)
            u = scale * np.sin(2 * np.pi * (f[0] * xx / w + f[1] * yy / h + f[2] * zz / d)
                               + rng.uniform(0, 2 * np.pi))
        else:
            u = rng.standard_normal((b, d, h, w)) * scale
        p = g + np.broadcast_to(u, (b, d, h, w))
        p = np.floor(p) + 0.05 + 0.9 * (p - np.floor(p))
        pos.append(p.astype(np.float32))
    return pos


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("smooth,scale", [(True, 1.3), (False, 3.0)],
                         ids=["smooth", "scattered"])
def test_dpos_reference_matches_jax_vjp(c, smooth, scale):
    b, d, h, w = 2, 5, 6, 7
    rng = np.random.default_rng(40 + c)
    vol = rng.standard_normal((b, d, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, d, h, w, c)).astype(np.float32)
    pos = _positions(41, b, d, h, w, scale, smooth)
    _, vjp = jax.vjp(lambda x, y, z: jax_sample3d(jnp.asarray(vol), x, y, z),
                     *(jnp.asarray(p) for p in pos))
    want = vjp(jnp.asarray(g))
    got = sample3d_dpos_reference(
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(g, -1, 1))).reshape(b, c, -1),
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(vol, -1, 1))),
        *(torch.from_numpy(p.reshape(b, -1)) for p in pos))
    # both differentiate the same gather; the chains associate the products
    # of corner values and weights otherwise: fp32 roundings of O(1) values
    for k, wnt in zip(got, want):
        assert k.dtype == torch.float32 and k.shape == (b, d * h * w)
        np.testing.assert_allclose(k.numpy(), np.asarray(wnt).reshape(b, -1),
                                   atol=1e-6, rtol=1e-5)


@pytest.fixture
def plain_launchers(monkeypatch):
    """``_Sample3dKernel``'s three launchers replaced by their plain
    versions, each call recorded by name."""
    calls = []

    def record(name, fn):
        def call(*args):
            calls.append(name)
            return fn(*args)
        return call

    monkeypatch.setattr(warp_ops, "sample3d_cuda",
                        record("K6a", lambda vol, px, py, pz: sample3d_gather(vol, px, py, pz)))
    monkeypatch.setattr(warp_ops, "sample3d_dpos_cuda",
                        record("K6b", sample3d_dpos_reference))
    monkeypatch.setattr(warp_ops, "sample3d_dvol_cuda",
                        record("K6c", sample3d_dvol_reference))
    return calls


@pytest.mark.parametrize("need_vol,need_pos", [(False, False), (False, True),
                                               (True, False), (True, True)],
                         ids=["none", "positions", "volume", "both"])
def test_sample3d_kernel_wiring(plain_launchers, need_vol, need_pos):
    b, c, d, h, w, p = 1, 2, 4, 5, 6, 7
    rng = np.random.default_rng(42)
    vol = torch.from_numpy(rng.random((b, c, d, h, w))).requires_grad_(need_vol)
    pos = [torch.from_numpy(rng.random((b, p)) * (n + 1) - 1.0) for n in (w, h, d)]
    pos = [(torch.floor(t) + 0.05 + 0.9 * (t - torch.floor(t))).requires_grad_(need_pos)
           for t in pos]
    out = warp_ops._Sample3dKernel.apply(vol, *pos)
    torch.testing.assert_close(out, sample3d_gather(vol, *pos), atol=0, rtol=0)
    assert plain_launchers == ["K6a"]
    if not (need_vol or need_pos):
        assert out.grad_fn is None
        return
    # what the node keeps for its backward: the positions, and the volume
    # only where K6b needs it; no [B, C, P] basis
    saved = out.grad_fn.saved_tensors
    assert [None if t is None else tuple(t.shape) for t in saved] == \
        [tuple(vol.shape) if need_pos else None] + [(b, p)] * 3
    out.backward(torch.from_numpy(rng.standard_normal(out.shape)))
    assert plain_launchers == ["K6a"] + ["K6c"] * need_vol + ["K6b"] * need_pos
    inputs = [t for t, need in zip([vol, *pos], [need_vol] + [need_pos] * 3) if need]
    assert all(t.grad is not None for t in inputs)
    # the analytic gradient (the backward's cotangent is fp32, as the
    # kernels take it) against fp64 central differences of the forward
    assert torch.autograd.gradcheck(
        lambda *args: warp_ops._Sample3dKernel.apply(*args), [
            t.detach().requires_grad_(need)
            for t, need in zip([vol, *pos], [need_vol] + [need_pos] * 3)])


@pytest.fixture
def plain_launchers2d(monkeypatch):
    """``_Sample2dKernel``'s three launchers replaced by their plain
    versions, each call recorded by name."""
    calls = []

    def record(name, fn):
        def call(*args):
            calls.append(name)
            return fn(*args)
        return call

    monkeypatch.setattr(warp_ops, "sample2d_cuda",
                        record("K3", lambda img, px, py: sample2d_gather(img, px, py)))
    monkeypatch.setattr(warp_ops, "sample2d_dpos_cuda",
                        record("K4", sample2d_dpos_reference))
    monkeypatch.setattr(warp_ops, "sample2d_dimg_cuda",
                        record("K5", sample2d_dimg_reference))
    return calls


@pytest.mark.parametrize("need_img,need_pos", [(False, False), (False, True),
                                               (True, False), (True, True)],
                         ids=["none", "positions", "image", "both"])
def test_sample2d_kernel_wiring(plain_launchers2d, need_img, need_pos):
    b, c, h, w, p = 2, 3, 5, 6, 7
    rng = np.random.default_rng(43)
    img = torch.from_numpy(rng.random((b, c, h, w))).requires_grad_(need_img)
    pos = [torch.from_numpy(rng.random((b, p)) * (n + 1) - 1.0) for n in (w, h)]
    pos = [(torch.floor(t) + 0.05 + 0.9 * (t - torch.floor(t))).requires_grad_(need_pos)
           for t in pos]
    out = warp_ops._Sample2dKernel.apply(img, *pos)
    torch.testing.assert_close(out, sample2d_gather(img, *pos), atol=0, rtol=0)
    # every forward is K3, whatever needs a gradient
    assert plain_launchers2d == ["K3"]
    if not (need_img or need_pos):
        assert out.grad_fn is None
        return
    # what the node keeps for its backward: the positions, and the image
    # only where K4 needs it; no [B, C, P] basis
    saved = out.grad_fn.saved_tensors
    assert [None if t is None else tuple(t.shape) for t in saved] == \
        [tuple(img.shape) if need_pos else None] + [(b, p)] * 2
    out.backward(torch.from_numpy(rng.standard_normal(out.shape)))
    assert plain_launchers2d == ["K3"] + ["K5"] * need_img + ["K4"] * need_pos
    inputs = [t for t, need in zip([img, *pos], [need_img] + [need_pos] * 2) if need]
    assert all(t.grad is not None for t in inputs)
    # the analytic gradient (the kernels take an fp32 cotangent, and K4's
    # plain version forms fp32 bases) against fp64 central differences
    assert torch.autograd.gradcheck(
        lambda *args: warp_ops._Sample2dKernel.apply(*args), [
            t.detach().requires_grad_(need)
            for t, need in zip([img, *pos], [need_img] + [need_pos] * 2)])
