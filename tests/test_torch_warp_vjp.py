"""The backward of tpureg_torch's trilinear sample on the CPU: K6b's plain
version (the positions' cotangent) against tpureg's ``jax.vjp``, and the
wiring of the ops ``tpureg::sample3d`` and ``tpureg::sample2d``
(ops/library.py) with the backward they register for the card, on CPU
tensors, where each op the backward calls runs its plain version; the ops
run are recorded by a dispatch mode.

On the card, ``tpureg::sample3d`` runs K6a in the forward and, in the
backward, K6b (``tpureg::sample3d_dpos``) for the positions and K6c
(``tpureg::sample3d_dvol``) for the volume; it saves the volume (only when
the positions need a gradient) and the positions, never a per-channel
basis. ``tpureg::sample2d`` is its 2-D twin: K3 forward, K4
(``sample2d_dpos``) and K5 (``sample2d_dimg``) backward. Inputs come from
numpy; the port is NCDHW, tpureg NDHWC.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from tpureg.ops.warp import sample3d_gather as jax_sample3d
from tpureg_torch.ops import sample2d_gather, sample3d_dpos_reference, sample3d_gather
from test_torch_ops_library import card_autograd


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


class _Launches(TorchDispatchMode):
    """The kernels the ops run, by name, in the order they run."""

    KERNELS = {"sample3d": "K6a", "sample3d_dpos": "K6b", "sample3d_dvol": "K6c",
               "sample2d": "K3", "sample2d_dpos": "K4", "sample2d_dimg": "K5"}

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "tpureg":
            self.calls.append(self.KERNELS[func.__name__.split(".")[0]])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("need_vol,need_pos", [(False, False), (False, True),
                                               (True, False), (True, True)],
                         ids=["none", "positions", "volume", "both"])
def test_sample3d_kernel_wiring(need_vol, need_pos):
    b, c, d, h, w, p = 1, 2, 4, 5, 6, 7
    rng = np.random.default_rng(42)
    vol = torch.from_numpy(rng.random((b, c, d, h, w))).requires_grad_(need_vol)
    pos = [torch.from_numpy(rng.random((b, p)) * (n + 1) - 1.0) for n in (w, h, d)]
    pos = [(torch.floor(t) + 0.05 + 0.9 * (t - torch.floor(t))).requires_grad_(need_pos)
           for t in pos]
    node = card_autograd("sample3d")
    with _Launches() as launches:
        out = node(vol, *pos)
    torch.testing.assert_close(out, sample3d_gather(vol, *pos), atol=0, rtol=0)
    assert launches.calls == ["K6a"]
    if not (need_vol or need_pos):
        assert out.grad_fn is None
        return
    # what the node keeps for its backward: the positions, and the volume
    # only where K6b needs it; no [B, C, P] basis
    saved = out.grad_fn.saved_tensors
    assert [None if t is None else tuple(t.shape) for t in saved] == \
        [tuple(vol.shape) if need_pos else None] + [(b, p)] * 3
    with launches:
        out.backward(torch.from_numpy(rng.standard_normal(out.shape)))
    assert launches.calls == ["K6a"] + ["K6c"] * need_vol + ["K6b"] * need_pos
    inputs = [t for t, need in zip([vol, *pos], [need_vol] + [need_pos] * 3) if need]
    assert all(t.grad is not None for t in inputs)
    # the analytic gradient (the backward's cotangent is fp32, as the
    # kernels take it) against fp64 central differences of the forward
    assert torch.autograd.gradcheck(
        lambda *args: node(*args), [
            t.detach().requires_grad_(need)
            for t, need in zip([vol, *pos], [need_vol] + [need_pos] * 3)])


@pytest.mark.parametrize("need_img,need_pos", [(False, False), (False, True),
                                               (True, False), (True, True)],
                         ids=["none", "positions", "image", "both"])
def test_sample2d_kernel_wiring(need_img, need_pos):
    b, c, h, w, p = 2, 3, 5, 6, 7
    rng = np.random.default_rng(43)
    img = torch.from_numpy(rng.random((b, c, h, w))).requires_grad_(need_img)
    pos = [torch.from_numpy(rng.random((b, p)) * (n + 1) - 1.0) for n in (w, h)]
    pos = [(torch.floor(t) + 0.05 + 0.9 * (t - torch.floor(t))).requires_grad_(need_pos)
           for t in pos]
    node = card_autograd("sample2d")
    with _Launches() as launches:
        out = node(img, *pos)
    torch.testing.assert_close(out, sample2d_gather(img, *pos), atol=0, rtol=0)
    # every forward is K3, whatever needs a gradient
    assert launches.calls == ["K3"]
    if not (need_img or need_pos):
        assert out.grad_fn is None
        return
    # what the node keeps for its backward: the positions, and the image
    # only where K4 needs it; no [B, C, P] basis
    saved = out.grad_fn.saved_tensors
    assert [None if t is None else tuple(t.shape) for t in saved] == \
        [tuple(img.shape) if need_pos else None] + [(b, p)] * 2
    with launches:
        out.backward(torch.from_numpy(rng.standard_normal(out.shape)))
    assert launches.calls == ["K3"] + ["K5"] * need_img + ["K4"] * need_pos
    inputs = [t for t, need in zip([img, *pos], [need_img] + [need_pos] * 2) if need]
    assert all(t.grad is not None for t in inputs)
    # the analytic gradient (the kernels take an fp32 cotangent, and K4's
    # plain version forms fp32 bases) against fp64 central differences
    assert torch.autograd.gradcheck(
        lambda *args: node(*args), [
            t.detach().requires_grad_(need)
            for t, need in zip([img, *pos], [need_img] + [need_pos] * 2)])
