"""The 3-D models of tpureg_torch (``VoxelMorph3D``, ``AffineNet3D``,
``affine_warp3d``), their weight bridge and initialisers, and flax's
``leaky_relu``, against tpureg's on the CPU.

Weights come from one flax initialisation through
``compat.state_dict_from_jax_3d``. At initialisation VoxelMorph3D's velocity
head is N(0, 1e-5) and AffineNet3D's θ the identity, so almost every sample
position lies on a voxel, where a rounding difference flips ``floor``; the
forward comparisons therefore scale the bridged velocity head (flows of
about one voxel) and perturb the dense bias, and check the identity case on
the sample alone.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

import tpureg_torch.models.flownet_c as port_flownet_c
from tpureg.models import AffineNet3D as JaxAffineNet3D
from tpureg.models import VoxelMorph3D as JaxVoxelMorph3D
from tpureg.models.affine3d import affine_warp3d as jax_affine_warp3d
from test_torch_cli import one_torch_thread  # noqa: F401 (a fixture)
from tpureg_torch.compat import state_dict_from_jax_3d
from tpureg_torch.models import AffineNet3D, VoxelMorph3D, affine_warp3d
from tpureg_torch.nn import layers, leaky_relu


pytestmark = pytest.mark.usefixtures("one_torch_thread")


SIZE = (16, 32, 32)


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _ndhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def blob_pair(seed, b=2, size=SIZE):
    """Fixed/moving volumes [B, D, H, W, 2]: Gaussian blobs in [0, 1]."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, n) for n in size), indexing="ij")
    vols = np.empty((b, *size, 2), np.float32)
    for i in range(b):
        for c in range(2):
            cx, cy, cz = rng.uniform(-0.2, 0.2, 3)
            vols[i, ..., c] = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2
                                       + (zz - cz) ** 2) / 0.3)
    return vols


def jax_params(model, vols, seed=0):
    params = jax.jit(model.init)(jax.random.key(seed), jnp.asarray(vols))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def vols():
    return blob_pair(0)


@pytest.fixture(scope="module")
def voxelmorph_init(vols):
    """tpureg's VoxelMorph3D parameters as initialised."""
    return jax_params(JaxVoxelMorph3D(), vols)


@pytest.fixture(scope="module")
def affine_init(vols):
    """tpureg's AffineNet3D parameters as initialised."""
    return jax_params(JaxAffineNet3D(), vols)


@pytest.fixture(scope="module")
def voxelmorph(vols, voxelmorph_init):
    params = jax.tree.map(np.copy, voxelmorph_init)
    params["flow_head"]["kernel"] = params["flow_head"]["kernel"] * 3e4
    return vols, params


# ---------------------------------------------------------------------------
# flax's leaky_relu (slope 1 at exactly 0)

def test_leaky_relu_matches_flax_at_zero():
    x = np.array([-2.0, -1e-30, -0.0, 0.0, 1e-30, 3.0], np.float32)
    want = np.asarray(fnn.leaky_relu(jnp.asarray(x), 0.2))
    dwant = np.asarray(jax.vmap(jax.grad(lambda v: fnn.leaky_relu(v, 0.2)))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    y = leaky_relu(t, 0.2)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want)
    np.testing.assert_array_equal(t.grad.numpy(), dwant)
    assert t.grad[3] == 1.0  # torch's F.leaky_relu gives 0.2 here
    # FlowNetC's cost-volume activation is the same function
    assert port_flownet_c.leaky_relu is layers.leaky_relu


# ---------------------------------------------------------------------------
# the bridge and the initialisers

def test_bridge_places_every_leaf(voxelmorph_init, affine_init):
    params, aparams = voxelmorph_init, affine_init
    model = VoxelMorph3D()
    model.load_state_dict(state_dict_from_jax_3d(params), strict=True)
    k = params["enc0"]["conv"]["kernel"]  # (3, 3, 3, 2, 16), DHWIO
    np.testing.assert_array_equal(
        model.enc0.conv.weight[5, 1, 0, 2, 1].detach().numpy(), k[0, 2, 1, 1, 5])
    affine = AffineNet3D(SIZE)
    affine.load_state_dict(state_dict_from_jax_3d(aparams), strict=True)
    assert tuple(affine.fc.weight.shape) == aparams["fc"]["kernel"].shape[::-1]


@pytest.mark.parametrize("tree", [
    {"enc0": {"conv": {"scale": np.ones(3)}}},
    {"encoder": {"kernel": np.ones((3, 3, 3, 2, 4))}},
    {"conv1": {"kernel": np.ones((3, 3, 2, 4))}},
], ids=["leaf", "module", "rank"])
def test_bridge_raises_on_a_leaf_it_cannot_place(tree):
    with pytest.raises(ValueError, match="no counterpart"):
        state_dict_from_jax_3d(tree)


def test_initialisers_follow_flax(voxelmorph_init, affine_init):
    jv, ja = voxelmorph_init, affine_init
    pv = VoxelMorph3D(generator=torch.Generator().manual_seed(3)).state_dict()
    pa = AffineNet3D(SIZE, generator=torch.Generator().manual_seed(3)).state_dict()
    ref = {**state_dict_from_jax_3d(jv), **state_dict_from_jax_3d(ja)}
    mine = {**pv, **pa}
    for key, want in ref.items():
        got = mine[key]
        if key.endswith("bias") or key == "fc.weight":
            # zero biases; the dense layer: zero kernel, identity bias
            torch.testing.assert_close(got, want, atol=0, rtol=0)
            continue
        # the same distribution, not the same values: lecun_normal, a normal
        # truncated at ±2σ with variance 1/fan_in, or N(0, 1e-5²)
        assert abs(float(got.std()) / float(want.std()) - 1) < 0.15, key
        if key != "flow_head.weight":
            sigma = (1.0 / got[0].numel()) ** 0.5 / 0.87962566103423978
            assert float(got.abs().max()) <= 2.0 * sigma * (1 + 1e-6), key


# ---------------------------------------------------------------------------
# forward passes against tpureg

def test_voxelmorph3d_forward_matches_tpureg(voxelmorph):
    vols, params = voxelmorph
    flow, warped, vel = jax.jit(JaxVoxelMorph3D().apply)({"params": params},
                                                         jnp.asarray(vols))
    model = VoxelMorph3D()
    model.load_state_dict(state_dict_from_jax_3d(params))
    with torch.no_grad():
        pflow, pwarped, pvel = model(_ncdhw(vols))
    scale = float(jnp.abs(flow).max())
    assert 0.3 < scale < 5.0  # flows of about one voxel, off the grid
    # fp32 convolutions summed in another order (1e-6 of the velocity's
    # scale), carried through seven compositions and the upsample
    np.testing.assert_allclose(_ndhwc(pvel), np.asarray(vel), atol=1e-5 * scale,
                               rtol=1e-4)
    np.testing.assert_allclose(_ndhwc(pflow), np.asarray(flow), atol=1e-5 * scale,
                               rtol=1e-4)
    np.testing.assert_allclose(_ndhwc(pwarped), np.asarray(warped), atol=1e-5)


def test_voxelmorph3d_full_resolution_variant():
    vols = blob_pair(2, b=1, size=(8, 8, 8))
    jm = JaxVoxelMorph3D(enc_features=(4, 8), dec_features=(8,),
                         extra_features=(4,), int_steps=2, int_downsize=1)
    params = jax_params(jm, vols)
    params["flow_head"]["kernel"] = params["flow_head"]["kernel"] * 3e4
    flow, warped, _ = jax.jit(jm.apply)({"params": params}, jnp.asarray(vols))
    model = VoxelMorph3D((4, 8), (8,), (4,), int_steps=2, int_downsize=1)
    model.load_state_dict(state_dict_from_jax_3d(params), strict=True)
    with torch.no_grad():
        pflow, pwarped, _ = model(_ncdhw(vols))
    scale = float(jnp.abs(flow).max())
    np.testing.assert_allclose(_ndhwc(pflow), np.asarray(flow), atol=1e-5 * scale,
                               rtol=1e-4)
    np.testing.assert_allclose(_ndhwc(pwarped), np.asarray(warped), atol=1e-5)


def test_affine_warp3d_matches_tpureg():
    rng = np.random.default_rng(4)
    vol = rng.random((2, 6, 8, 10, 2)).astype(np.float32)
    theta = (np.eye(3, 4)[None] + rng.standard_normal((2, 3, 4)) * 0.2).astype(np.float32)
    want = jax_affine_warp3d(jnp.asarray(vol), jnp.asarray(theta))
    got = affine_warp3d(_ncdhw(vol), torch.from_numpy(theta))
    # θ·(x, y, z, 1) summed in order here and in XLA's einsum order there:
    # positions apart by fp32 roundings, weights by as much
    np.testing.assert_allclose(_ndhwc(got), np.asarray(want), atol=1e-5)
    # at the identity the positions are exact on both sides (x·1 + 0 + 0 +
    # 0 in any order), so the samples are equal to the last bit
    eye = np.broadcast_to(np.eye(3, 4, dtype=np.float32), (2, 3, 4)).copy()
    np.testing.assert_array_equal(
        _ndhwc(affine_warp3d(_ncdhw(vol), torch.from_numpy(eye))),
        np.asarray(jax_affine_warp3d(jnp.asarray(vol), jnp.asarray(eye))))


def test_affinenet3d_forward_matches_tpureg(vols, affine_init):
    params = jax.tree.map(np.copy, affine_init)
    rng = np.random.default_rng(6)
    params["fc"]["bias"] = (params["fc"]["bias"]
                            + rng.standard_normal(12).astype(np.float32) * 0.05)
    params["fc"]["kernel"] = rng.standard_normal(params["fc"]["kernel"].shape
                                                 ).astype(np.float32) * 1e-3
    theta, warped = jax.jit(JaxAffineNet3D().apply)({"params": params},
                                                    jnp.asarray(vols))
    model = AffineNet3D(SIZE)
    model.load_state_dict(state_dict_from_jax_3d(params))
    with torch.no_grad():
        ptheta, pwarped = model(_ncdhw(vols))
    # six fp32 convolutions and a 512-wide product in another order
    np.testing.assert_allclose(ptheta.numpy(), np.asarray(theta), atol=1e-6)
    np.testing.assert_allclose(_ndhwc(pwarped), np.asarray(warped), atol=1e-5)
