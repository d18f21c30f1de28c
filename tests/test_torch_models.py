"""tpureg_torch's FlowNet2 subnets and weight bridge against tpureg's on the
CPU.

Each subnet is initialised in flax, given random BatchNorm statistics, carried
into the port through ``tpureg_torch.compat.state_dict_from_jax`` with a
strict ``load_state_dict``, and run in eval mode on the same 64² input.
Tolerance 5e-4 abs / 1e-3 rel: the fp32 accumulation-order noise between
XLA:CPU and torch/MKL convolutions through 10+ layers, the tolerance
tests/test_parity_torch.py uses for the same nets; a wrong layout or key
gives O(1) errors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpureg.compat.torch_export import export_torch_state_dict
from tpureg.models import FlowNetC as JaxFlowNetC
from tpureg.models import FlowNetFusion as JaxFlowNetFusion
from tpureg.models import FlowNetS as JaxFlowNetS
from tpureg.models import FlowNetSD as JaxFlowNetSD
from tpureg.reg import OpticalFlowReg as JaxOpticalFlowReg
from test_torch_cli import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_refcache import refcache  # noqa: F401 (a fixture)
from tpureg_torch.compat import state_dict_from_jax
from tpureg_torch.models import (
    FlowNet2,
    FlowNetC,
    FlowNetFusion,
    FlowNetS,
    FlowNetSD,
)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


SIZE = 64


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _random_stats(stats, seed):
    """BatchNorm statistics that are not the identity (mean N(0, 0.1²),
    var U(0.5, 1.5)), so the bridge's running_mean/var mapping is tested."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "mean":
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, stats)


def _carry(flax_model, port_model, in_ch, seed):
    x = np.random.default_rng(seed).standard_normal(
        (2, SIZE, SIZE, in_ch)).astype(np.float32) * 0.5
    variables = jax.jit(lambda k, a: flax_model.init(k, a, train=True))(
        jax.random.key(seed), jnp.asarray(x))
    params = _numpy_tree(variables["params"])
    stats = _random_stats(_numpy_tree(variables["batch_stats"]), seed)
    sd = state_dict_from_jax(params, stats, prefix=())
    port_model.load_state_dict(sd, strict=True)
    port_model.eval()
    want = jax.jit(lambda v, a: flax_model.apply(v, a, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.inference_mode():
        got = port_model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return got, want, params, stats


def _assert_flows_match(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("name", ["flownetc", "flownets_nvidia", "flownetsd",
                                  "flownetfusion"])
def test_subnet_eval_forward_matches_tpureg(name):
    flax_model, port_model, in_ch = {
        "flownetc": (JaxFlowNetC(), FlowNetC(), 2),
        "flownets_nvidia": (JaxFlowNetS(input_channels=6, style="nvidia"),
                            FlowNetS(6, style="nvidia"), 6),
        "flownetsd": (JaxFlowNetSD(), FlowNetSD(), 2),
        "flownetfusion": (JaxFlowNetFusion(packed=False), FlowNetFusion(), 9),
    }[name]
    got, want, _, _ = _carry(flax_model, port_model, in_ch, seed=3)
    _assert_flows_match(got, want)


@pytest.fixture(scope="module")
def flownet2_trees(refcache):  # noqa: F811
    """tpureg's registration head around FlowNet2, initialised at 64² (once a
    session)."""
    def compute():
        x = jnp.zeros((1, SIZE, SIZE, 2), jnp.float32)
        model = JaxOpticalFlowReg(conv_predictor="flownet2")
        variables = jax.jit(lambda k, a: model.init(k, a, train=True))(
            jax.random.key(0), x)
        params = _numpy_tree(variables["params"])
        stats = _random_stats(_numpy_tree(variables["batch_stats"]), 1)
        return params, stats

    return refcache("flownet2_trees_64", compute)


def test_bridge_fills_flownet2_strictly(flownet2_trees):
    params, stats = flownet2_trees
    port = FlowNet2()
    sd = state_dict_from_jax(params, stats)
    result = port.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    for sub in ("flownetc", "flownets_1", "flownets_2", "flownets_d",
                "flownetfusion"):
        assert any(k.startswith(sub + ".") for k in sd)


def test_bridge_equals_tpureg_export(flownet2_trees):
    """Key for key and value for value, the bridge is tpureg's own export."""
    params, stats = flownet2_trees
    keys = FlowNet2().state_dict().keys()
    want, report = export_torch_state_dict(params, keys, stats,
                                           prefix=("predictor",))
    assert not report["missing"]
    got = state_dict_from_jax(params, stats)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_bridge_rejects_unknown_leaf():
    with pytest.raises(ValueError):
        state_dict_from_jax({"conv1": {"bn": {"bogus": np.zeros(2)}}}, prefix=())


def test_seeded_init_is_reproducible():
    a = FlowNetSD(generator=torch.Generator().manual_seed(5))
    b = FlowNetSD(generator=torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    # nvidia init: U(0, 1) biases, xavier-uniform weights
    bias = a.predict_flow6.bias.detach()
    assert 0.0 <= float(bias.min()) and float(bias.max()) <= 1.0
    w = a.conv1[0].weight.detach()
    limit = (6.0 / (w[0].numel() + w.shape[0] * w[0, 0].numel())) ** 0.5
    assert float(w.abs().max()) <= limit
