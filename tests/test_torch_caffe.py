"""The port's Caffe reader and layer-ordered import
(tpureg_torch/compat/caffe_reader.py, caffe_import.py) against tpureg's on
the CPU.

Caffemodels are encoded in memory (tests/test_compat.py's
``encode_caffemodel``). The reader must give what tpureg's gives, blob for
blob. ``assign_layer_ordered`` must put each caffe layer where tpureg's
puts it: tpureg's result, carried into the port by ``state_dict_from_jax``,
equals the port's bit for bit, on toy trees and on the nets of
``CAFFE_NETS``. tpureg walks its tree after ``jax.tree.map``, which sorts
dict keys, so both assign in the sorted order of the flax paths; where
that order parts from the caffe order, both stop at the first layer whose
shape does not fit (``FIRST_PARTING``).
"""

import re

import numpy as np
import pytest
import torch
from torch import nn

import jax

from test_compat import encode_caffemodel
from test_torch_cli import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_zoo import numpy_variables, port_head
from tpureg.compat import CAFFE_NETS as JAX_CAFFE_NETS
from tpureg.compat import assign_layer_ordered as jax_assign
from tpureg.compat import caffe_layers as jax_caffe_layers
from tpureg.compat import caffe_weights_biases as jax_weights_biases
from tpureg.compat import read_caffemodel as jax_read
from tpureg.reg import OpticalFlowReg as JaxOpticalFlowReg
from tpureg_torch.compat import (
    CAFFE_NETS,
    assign_layer_ordered,
    bgr_to_rgb_first_conv,
    caffe_layers,
    caffe_weights_biases,
    conv_walk,
    read_caffemodel,
    state_dict_from_jax,
)

SIZE = 64
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def blobs(rng, layers):
    """{name: [weight, bias]} of fp32 draws for (name, weight shape) pairs."""
    return {name: [rng.standard_normal(shape).astype(np.float32),
                   rng.standard_normal((shape[0],)).astype(np.float32)]
            for name, shape in layers}


# ---------------------------------------------------------------------------
# the reader


def test_the_reader_is_the_ports_own():
    import tpureg_torch.compat.caffe_reader as mod
    assert "tpureg." not in open(mod.__file__).read().replace("tpureg_torch.", "")
    assert CAFFE_NETS == JAX_CAFFE_NETS


@pytest.mark.parametrize("v1,legacy", [(False, False), (True, True), (True, False)])
def test_reader_matches_tpureg(tmp_path, v1, legacy):
    """Names, shapes and values from the modern (layer=100) and V1
    (layers=2) formats, legacy 4-D blob dims included; from a path and from
    bytes."""
    rng = np.random.default_rng(0)
    layers = {"conv1": [rng.standard_normal((8, 3, 5, 5)).astype(np.float32),
                        rng.standard_normal((8,)).astype(np.float32)],
              "relu1": [],
              "fc": [rng.standard_normal((4, 8)).astype(np.float32)],
              "deconv2": [rng.standard_normal((6, 2, 4, 4)).astype(np.float32),
                          rng.standard_normal((2,)).astype(np.float32)]}
    raw = encode_caffemodel(layers, v1=v1, legacy_blob=legacy)
    path = tmp_path / "net.caffemodel"
    path.write_bytes(raw)
    for source in (raw, str(path)):
        got, want = read_caffemodel(source), jax_read(source)
        assert list(got) == list(want) == ["conv1", "fc", "deconv2"]
        for k in want:
            assert len(got[k]) == len(want[k])
            for g, w in zip(got[k], want[k]):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
    (gw, gb), (ww, wb) = caffe_weights_biases(raw), jax_weights_biases(raw)
    assert list(gw) == list(ww) and list(gb) == list(wb)
    for k in ww:
        np.testing.assert_array_equal(gw[k], ww[k])
        np.testing.assert_array_equal(gb[k], wb[k])


@pytest.mark.parametrize("net", sorted(JAX_CAFFE_NETS))
def test_caffe_layers_match_tpureg(net):
    """Every net's ordered (weight, bias) pairs, with its stem flips and
    prefix quirks."""
    rng = np.random.default_rng(1)
    keys, prefix, double_up, _ = CAFFE_NETS[net]
    names = [prefix + prefix + k if double_up and "upsample" in k else prefix + k
             for k in keys]
    raw = encode_caffemodel(blobs(rng, [(n, (6, 12 if i == 0 else 4, 3, 3))
                                        for i, n in enumerate(names)]))
    got, want = caffe_layers(raw, net), jax_caffe_layers(raw, net)
    assert len(got) == len(want) == len(keys)
    for (gw, gb), (ww, wb) in zip(got, want):
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(gb, wb)
    with pytest.raises(KeyError, match="missing layers"):
        caffe_layers(encode_caffemodel({"conv1": [np.ones((1, 1, 1, 1), np.float32)]}), net)
    with pytest.raises(ValueError, match="unknown caffe net"):
        caffe_layers(raw, "alexnet")


def test_bgr_flip_matches_tpureg():
    from tpureg.compat import bgr_to_rgb_first_conv as jax_flip
    w = np.random.default_rng(2).standard_normal((4, 3, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(bgr_to_rgb_first_conv(w), jax_flip(w))


# ---------------------------------------------------------------------------
# the assignment, against tpureg's through the bridge


def assert_assigned_as_tpureg(module, params, stats, pairs, flip=False, prefix=()):
    """tpureg assigns into ``params`` and the port into ``module`` (holding
    the same weights): equal reports in length and equal weights, bit for
    bit, after the bridge."""
    new, jax_report = jax_assign(params, pairs, flip_first_bgr=flip)
    _, report = assign_layer_ordered(module, pairs, flip_first_bgr=flip)
    assert len(report) == len(jax_report)
    assert [line.split()[0] for line in report] == [line.split()[0] for line in jax_report]
    want = state_dict_from_jax(jax.tree.map(np.asarray, new), stats, prefix=prefix)
    got = module.state_dict()
    assert set(want) <= set(got)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    return report


class Toy(nn.Module):
    """Convolutions defined in the order b, a, conv10, conv2; tpureg's walk
    takes them in the order a, b, conv10, conv2."""

    def __init__(self):
        super().__init__()
        self.b = nn.Conv2d(4, 6, 3)
        self.a = nn.Conv2d(11, 6, 3)
        self.conv10 = nn.Conv2d(6, 5, 1)
        self.conv2 = nn.Conv2d(5, 5, 3)


def toy_params(module):
    """The flax tree of ``module``'s weights (HWIO kernels), in its
    definition order."""
    return {name: {"kernel": m.weight.detach().numpy().transpose(2, 3, 1, 0).copy(),
                   "bias": m.bias.detach().numpy().copy()}
            for name, m in module.named_children()}


def test_toy_tree_of_test_compat():
    """tests/test_compat.py:289's tree (two convolutions c0, c1) from the
    fusion net's caffe layers: the first two layers land, biases included,
    and a third has no kernel to go to."""
    torch.manual_seed(0)
    toy = nn.Module()
    toy.c0, toy.c1 = nn.Conv2d(11, 6, 3), nn.Conv2d(4, 6, 3)
    rng = np.random.default_rng(3)
    keys, prefix, _, _ = CAFFE_NETS["flownetfusion"]
    pairs = caffe_layers(encode_caffemodel(blobs(
        rng, [(prefix + k, (6, 11 if i == 0 else 4, 3, 3)) for i, k in enumerate(keys)])),
        "flownetfusion")
    report = assert_assigned_as_tpureg(toy, toy_params(toy), None, pairs)
    assert report == ["layer 0 -> c0.weight (6, 11, 3, 3)",
                      "layer 1 -> c1.weight (6, 4, 3, 3)"]
    np.testing.assert_array_equal(toy.c1.weight.detach().numpy(), pairs[1][0])
    np.testing.assert_array_equal(toy.c1.bias.detach().numpy(), pairs[1][1])


def test_assignment_follows_tpureg_sorted_walk():
    """Defined as b, a, conv10, conv2, walked as a, b, conv10, conv2
    (``jax.tree.map`` sorts the keys): layer 0 goes to ``a``. A stem flip
    reverses the first layer's input channels."""
    torch.manual_seed(1)
    toy = Toy()
    assert [k for k, _ in conv_walk(toy)] == ["a.weight", "b.weight",
                                              "conv10.weight", "conv2.weight"]
    rng = np.random.default_rng(4)
    pairs = [(rng.standard_normal(s).astype(np.float32),
              rng.standard_normal((s[0],)).astype(np.float32))
             for s in ((6, 11, 3, 3), (6, 4, 3, 3), (5, 6, 1, 1), (5, 5, 3, 3))]
    params = toy_params(toy)
    assert list(params) == ["b", "a", "conv10", "conv2"]
    report = assert_assigned_as_tpureg(toy, params, None, pairs, flip=True)
    assert len(report) == 4
    np.testing.assert_array_equal(toy.a.weight.detach().numpy(), pairs[0][0][:, ::-1])
    np.testing.assert_array_equal(toy.conv10.bias.detach().numpy(), pairs[2][1])


def test_assignment_stops_at_a_misfit_as_tpureg():
    torch.manual_seed(2)
    toy = Toy()
    rng = np.random.default_rng(5)
    pairs = [(rng.standard_normal(s).astype(np.float32), None)
             for s in ((6, 11, 3, 3), (6, 5, 3, 3), (5, 6, 1, 1))]
    before = toy.conv10.weight.detach().clone()
    report = assert_assigned_as_tpureg(toy, toy_params(toy), None, pairs)
    assert report[-1] == "stop at layer 1 (b.weight): (6, 5, 3, 3) != (6, 4, 3, 3)"
    assert torch.equal(toy.conv10.weight, before)


# the caffe layer's module in the port (and the reference)
def caffe_module(net, key):
    if m := re.fullmatch(r"_Convolution(\d)", key):  # fusion: 5, 6, 7 -> 2, 1, 0
        return f"predict_flow{7 - int(m.group(1))}"
    if m := re.fullmatch(r"Convolution(\d)", key):
        return f"predict_flow{7 - int(m.group(1))}"
    if m := re.fullmatch(r"predict_conv(\d)", key):
        return f"predict_flow{m.group(1)}"
    if m := re.fullmatch(r"upsample_flow(\d)to(\d)", key):
        return f"upsampled_flow{m.group(1)}_to_{m.group(2)}"
    return key.replace("interconv", "inter_conv")


# net -> (registry name of the head, the net's path in the predictor, the
# first index where tpureg's walk and the caffe order part, the caffe layer
# there, the port's layer there)
FIRST_PARTING = {
    "flownetc": ("flownetc", (), 3, "conv_redir", "conv3_1"),
    "flownets": ("flownet2-s", ("flownets",), 10, "deconv5", "deconv2"),
    "flownetsonly": ("flownet2-s", ("flownets",), 10, "deconv5", "deconv2"),
    "flownetsd": ("flownetsd", (), 13, "deconv5", "deconv2"),
    "flownetfusion": ("flownet2", ("flownetfusion",), 5, "deconv1", "deconv0"),
}


@pytest.fixture(scope="module")
def heads():
    cache = {}

    def get(name):
        if name not in cache:
            v = numpy_variables(JaxOpticalFlowReg(conv_predictor=name),
                                np.zeros((1, SIZE, SIZE, 2), np.float32), 40)
            cache[name] = (v, port_head(name, v))
        return cache[name]
    return get


@pytest.mark.parametrize("net", sorted(FIRST_PARTING))
def test_caffe_nets_assign_as_tpureg(heads, net):
    """Each net's caffemodel, with every blob in the shape of the caffe
    layer it names, into the net of the registry that holds it: the port
    and tpureg land the same layers, up to the first index where the
    sorted walk and the caffe order part, and stop there."""
    name, path, first, caffe_key, walk_key = FIRST_PARTING[net]
    (params, stats), head = heads(name)
    module = head.predictor
    for p in path:
        module = getattr(module, p)
    sub = lambda tree: tree["predictor"] if not path else tree["predictor"][path[0]]
    keys, prefix, double_up, _ = CAFFE_NETS[net]
    shapes = []
    for k in keys:
        mod = caffe_module(net, k)
        weight = dict(module.named_parameters()).get(f"{mod}.0.weight")
        if weight is None:
            weight = dict(module.named_parameters())[f"{mod}.weight"]
        shapes.append(tuple(weight.shape))
    names = [prefix + prefix + k if double_up and "upsample" in k else prefix + k
             for k in keys]
    rng = np.random.default_rng(6)
    pairs = caffe_layers(encode_caffemodel(
        {n: [rng.standard_normal(s).astype(np.float32),
             rng.standard_normal((s[1] if "deconv" in n or "upsample" in n
                                  else s[0],)).astype(np.float32)]
         for n, s in zip(names, shapes)}), net)
    walk = [k.split(".")[0] for k, _ in conv_walk(module)]
    assert caffe_module(net, keys[first]) == caffe_key.replace("interconv", "inter_conv")
    assert walk[first] == walk_key
    assert [caffe_module(net, k) for k in keys[:first]] == walk[:first]
    report = assert_assigned_as_tpureg(
        module, sub(params), sub(stats) if stats else None, pairs,
        prefix=())
    assert len(report) == first + 1 and report[-1].startswith(f"stop at layer {first} ")
