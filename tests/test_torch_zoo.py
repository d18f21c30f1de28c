"""The rest of tpureg_torch's 2-D zoo against tpureg's on the CPU: FlowNetS in
the Pinard style (the registry's default), FlowNetSFull, FlowNetCPinard, the
cascade's sub-variants (FlowNet2C, -S, -SD, -CS, -CSS), flownetc and
flownetsd. The registry, the weight bridge, each model's forward at 64²
through the registration head, one flownets train step against tpureg's
fp64 step, one bf16 eval step and both 2-D CLIs with ``--model flownets``.

Weights are numpy draws from a seed, laid into the parameter tree that
``jax.eval_shape`` gives for tpureg's module, with BatchNorm statistics that
are not the identity, and carried into the port by ``state_dict_from_jax``.
Each tpureg forward compiles once, on first use, in a module-scoped cache,
so a worker compiles only the models its tests need.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_refcache import refcache  # noqa: F401 (a fixture)
from test_torch_cli import TRAIN_TAGS, eval_tags, tb_records, work_path  # noqa: F401
from test_torch_elastic import write_analyze
from tpureg.compat.torch_export import export_torch_state_dict
from tpureg.models import FlowNetCPinard as JaxFlowNetCPinard
from tpureg.models import build_predictor as jax_build_predictor
from tpureg.reg import OpticalFlowReg as JaxOpticalFlowReg
from tpureg.train import make_eval_step as jax_make_eval_step
from tpureg.train import make_train_step as jax_make_train_step
from tpureg.train.state import RegTrainState
from tpureg_torch.compat import state_dict_from_jax
from tpureg_torch.models import (
    RAFT,
    FlowNet2,
    FlowNet2C,
    FlowNet2CS,
    FlowNet2CSS,
    FlowNet2S,
    FlowNet2SD,
    FlowNetC,
    FlowNetCPinard,
    FlowNetS,
    FlowNetSD,
    FlowNetSFull,
    PWCDCNet,
    PWCDCNetOld,
    build_predictor,
)
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.train import (
    best_weight_path,
    create_train_state,
    make_eval_step,
    make_train_step,
    training_state_path,
)
from tpureg_torch.train.steps import _loss_terms

SIZE, BATCH = 64, 2
TERMS = ("loss", "photo_loss", "corr_loss", "smooth_loss")
# the registry names whose models run through the head, new in this slice
HEAD_NAMES = ("flownets", "flownets-full", "flownet2-c", "flownet2-s",
              "flownet2-sd", "flownet2-cs", "flownet2-css", "flownetc",
              "flownetsd")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def pair_batch(seed, b, size):
    """Smooth fixed/moving images in [0, 1] and 4-label segmentations."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    imgs = np.empty((b, size, size, 2), np.float32)
    for i in range(b):
        for ch in range(2):
            cx, cy, r = rng.uniform(0.3, 0.7, 3)
            imgs[i, ..., ch] = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                                      / (0.1 + 0.1 * r))
    segs = np.floor(imgs * 3.999).astype(np.float32)
    return imgs, segs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one thread, as in tests/test_torch_pwc.py:
    beside the suite's other workers more threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def numpy_variables(module, x, seed):
    """(params, batch_stats) shaped as ``module.init`` would make them,
    filled from ``seed``: kernels N(0, 2 / fan_in), biases N(0, 0.01²),
    running means N(0, 0.1²) and variances U(0.5, 1.5), so that a wrong
    bias, statistic or layout shows."""
    shapes = jax.eval_shape(lambda k, a: module.init(k, a, train=True),
                            jax.random.key(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "kernel":
            scale = np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
        else:
            scale = 0.1 if name == "mean" else 0.01
        return rng.standard_normal(leaf.shape, np.float32) * np.float32(scale)

    filled = jax.tree_util.tree_map_with_path(fill, shapes)
    return filled["params"], filled.get("batch_stats", {})


class Lazy(dict):
    """A dict that makes each missing entry with ``make(key)`` on first use."""

    def __init__(self, make):
        super().__init__()
        self.make = make

    def __missing__(self, key):
        self[key] = value = self.make(key)
        return value


@pytest.fixture(scope="module")
def trees():
    """tpureg variables by name: the registration head around each of
    HEAD_NAMES at 64², and "flownetc-pinard", its module alone on a
    6-channel pair."""
    imgs, _ = pair_batch(0, BATCH, SIZE)

    def make(name):
        seed = 10 + HEAD_NAMES.index(name) if name in HEAD_NAMES else 99
        if name == "flownetc-pinard":
            return numpy_variables(JaxFlowNetCPinard(),
                                   np.zeros((1, SIZE, SIZE, 6), np.float32), seed)
        return numpy_variables(JaxOpticalFlowReg(conv_predictor=name), imgs, seed)

    return Lazy(make)


def port_head(name, variables):
    """The port's head around ``name`` holding tpureg's ``variables``: built
    on the meta device (a random init of 40-160 M weights costs seconds
    here) and given the bridged tensors, strictly."""
    with torch.device("meta"):
        model = OpticalFlowReg(name)
    model.predictor.load_state_dict(state_dict_from_jax(*variables), strict=True,
                                    assign=True)
    return model


# ---------------------------------------------------------------------------
# the registry and the bridge

# name: the class tpureg builds, and the port's configuration check
REGISTRY = {
    "flownets": (FlowNetS, lambda m: m.style == "pinard"
                 and m.conv1[0].in_channels == 2 and m.predict_flow6.bias is None),
    "my-unknown-net": (FlowNetS, lambda m: m.style == "pinard"),
    "FlowNetS": (FlowNetS, lambda m: m.style == "pinard"),
    "flownets-full": (FlowNetSFull, lambda m: m.predict_flow0.in_channels == 20
                      and isinstance(m.conv1[1], torch.nn.BatchNorm2d)),
    "flownet2-c": (FlowNet2C, lambda m: isinstance(m.flownetc, FlowNetC)),
    "flownet2-s": (FlowNet2S, lambda m: m.flownets.style == "nvidia"
                   and m.flownets.conv1[0].in_channels == 2),
    "flownet2-sd": (FlowNet2SD, lambda m: isinstance(m.flownets_d, FlowNetSD)),
    "flownet2-cs": (FlowNet2CS, lambda m: m.cascade.blocks == ["flownets_1"]),
    "flownet2-css": (FlowNet2CSS, lambda m: m.cascade.blocks
                     == ["flownets_1", "flownets_2"]),
    "flownetc": (FlowNetC, lambda m: m.conv1[0].in_channels == 1),
    "flownet2-nhwc": (FlowNet2, lambda m: True),
    "flownet2": (FlowNet2, lambda m: True),
    "flownetc-pinard": (FlowNetCPinard, lambda m: m.conv1[0].in_channels == 3
                        and m.predict_flow6.bias is None),
    "flownetsd": (FlowNetSD, lambda m: True),
    "pwc-old": (PWCDCNetOld, lambda m: True),
    "pwc-bilinear": (PWCDCNet, lambda m: not m.feed_warped),
    "pwc-reg": (PWCDCNet, lambda m: m.feed_warped),
    "raft-reg": (RAFT, lambda m: m.feed_warped and m.downsample == 4),
    "raft-pwc": (RAFT, lambda m: not m.feed_warped and m.downsample == 8),
}


@pytest.mark.parametrize("name", list(REGISTRY))
def test_registry_builds_what_tpureg_builds(name):
    """Every name of tpureg's explicit registry, "flownets", unknown names,
    "flownet2-nhwc" and "raft-pwc" ("raft" is matched before "pwc") build
    the class tpureg builds, in its configuration; no name raises. (The
    four FlowNet names "flownets", "flownet2-c", "flownetc" and
    "flownets-full" raised ``NotImplementedError`` before this slice.)"""
    kind, configured = REGISTRY[name]
    with torch.device("meta"):
        net = build_predictor(name)
    assert type(net) is kind
    assert type(jax_build_predictor(name)).__name__ == kind.__name__
    assert configured(net)


def test_registry_covers_tpureg_explicit_names():
    from tpureg.models import _EXPLICIT

    assert set(_EXPLICIT) <= set(REGISTRY)


@pytest.mark.parametrize("name", HEAD_NAMES + ("flownetc-pinard",))
def test_bridge_fills_zoo_strictly_as_tpureg_exports(trees, name):
    """``state_dict_from_jax`` fills the port's net with strict=True and
    equals tpureg's ``export_torch_state_dict`` key for key and bit for bit:
    Pinard's unbiased heads and ``deconv{l}.0``, FlowNetSFull's levels 1 and
    0, the ``cascade.`` prefix."""
    params, stats = trees[name]
    with torch.device("meta"):
        port = build_predictor(name)
    prefix = () if name == "flownetc-pinard" else ("predictor",)
    sd = state_dict_from_jax(params, stats, prefix=prefix)
    result = port.load_state_dict(sd, strict=True, assign=True)
    assert not result.missing_keys and not result.unexpected_keys
    want, report = export_torch_state_dict(params, port.state_dict().keys(),
                                           stats, prefix=prefix)
    assert not report["missing"] and set(sd) == set(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(want[k]), err_msg=k)
    if name in ("flownets", "flownets-full", "flownetc-pinard"):
        assert not any(k.endswith(".bias") and k.startswith(
            ("predict_flow", "deconv", "upsampled_flow")) for k in sd)
        assert "deconv2.0.weight" in sd
    if name == "flownets-full":
        assert sd["predict_flow0.weight"].shape == (2, 20, 3, 3)
        assert sd["deconv0.0.weight"].shape == (98, 16, 4, 4)
    if name.startswith("flownet2-c"):
        assert any(k.startswith("cascade.flownetc.") for k in sd) == (
            name != "flownet2-c")


# ---------------------------------------------------------------------------
# forward parity at 64² through the head

def assert_close(got, want, err_msg=""):
    """fp32 accumulation-order noise between XLA:CPU and torch/MKL
    convolutions through 10-60 layers: 5e-4 abs / 1e-3 rel, the tolerance
    of tests/test_torch_models.py and test_torch_pwc.py."""
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=5e-4,
                               rtol=1e-3, err_msg=err_msg)


# the modes each model is held in: train mode where its outputs differ in
# kind from eval mode's (flownets: flow0 and five scales; the cascade: the
# last S block's raw flows)
MODES = {name: (False,) for name in HEAD_NAMES}
MODES.update({"flownets": (False, True), "flownet2-css": (False, True)})
HEAD_CASES = [(n, t) for n in HEAD_NAMES for t in MODES[n]]


@pytest.fixture(scope="module")
def head_outputs(refcache, trees):  # noqa: F811
    """tpureg's head around each model on one batch, in the modes of MODES
    (one compile a model, on first use, once a session), and the batch."""
    imgs, segs = pair_batch(1, BATCH, SIZE)

    def run(params, stats, a, s, train, jmodel):
        v = {"params": params, "batch_stats": stats}
        if train:
            return jmodel.apply(v, a, s, train=True, mutable=["batch_stats"])[0]
        return jmodel.apply(v, a, s, train=False)

    def make(name):
        jmodel = JaxOpticalFlowReg(conv_predictor=name)
        return refcache(f"zoo_head_{name}", lambda: jax.jit(
            lambda p, st, a, s: tuple(run(p, st, a, s, t, jmodel) for t in MODES[name]))(
            *trees[name], jnp.asarray(imgs), jnp.asarray(segs)))

    return Lazy(make), imgs, segs


@pytest.mark.parametrize("name,train", HEAD_CASES,
                         ids=[f"{n}-{'train' if t else 'eval'}" for n, t in HEAD_CASES])
def test_head_forward_matches_tpureg(trees, head_outputs, name, train):
    """Every flow, warped image, the warped segmentation and the warped grid
    through ``OpticalFlowReg``; in train mode BatchNorm normalises by the
    batch."""
    outputs, imgs, segs = head_outputs
    want = outputs[name][MODES[name].index(train)]
    model = port_head(name, trees[name]).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), torch.from_numpy(segs))
    assert len(got[0]) == len(want[0]) and len(got[1]) == len(want[1])
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert_close(g.numpy(), w, f"flow{i}")
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        assert_close(g.numpy(), w, f"warped{i}")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert_close(got[3].numpy(), want[3], "grid")
    shapes = [tuple(f.shape[1:3]) for f in got[0]]
    if name == "flownets":
        assert shapes == ([(64, 64), (16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
                          if train else [(64, 64), (16, 16)])
        # flow0 is flow2 resized, its values not rescaled
        up = torch.nn.functional.interpolate(
            got[0][1].permute(0, 3, 1, 2), size=(SIZE, SIZE), mode="bilinear",
            align_corners=False)
        torch.testing.assert_close(got[0][0], up.permute(0, 2, 3, 1))
    elif name == "flownets-full":
        assert shapes == [(SIZE >> i, SIZE >> i) for i in range(7)]
    elif train:
        assert shapes == [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    else:  # the bare subnets return flow2, the cascade's variants it ×4
        assert shapes == [(16, 16) if name in ("flownetc", "flownetsd")
                          else (SIZE, SIZE)]


@pytest.fixture(scope="module")
def pinard_c_outputs(refcache, trees):  # noqa: F811
    """tpureg's FlowNetCPinard on a 6-channel pair in eval and train mode
    (one compile, once a session), and the pair."""
    def compute():
        x = np.random.default_rng(8).uniform(0, 1, (BATCH, SIZE, SIZE, 6)).astype(
            np.float32)
        params, stats = trees["flownetc-pinard"]
        net = JaxFlowNetCPinard()
        v = {"params": params, "batch_stats": stats}
        want = jax.jit(lambda v, a: (
            net.apply(v, a, train=False),
            net.apply(v, a, train=True, mutable=["batch_stats"])[0]))(v, jnp.asarray(x))
        return want, x

    return refcache("zoo_pinard_c_outputs", compute)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_flownetc_pinard_forward_matches_tpureg(trees, pinard_c_outputs, train):
    """The Pinard FlowNetC on a 6-channel pair, at the module level (the
    head feeds 2 channels): train mode gives (flow2, ..., flow6), eval mode
    (flow2,)."""
    outputs, x = pinard_c_outputs
    want = outputs[int(train)]
    with torch.device("meta"):
        net = FlowNetCPinard()
    net.load_state_dict(state_dict_from_jax(*trees["flownetc-pinard"], prefix=()),
                        strict=True, assign=True)
    with torch.no_grad():
        got = net.train(train)(nchw(x))
    assert isinstance(got, tuple) and len(got) == len(want) == (5 if train else 1)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(nhwc(g), w, f"flow{i + 2}")


# ---------------------------------------------------------------------------
# one flownets train step against tpureg's fp64 step; one bf16 eval step

def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def jax_state(params, stats, tx=None):
    return RegTrainState.create(
        apply_fn=JaxOpticalFlowReg(conv_predictor="flownets").apply,
        params=params, tx=tx or optax.adam(1e-4, eps=1e-4), batch_stats=stats)


@pytest.fixture(scope="module")
def train_steps(refcache, trees):  # noqa: F811
    """One tpureg step in fp64 and one port step in fp32 from the same
    flownets weights and statistics and a fresh Adam state: (tpureg's
    metrics, gradient and updated state as port state dicts; the port's;
    the state dict before). Once a session."""
    return refcache("zoo_flownets_train_steps",
                          lambda: _train_steps(trees))


def _train_steps(trees):
    imgs, _ = pair_batch(2, BATCH, SIZE)
    params, stats = trees["flownets"]
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        state, m = jax_make_train_step(donate=False)(
            jax_state(p64, stats), jnp.asarray(imgs, jnp.float64))
        get = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
        want = ({k: float(m[k]) for k in TERMS},
                state_dict_from_jax(get(jax.tree.map(lambda a: a / 0.1,
                                                     state.opt_state[0].mu))),
                state_dict_from_jax(get(state.params), get(state.batch_stats)))
    model = port_head("flownets", (params, stats))
    state = create_train_state(model)
    m = make_train_step(state)(torch.from_numpy(imgs))
    got = ({k: float(m[k]) for k in TERMS},
           {n.removeprefix("predictor."): p.grad.clone()
            for n, p in model.named_parameters()},
           {k: v.clone() for k, v in model.predictor.state_dict().items()})
    return want, got, state_dict_from_jax(params, stats)


def test_flownets_train_step_losses_match_tpureg_fp64(train_steps):
    """fp32 sums over six scales against fp64: 1e-5 relative."""
    want, got, _ = train_steps
    for k in TERMS:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5, err_msg=k)


def test_flownets_train_step_gradients_match_tpureg_fp64(train_steps):
    """The port's fp32 gradient against tpureg's fp64 one (its first Adam
    moment over 1 - b1), by the rule of the FlowNet2 and pwc-reg steps'
    tests: per tensor ≤ 3e-2 relative L2 and ≤ 1e-2 over the model."""
    want, got, _ = train_steps
    assert set(got[1]) == set(want[1])
    worst = max((rel_l2(got[1][k], want[1][k]), k) for k in want[1])
    assert worst[0] <= 3e-2, worst
    diff2 = sum(float(((got[1][k].double() - want[1][k].double()) ** 2).sum())
                for k in want[1])
    ref2 = sum(float((want[1][k].double() ** 2).sum()) for k in want[1])
    assert (diff2 / ref2) ** 0.5 <= 1e-2


def test_flownets_train_step_gradients_match_tpureg_in_fp64(trees, train_steps):
    """The port in fp64 against tpureg in fp64, from the same weights and
    batch: per tensor ≤ 3e-3 relative L2, the FlowNet2 step's bound. The
    residual is the fp32 loss that both keep under fp64."""
    want = train_steps[0][1]
    imgs, _ = pair_batch(2, BATCH, SIZE)
    model = port_head("flownets", trees["flownets"]).double().train()
    _, metrics = _loss_terms(model, torch.from_numpy(imgs).double(), None, {}, None)
    params = dict(model.named_parameters())
    got = dict(zip(params, torch.autograd.grad(metrics["loss"],
                                               list(params.values()))))
    worst = max((rel_l2(got["predictor." + k], want[k]), k) for k in want)
    assert worst[0] <= 3e-3, worst


def test_flownets_train_step_updates_match_tpureg_fp64(train_steps):
    """The updated weights against tpureg's: the update's relative L2 ≤ 0.05
    and ≤ 1% of the elements further apart than 1e-6 (Adam moves each
    element by about ±lr whatever |g| is, so an element whose gradient is
    within rounding of zero may step the other way); the running statistics
    within 1e-5 relative L2 (flax's momentum 0.9 and biased variance)."""
    want, got, before = train_steps
    diff2 = ref2 = 0.0
    far = total = 0
    stats = ("running_mean", "running_var", "num_batches_tracked")
    for k in want[2]:
        if k.endswith(stats):
            continue
        d = got[2][k].double() - want[2][k].double()
        diff2 += float((d * d).sum())
        ref2 += float(((want[2][k].double() - before[k].double()) ** 2).sum())
        far += int((d.abs() > 1e-6).sum())
        total += d.numel()
    assert (diff2 / ref2) ** 0.5 <= 0.05
    assert far <= 0.01 * total, far / total
    for k in want[2]:
        if k.endswith(stats[:2]):
            assert rel_l2(got[2][k], want[2][k]) <= 1e-5, k


def test_flownets_bf16_eval_step_matches_tpureg(trees):
    """The bf16 eval step (weights and images cast, BatchNorm in fp32, the
    loss in fp32) against tpureg's bf16 eval step: the losses within 5e-3
    relative and flow0 within 5e-2 of its scale, as for pwc-reg (bf16 keeps
    8 bits through ~20 layers, rounded in another order on each side); and
    the warped segmentation's labels."""
    imgs, segs = pair_batch(3, BATCH, SIZE)
    params, stats = trees["flownets"]
    out, m = jax_make_eval_step(compute_dtype=jnp.bfloat16)(
        jax_state(params, stats), jnp.asarray(imgs), jnp.asarray(segs))
    model = port_head("flownets", (params, stats))
    (flows, _, wsegs, _), metrics = make_eval_step(
        model, compute_dtype=torch.bfloat16)(
        torch.from_numpy(imgs), torch.from_numpy(segs))
    assert flows[0].dtype == torch.bfloat16 and len(flows) == 2
    for k in TERMS:
        np.testing.assert_allclose(float(metrics[k]), float(m[k]), rtol=5e-3,
                                   err_msg=k)
    want = np.asarray(out[0][0], np.float32)
    err = np.abs(flows[0].float().numpy() - want).max()
    assert err <= 5e-2 * np.abs(want).max(), err
    assert set(np.unique(wsegs.float().numpy())) <= {0.0, 1.0, 2.0, 3.0}


# ---------------------------------------------------------------------------
# the correlation term at a constant warped scale

def test_correlation_loss_gradient_is_finite_at_a_constant_scale():
    """flownets at 64² predicts flow6 at 1×1; the head resizes the moving
    frame to it with align_corners=True, so that scale's warped image is the
    frame's corner, often 0 for every sample: a constant image, whose
    Pearson term tpureg guards in value but not in gradient (NaN; ROADMAP
    C9). The port's value equals tpureg's on both sides of the guard, and
    its gradient is 0 at the constant scale and tpureg's elsewhere."""
    from tpureg.losses.ofe import correlation_loss as jax_correlation_loss
    from tpureg_torch.losses.ofe import correlation_loss

    rng = np.random.default_rng(12)
    fixed = rng.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
    for warped in (np.zeros((2, 1, 1, 1), np.float32),
                   rng.uniform(0, 1, (2, 4, 4, 1)).astype(np.float32)):
        want, jgrad = jax.value_and_grad(
            lambda w: jax_correlation_loss(jnp.asarray(fixed), w))(jnp.asarray(warped))
        w = nchw(warped).requires_grad_()
        got = correlation_loss(nchw(fixed), w)
        (grad,) = torch.autograd.grad(got, w)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        if warped.shape[1] == 1:
            assert np.isnan(np.asarray(jgrad)).all() and not grad.any()
        else:
            np.testing.assert_allclose(nhwc(grad), np.asarray(jgrad), atol=1e-6)


# ---------------------------------------------------------------------------
# both 2-D CLIs

def test_cli_trains_resumes_and_evaluates_flownets(work_path, capsys, tb_records):  # noqa: F811
    """The training CLI trains flownets on 2 random batches at 64², writes
    its state and best weights under ``FlowNetS``, resumes with ``--cp 1``;
    the inference CLI loads those weights and scores ``--mode synthetic``."""
    from tpureg_torch.cli.inference import main as infer
    from tpureg_torch.cli.train import main as train

    work = str(work_path)
    args = ["--model", "flownets", "--synthetic", "2", "--image_size", "64",
            "--batch_size", "2", "--workdir", work, "--logdir",
            str(work_path / "log")]
    state = train(args + ["--epochs", "1", "--cp", "0"], device="cpu")
    out = capsys.readouterr().out
    assert "EPOCH 1/1" in out and "saving new best weights" in out
    assert state.step == 2
    for path in (training_state_path(work, "FlowNetS"),
                 best_weight_path(work, "FlowNetS")):
        assert os.path.isfile(path), path
    state = train(args + ["--epochs", "2", "--cp", "1"], device="cpu")
    out = capsys.readouterr().out
    assert "loading checkpoint state" in out and "EPOCH 1/2" not in out
    assert state.step == 4

    rng = np.random.default_rng(9)
    for d in ("img", "seg"):
        (work_path / d).mkdir()
    shape = (24, 30, 142)
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n) for n in shape), indexing="ij")
    for i in range(2):
        r = np.sqrt((x - rng.uniform(-.1, .1)) ** 2 + y ** 2 + (z / 2.5) ** 2)
        seg = np.select([r < 0.35, r < 0.6, r < 0.85], [3, 2, 1], 0)
        write_analyze(str(work_path / "img" / f"s{i}_mpr"),
                      seg * 200 + rng.normal(0, 10, shape))
        write_analyze(str(work_path / "seg" / f"s{i}_seg"), seg)
    results = infer([
        "--mode", "synthetic", "--model", "flownets", "--batch_size", "1",
        "--img_dir", str(work_path / "img"), "--seg_dir", str(work_path / "seg"),
        "--workdir", work, "--logdir", str(work_path / "log_eval"),
        "--max_samples", "2",
    ], device="cpu")
    out = capsys.readouterr().out
    assert "loaded best weights" in out and "===> EVAL summary" in out
    for key in ("loss", "dice", "mse", "psnr", "ssim_img", "mag", "neg_jac"):
        assert key in results and np.isfinite(results[key]), key
    # two training runs and one evaluation, each with tpureg's tags
    assert [w.tags() for w in tb_records] == [TRAIN_TAGS, TRAIN_TAGS, eval_tags()]
    assert all(w.closed for w in tb_records)
