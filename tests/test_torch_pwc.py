"""The PWC-Net family of tpureg_torch against tpureg's on the CPU: the "pwc"
warp and its validity mask, the weight bridge, the registry, the forward of
pwc, pwc-reg and pwc-old at 64², the head's stn warp at PWC's seven flow
sizes, one pwc-reg train step against tpureg's fp64 step, one bf16 eval step
and both 2-D CLIs with ``--model pwc-reg``.

Weights are numpy draws from a seed, laid into the parameter tree that
``jax.eval_shape`` gives for tpureg's module (an XLA compile of tpureg's
init costs ~15 s a model here), and carried into the port by
``state_dict_from_jax``. tpureg's train step compiles once, in a module
fixture.
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
from tpureg.models import PWCDCNetOld as JaxPWCDCNetOld
from tpureg.models.pwcnet import _bilinear_up_init as jax_bilinear_up_init
from tpureg.ops.warp import warp2d as jax_warp2d
from tpureg.reg import OpticalFlowReg as JaxOpticalFlowReg
from tpureg.reg.head import stn_warp as jax_stn_warp
from tpureg.train import make_eval_step as jax_make_eval_step
from tpureg.train import make_train_step as jax_make_train_step
from tpureg.train.state import RegTrainState
from tpureg_torch.compat import state_dict_from_jax
from tpureg_torch.models import (
    FlowNet2,
    PWCDCNet,
    PWCDCNetOld,
    build_predictor,
)
from tpureg_torch.models.pwcnet import _bilinear_up_init
from tpureg_torch.nn.layers import TorchConvTranspose, init_module_
from tpureg_torch.ops.warp import warp2d
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.reg.head import stn_warp
from tpureg_torch.train import (
    best_weight_path,
    create_train_state,
    default_loss_kwargs,
    make_eval_step,
    make_train_step,
    training_state_path,
)
from tpureg_torch.train.steps import _loss_terms

SIZE, BATCH = 64, 2
TERMS = ("loss", "photo_loss", "corr_loss", "smooth_loss")
LOSS_KWARGS = default_loss_kwargs("pwc-reg")  # the finest 2 flows


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
    """The port's side runs on one thread. At these sizes more threads gain
    little (the CLI test: 8.5 s on 8 threads, 6.6 s on one), and beside the
    suite's other workers they oversubscribe the cores: in a whole run on 6
    workers the CLI test took 199 s."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def numpy_params(module, x, seed):
    """A parameter tree shaped as ``module.init`` would make it, filled from
    ``seed``: kernels N(0, 2 / fan_in) (the package's kaiming), biases
    N(0, 0.01²), so that a wrong bias or layout shows."""
    shapes = jax.eval_shape(lambda k, a: module.init(k, a, train=True),
                            jax.random.key(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape)
                    * np.sqrt(2.0 / fan_in)).astype(np.float32)
        return (rng.standard_normal(leaf.shape) * 0.01).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def trees():
    """tpureg parameter trees: the registration head around pwc and pwc-reg
    at 64², and PWCDCNetOld alone on a 6-channel pair."""
    imgs, _ = pair_batch(0, BATCH, SIZE)
    out = {name: numpy_params(JaxOpticalFlowReg(conv_predictor=name), imgs, i)
           for i, name in enumerate(("pwc", "pwc-reg"))}
    out["pwc-old"] = numpy_params(JaxPWCDCNetOld(),
                                  np.zeros((1, SIZE, SIZE, 6), np.float32), 2)
    return out


def port_head(name, params):
    model = OpticalFlowReg(name)
    model.predictor.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


# ---------------------------------------------------------------------------
# the "pwc" warp and its validity mask

# a ones image sampled half a pixel or less off the left edge at row y and
# x = 0 gives 1 - δ: straddling 0.9999 (1e-4), 0.999 (1e-3) and the bf16 cut
# (1 - δ rounds to 1.0 in bf16 above 0.998046875, δ < 1.953e-3)
DELTAS = (2e-5, 5e-5, 8e-5, 1.2e-4, 1.5e-4, 4e-4, 8e-4, 1.2e-3, 1.5e-3,
          1.9e-3, 2.1e-3, 3e-3)


def straddling_flow(seed, b, h, w):
    """N(0, 1.5²) px, and at column 0 of rows 0..11 the flow that puts the
    sample at (x, y) = (-δ, row) under the "pwc" positions
    p = (flow + xy)·size/(size-1) - 0.5."""
    flow = np.random.default_rng(seed).normal(0, 1.5, (b, h, w, 2))
    for row, delta in enumerate(DELTAS):
        flow[:, row, 0, 0] = (-delta + 0.5) * (w - 1) / w
        flow[:, row, 0, 1] = (row + 0.5) * (h - 1) / h - row
    return flow.astype(np.float32)


@pytest.mark.parametrize("threshold", [0.9999, 0.999])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pwc_warp_matches_tpureg(dtype, threshold):
    """Output and mask against ``tpureg.ops.warp.warp2d(convention="pwc",
    return_mask=True)``: masks equal in both dtypes; outputs within 1e-6 in
    fp32 (measured 3.9e-7: XLA and torch round the fp32 taps' sum in another
    order) and equal in bf16 (measured equal: the rounding to bf16 absorbs
    that, and both multiply by 0 or 1). The cut itself: in fp32 each threshold is met
    between the δ on either side of 1 - threshold; in bf16 the sample is
    rounded and compared in bf16, where 0.9999 and 0.999 round to 1.0, so
    both thresholds cut at the rounding midpoint 0.998046875."""
    b, c, h, w = 2, 3, 16, 16
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    flow = straddling_flow(5, b, h, w)
    jdt = jnp.dtype(dtype)
    want, wmask = jax.jit(lambda i, f: jax_warp2d(
        i, f, "pwc", return_mask=True, mask_threshold=threshold))(
        jnp.asarray(img, jdt), jnp.asarray(flow))
    got, mask = warp2d(nchw(img).to(getattr(torch, dtype)), nchw(flow), "pwc",
                       return_mask=True, mask_threshold=threshold)
    assert got.dtype == mask.dtype == getattr(torch, dtype)
    assert mask.shape == (b, 1, h, w)
    want_mask = np.asarray(wmask, np.float32)
    np.testing.assert_array_equal(np.broadcast_to(nhwc(mask), want_mask.shape),
                                  want_mask)
    atol = 1e-6 if dtype == "float32" else 0.0
    np.testing.assert_allclose(nhwc(got), np.asarray(want, np.float32), atol=atol,
                               rtol=0)
    cut = 1 - threshold if dtype == "float32" else 1 - 0.998046875
    edge = nhwc(mask)[:, :len(DELTAS), 0, 0]
    expect = np.array([d < cut for d in DELTAS], np.float32)
    np.testing.assert_array_equal(edge, np.broadcast_to(expect, edge.shape))
    assert 0 < expect.sum() < len(DELTAS)


def test_pwc_mask_takes_no_gradient():
    """The mask has no autograd history (its sample's positions are
    detached, as tpureg's ``where`` passes no gradient), and the warp's
    cotangents to image and flow equal ``jax.vjp`` of tpureg's warp within
    1e-5 (measured 1.1e-6)."""
    b, c, h, w = 2, 3, 16, 16
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    flow = straddling_flow(7, b, h, w)
    cot = rng.standard_normal((b, h, w, c)).astype(np.float32)
    want_img, want_flow = jax.jit(lambda i, f, g: jax.vjp(
        lambda a, b: jax_warp2d(a, b, "pwc"), i, f)[1](g))(
        jnp.asarray(img), jnp.asarray(flow), jnp.asarray(cot))
    timg = nchw(img).requires_grad_()
    tflow = nchw(flow).requires_grad_()
    out, mask = warp2d(timg, tflow, "pwc", return_mask=True)
    assert mask.grad_fn is None and not mask.requires_grad
    assert 0 < float(mask.mean()) < 1
    gimg, gflow = torch.autograd.grad(out, (timg, tflow), nchw(cot))
    np.testing.assert_allclose(nhwc(gimg), np.asarray(want_img), atol=1e-5)
    np.testing.assert_allclose(nhwc(gflow), np.asarray(want_flow), atol=1e-5)


# ---------------------------------------------------------------------------
# the bridge, the bilinear init and the registry

@pytest.mark.parametrize("name", ["pwc", "pwc-reg", "pwc-old"])
def test_bridge_fills_pwc_strictly_as_tpureg_exports(trees, name):
    """``state_dict_from_jax`` fills the port's net with strict=True and
    equals tpureg's ``export_torch_state_dict`` key for key and bit for bit
    (the bare ``deconvN``/``upfeatN`` transposed convolutions included)."""
    port = build_predictor(name)
    prefix = () if name == "pwc-old" else ("predictor",)
    sd = state_dict_from_jax(trees[name], prefix=prefix)
    result = port.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    want, report = export_torch_state_dict(trees[name], port.state_dict().keys(),
                                           prefix=prefix)
    assert not report["missing"] and set(sd) == set(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(want[k]), err_msg=k)
    bare = [k for k in sd if k.split(".")[0].startswith(("deconv", "upfeat"))]
    assert "deconv0.weight" in sd or name == "pwc-old"
    assert len(bare) >= 14 and all(sd[k].dim() in (1, 4) for k in bare)


@pytest.mark.parametrize("shape", [(4, 4, 2, 2), (4, 4, 3, 5)])
def test_bilinear_up_init_matches_tpureg(shape):
    """The gain-2 tent, identity over channels, in torch's (in, out, kh, kw)
    layout: tpureg's kernel through the bridge's inverse layout."""
    want = np.asarray(jax_bilinear_up_init(None, shape))
    want = np.flip(want.transpose(2, 3, 0, 1), axis=(2, 3))
    conv = init_module_(TorchConvTranspose(shape[2], shape[3]), _bilinear_up_init(),
                        lambda b, g: b.zero_())
    np.testing.assert_array_equal(conv.weight.detach().numpy(), want)


def test_bilinear_variant_starts_its_flow_upsamplers_bilinear():
    net = PWCDCNet(flow_up_init="bilinear",
                   generator=torch.Generator().manual_seed(0))
    tent = np.flip(np.asarray(jax_bilinear_up_init(None, (4, 4, 2, 2)))
                   .transpose(2, 3, 0, 1), axis=(2, 3))
    for lvl in (6, 5, 4, 3, 2, 1):
        np.testing.assert_array_equal(
            getattr(net, f"deconv{lvl}").weight.detach().numpy(), tent)
    assert not np.array_equal(net.deconv0.weight.detach().numpy(), tent)
    # a flow upsampler doubles a constant flow and its resolution
    with torch.no_grad():
        y = net.deconv6.weight.new_ones(1, 2, 4, 4)
        up = torch.nn.functional.conv_transpose2d(y, net.deconv6.weight, None, 2, 1)
    assert torch.allclose(up[..., 1:-1, 1:-1], torch.full_like(up[..., 1:-1, 1:-1], 2.0))


@pytest.mark.parametrize("name,kind,kwargs", [
    ("pwc", PWCDCNet, {"flow_up_init": "kaiming", "feed_warped": False}),
    ("PWC", PWCDCNet, {"flow_up_init": "kaiming", "feed_warped": False}),
    ("my-pwc-net", PWCDCNet, {"flow_up_init": "kaiming", "feed_warped": False}),
    ("pwc-bilinear", PWCDCNet, {"flow_up_init": "bilinear", "feed_warped": False}),
    ("pwc-reg", PWCDCNet, {"flow_up_init": "bilinear", "feed_warped": True}),
    ("pwc-old", PWCDCNetOld, {}),
    ("flownet2-pwc", FlowNet2, {}),
])
def test_registry_maps_pwc_names_as_tpureg(name, kind, kwargs):
    """tpureg's dispatch: explicit names, then "flownet2" before "raft" and
    "pwc"; the variant's weights tell which init and inputs it has."""
    from tpureg.models import build_predictor as jax_build_predictor

    net = build_predictor(name)
    assert type(net) is kind
    assert type(jax_build_predictor(name)).__name__ == kind.__name__
    if kind is PWCDCNet:
        tent = float(net.deconv6.weight.detach()[0, 0, 1, 1]) == 0.5625 * 2
        assert tent == (kwargs["flow_up_init"] == "bilinear")
        assert net.feed_warped == kwargs["feed_warped"]
        # pwc-reg's level-6 decoder also takes both 196-channel features
        assert net.conv6_0[0].in_channels == 81 + (392 if net.feed_warped else 0)


# ---------------------------------------------------------------------------
# forward parity at 64² (flow6 at 1 x 1)

def assert_close(got, want, err_msg=""):
    """fp32 accumulation-order noise between XLA:CPU and torch/MKL
    convolutions through ~30 layers: 5e-4 abs / 1e-3 rel, the tolerance of
    tests/test_torch_models.py (measured ≤ 1.1e-5 on flows up to 4.6 px)."""
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=5e-4,
                               rtol=1e-3, err_msg=err_msg)


@pytest.fixture(scope="module")
def head_outputs(refcache, trees):  # noqa: F811
    """tpureg's head around pwc and pwc-reg on one batch, in eval and train
    mode (one compile a model, once a session), and the batch."""
    def compute():
        imgs, segs = pair_batch(1, BATCH, SIZE)
        out = {}
        for name in ("pwc", "pwc-reg"):
            jmodel = JaxOpticalFlowReg(conv_predictor=name)
            out[name] = jax.jit(lambda p, a, s: tuple(
                jmodel.apply({"params": p}, a, s, train=t) for t in (False, True)))(
                trees[name], jnp.asarray(imgs), jnp.asarray(segs))
        return out, imgs, segs

    return refcache("pwc_head_outputs", compute)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["pwc", "pwc-reg"])
def test_head_forward_matches_tpureg(trees, head_outputs, name, train):
    """All 7 flows (64² down to 1²), the 7 warped images, the warped
    segmentation and the warped grid through ``OpticalFlowReg``."""
    outputs, imgs, segs = head_outputs
    want = outputs[name][int(train)]
    model = port_head(name, trees[name]).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), torch.from_numpy(segs))
    sizes = [SIZE >> i for i in range(7)]
    assert [f.shape[1] for f in got[0]] == sizes
    for i in range(7):
        assert_close(got[0][i].numpy(), want[0][i], f"flow{i}")
        assert_close(got[1][i].numpy(), want[1][i], f"warped{i}")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert_close(got[3].numpy(), want[3], "grid")


@pytest.fixture(scope="module")
def old_outputs(refcache, trees):  # noqa: F811
    """tpureg's PWCDCNetOld on a 6-channel pair in eval and train mode (one
    compile, once a session), and the pair."""
    def compute():
        x = np.random.default_rng(8).uniform(0, 1, (1, SIZE, SIZE, 6)).astype(
            np.float32)
        want = jax.jit(lambda p, a: tuple(
            JaxPWCDCNetOld().apply({"params": p}, a, train=t) for t in (False, True)))(
            trees["pwc-old"], jnp.asarray(x))
        return want, x

    return refcache("pwc_old_outputs", compute)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pwc_old_forward_matches_tpureg(trees, old_outputs, train):
    """The legacy net on a 6-channel pair: train mode gives (flow2, ...,
    flow6), eval mode the bare flow2."""
    outputs, x = old_outputs
    want = outputs[int(train)]
    net = PWCDCNetOld()
    net.load_state_dict(state_dict_from_jax(trees["pwc-old"], prefix=()),
                        strict=True)
    with torch.no_grad():
        got = net.train(train)(nchw(x))
    if train:
        assert isinstance(got, tuple) and len(got) == len(want) == 5
    else:
        assert isinstance(got, torch.Tensor)
        got, want = (got,), (want,)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(nhwc(g), w, f"flow{i + 2}")


@pytest.mark.parametrize("size", [256, 128, 64, 32, 16, 8, 4])
def test_stn_warp_matches_tpureg_at_pwc_flow_sizes(size):
    """The head resizes the moving frame (bilinear, align_corners=True) to
    each of PWC's flow sizes at 256² and warps it there: within 1e-5
    (measured ≤ 3.5e-6)."""
    rng = np.random.default_rng(size)
    frame, _ = pair_batch(size, BATCH, 256)
    frame = frame[..., 1:2] + rng.normal(0, 0.05, frame[..., 1:2].shape).astype(
        np.float32)
    flow = rng.normal(0, 1.5, (BATCH, size, size, 2)).astype(np.float32)
    want = jax.jit(jax_stn_warp)(jnp.asarray(flow), jnp.asarray(frame))
    got = stn_warp(nchw(flow), nchw(frame))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# one train step against tpureg's fp64 step; one bf16 eval step

def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def jax_state(params, tx=None):
    return RegTrainState.create(
        apply_fn=JaxOpticalFlowReg(conv_predictor="pwc-reg").apply, params=params,
        tx=tx or optax.adam(1e-4, eps=1e-4), batch_stats={})


@pytest.fixture(scope="module")
def train_steps(refcache, trees):  # noqa: F811
    """One tpureg step in fp64 and one port step in fp32 from the same
    pwc-reg weights and a fresh Adam state: (tpureg's metrics, gradient and
    updated weights as port state dicts; the port's metrics, gradient and
    updated weights; the weights before). Once a session."""
    return refcache("pwc_reg_train_steps",
                          lambda: _train_steps(trees))


def _train_steps(trees):
    imgs, _ = pair_batch(2, BATCH, SIZE)
    params = trees["pwc-reg"]
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        state, m = jax_make_train_step(loss_kwargs=LOSS_KWARGS, donate=False)(
            jax_state(p64), jnp.asarray(imgs, jnp.float64))
        get = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
        want = ({k: float(m[k]) for k in TERMS},
                state_dict_from_jax(get(jax.tree.map(lambda a: a / 0.1,
                                                     state.opt_state[0].mu))),
                state_dict_from_jax(get(state.params)))
    model = port_head("pwc-reg", params)
    state = create_train_state(model)
    m = make_train_step(state, loss_kwargs=LOSS_KWARGS)(torch.from_numpy(imgs))
    got = ({k: float(m[k]) for k in TERMS},
           {n.removeprefix("predictor."): p.grad.clone()
            for n, p in model.named_parameters()},
           {k: v.clone() for k, v in model.predictor.state_dict().items()})
    return want, got, state_dict_from_jax(params)


def test_train_step_losses_match_tpureg_fp64(train_steps):
    """fp32 sums over the finest two scales against fp64: 1e-5 relative
    (measured 2.3e-7)."""
    want, got, _ = train_steps
    for k in TERMS:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5, err_msg=k)


def test_train_step_gradients_match_tpureg_fp64(train_steps):
    """The port's fp32 gradient against tpureg's fp64 one (its first Adam
    moment over 1 - b1), by the rule and tolerances of the FlowNet2 step's
    test: per tensor ≤ 3e-2 relative L2 (measured 1.0e-2, the bias of
    ``predict_flow4``, whose gradient is a sum over every pixel of its
    level; tpureg's own fp32 gradient lay 8.8e-4 from its fp64 one on
    another batch) and ≤ 1e-2 over the model (measured 7.4e-5). ``deconv0``,
    built and never called, has a zero gradient on both sides."""
    want, got, _ = train_steps
    assert set(got[1]) == set(want[1])
    keys = [k for k in want[1] if not k.startswith("deconv0.")]
    worst = max((rel_l2(got[1][k], want[1][k]), k) for k in keys)
    assert worst[0] <= 3e-2, worst
    diff2 = sum(float(((got[1][k].double() - want[1][k].double()) ** 2).sum())
                for k in keys)
    ref2 = sum(float((want[1][k].double() ** 2).sum()) for k in keys)
    assert (diff2 / ref2) ** 0.5 <= 1e-2
    for k in ("deconv0.weight", "deconv0.bias"):
        assert not want[1][k].any() and not got[1][k].any(), k


def test_train_step_gradients_match_tpureg_in_fp64(trees, train_steps):
    """The port in fp64 against tpureg in fp64, from the same weights and
    batch: per tensor ≤ 3e-3 relative L2, the FlowNet2 step's bound
    (measured 1.1e-4, the bias of ``predict_flow6``). The residual is the
    fp32 loss that both keep under fp64; it shows that the fp32 test's
    distance is rounding, not a difference of function."""
    want = train_steps[0][1]
    imgs, _ = pair_batch(2, BATCH, SIZE)
    model = port_head("pwc-reg", trees["pwc-reg"]).double().train()
    _, metrics = _loss_terms(model, torch.from_numpy(imgs).double(), None,
                             LOSS_KWARGS, None)
    params = dict(model.named_parameters())
    got = dict(zip(params, torch.autograd.grad(
        metrics["loss"], list(params.values()), materialize_grads=True)))
    worst = max((rel_l2(got["predictor." + k], want[k]), k)
                for k in want if not k.startswith("deconv0."))
    assert worst[0] <= 3e-3, worst


def test_train_step_updates_match_tpureg_fp64(train_steps):
    """The updated weights against tpureg's: the update's relative L2 ≤ 0.05
    and ≤ 1% of the elements further apart than 1e-6 (measured 1.8e-3 and
    0.08%: Adam moves each element by about ±lr whatever |g| is, so an
    element whose gradient is within rounding of zero may step the other
    way); ``deconv0`` stays as it was on both sides."""
    want, got, before = train_steps
    diff2 = ref2 = 0.0
    far = total = 0
    for k in want[2]:
        d = got[2][k].double() - want[2][k].double()
        diff2 += float((d * d).sum())
        ref2 += float(((want[2][k].double() - before[k].double()) ** 2).sum())
        far += int((d.abs() > 1e-6).sum())
        total += d.numel()
    assert (diff2 / ref2) ** 0.5 <= 0.05
    assert far <= 0.01 * total, far / total
    for k in ("deconv0.weight", "deconv0.bias"):
        assert torch.equal(got[2][k], before[k]) and torch.equal(want[2][k], before[k])


def test_bf16_eval_step_matches_tpureg(trees):
    """The bf16 eval step (weights and images cast, the loss in fp32, the
    warp's mask computed in bf16) against tpureg's bf16 eval step: the
    losses within 5e-3 relative (measured ≤ 9.4e-4) and the finest flow
    within 5e-2 of its scale (measured 1.5e-2): bf16 keeps 8 bits through
    ~30 layers, which round in a different order on each side; and the
    warped segmentation's labels."""
    imgs, segs = pair_batch(3, BATCH, SIZE)
    params = trees["pwc-reg"]
    out, m = jax_make_eval_step(LOSS_KWARGS, compute_dtype=jnp.bfloat16)(
        jax_state(params), jnp.asarray(imgs), jnp.asarray(segs))
    model = port_head("pwc-reg", params)
    (flows, _, wsegs, _), metrics = make_eval_step(
        model, LOSS_KWARGS, compute_dtype=torch.bfloat16)(
        torch.from_numpy(imgs), torch.from_numpy(segs))
    assert flows[0].dtype == torch.bfloat16 and len(flows) == 7
    for k in TERMS:
        np.testing.assert_allclose(float(metrics[k]), float(m[k]), rtol=5e-3,
                                   err_msg=k)
    want = np.asarray(out[0][0], np.float32)
    err = np.abs(flows[0].float().numpy() - want).max()
    assert err <= 5e-2 * np.abs(want).max(), err
    assert set(np.unique(wsegs.float().numpy())) <= {0.0, 1.0, 2.0, 3.0}


# ---------------------------------------------------------------------------
# both 2-D CLIs

def test_cli_trains_resumes_and_evaluates_pwc_reg(work_path, capsys, tb_records):  # noqa: F811
    """The training CLI trains pwc-reg on 2 random batches at 64², writes its
    state and best weights under ``PWCDCNet``, resumes with ``--cp 1``; the
    inference CLI loads those weights and scores ``--mode synthetic``."""
    from tpureg_torch.cli.inference import main as infer
    from tpureg_torch.cli.train import main as train

    work = str(work_path)
    args = ["--model", "pwc-reg", "--synthetic", "2", "--image_size", "64",
            "--batch_size", "2", "--workdir", work, "--logdir",
            str(work_path / "log")]
    state = train(args + ["--epochs", "1", "--cp", "0"], device="cpu")
    out = capsys.readouterr().out
    assert "EPOCH 1/1" in out and "saving new best weights" in out
    assert state.step == 2
    for path in (training_state_path(work, "PWCDCNet"),
                 best_weight_path(work, "PWCDCNet")):
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
        "--mode", "synthetic", "--model", "pwc-reg", "--batch_size", "1",
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
