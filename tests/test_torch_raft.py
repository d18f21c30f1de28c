"""RAFT and raft-reg in tpureg_torch against tpureg's on the CPU: the
pyramid's lookup (the port's gather form against tpureg's windows form, and
its VJP), the correlation pyramid, the encoder with its GroupNorms in fp32
and bf16, the weight bridge, the registry, the head's forward for both
variants in eval and train mode, one raft-reg train step against tpureg's
fp64 step, one bf16 eval step, ``OFEloss(weight_order=...)`` and both 2-D
CLIs with ``--model raft-reg``.

raft-reg runs at 32² (8² maps at 1/4) and raft at 64² (8² maps at 1/8).
Weights are numpy draws from a seed, laid into the parameter tree that
``jax.eval_shape`` gives for tpureg's module, and carried into the port by
``state_dict_from_jax_raft``. tpureg's train step compiles once, in a
module fixture, with ``iters=2`` built on both sides.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_elastic import write_analyze
from tpureg.losses.ofe import OFEloss as jax_OFEloss
from tpureg.models import FlowNet2 as JaxFlowNet2
from tpureg.models import RAFT as JaxRAFT
from tpureg.models import build_predictor as jax_build_predictor
from tpureg.models.raft import _corr_pyramid as jax_corr_pyramid
from tpureg.models.raft import _Encoder as JaxEncoder
from tpureg.models.raft import _lookup as jax_lookup
from tpureg.reg import OpticalFlowReg as JaxOpticalFlowReg
from tpureg.train import make_eval_step as jax_make_eval_step
from tpureg.train import make_train_step as jax_make_train_step
from tpureg.train.state import RegTrainState
from tpureg_torch.compat import state_dict_from_jax_raft
from tpureg_torch.losses import OFEloss
from tpureg_torch.models import RAFT, FlowNet2, build_predictor
from tpureg_torch.models.raft import _Encoder, corr_pyramid, lookup
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.train import (
    best_weight_path,
    create_train_state,
    default_loss_kwargs,
    make_eval_step,
    make_train_step,
    training_state_path,
)
from tpureg_torch.train.steps import _loss_terms

BATCH = 2
SIZES = {"raft-reg": 32, "raft": 64}
TERMS = ("loss", "photo_loss", "corr_loss", "smooth_loss")
LOSS_KWARGS = default_loss_kwargs("raft-reg")  # None: all 5 flows, ascending


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


def numpy_params(module, x, seed, **kwargs):
    """A parameter tree shaped as ``module.init`` would make it, filled from
    ``seed``: kernels N(0, 1 / fan_in) (flax's lecun scale), GroupNorm
    scales 1 + N(0, 0.1²), biases N(0, 0.01²), so that a wrong layout,
    scale or bias shows."""
    shapes = jax.eval_shape(lambda k, a: module.init(k, a, **kwargs),
                            jax.random.key(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.01 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


class _JaxHead2(JaxOpticalFlowReg):
    """tpureg's head around raft-reg at 2 iterations."""

    def setup(self):
        self.predictor = JaxRAFT(iters=2, feed_warped=True, downsample=4)


@pytest.fixture(scope="module")
def trees():
    """tpureg parameter trees of the registration head around raft-reg at
    32² and raft at 64²."""
    return {name: numpy_params(JaxOpticalFlowReg(conv_predictor=name),
                               pair_batch(0, BATCH, size)[0], i, train=True)
            for i, (name, size) in enumerate(SIZES.items())}


def port_head(name, params, iters=5):
    model = OpticalFlowReg(name)
    if iters != 5:
        model.predictor = RAFT(iters=iters, feed_warped=True, downsample=4)
    model.predictor.load_state_dict(state_dict_from_jax_raft(params), strict=True)
    return model


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---------------------------------------------------------------------------
# the lookup, the pyramid and the encoder

def lookup_inputs(seed):
    """tpureg's lookup test (tests/test_models.py:203): a 3-level pyramid of
    [2 x 8 x 8] maps from 16-channel features and centres in (-3, 11), past
    every border."""
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    f2 = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    coords = rng.uniform(-3.0, 11.0, (2, 8, 8, 2)).astype(np.float32)
    pyramid = [np.asarray(p) for p in jax_corr_pyramid(jnp.asarray(f1),
                                                       jnp.asarray(f2), 3)]
    return pyramid, coords


def test_lookup_gather_matches_tpureg_windows():
    """The port's gather form against tpureg's default, gather-free windows
    form: 243 channels (3 levels of 81, dy-major) within 1e-5 (measured
    1.1e-6)."""
    pyramid, coords = lookup_inputs(1)
    want = jax_lookup([jnp.asarray(p) for p in pyramid], jnp.asarray(coords),
                      radius=4, use_windows=True)
    got = lookup([nchw(p) for p in pyramid], nchw(coords), radius=4)
    assert got.shape == (2, 243, 8, 8)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


def test_lookup_vjp_matches_tpureg():
    """The cotangents of the maps and of the centres against ``jax.vjp`` of
    tpureg's windows form on a N(0, 1) cotangent: 1e-5 abs + 1e-5 rel
    (measured 7.2e-7 on the maps, 3.8e-6 on centre cotangents up to 30)."""
    pyramid, coords = lookup_inputs(2)
    cot = np.random.default_rng(3).standard_normal((2, 8, 8, 243)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, c: jax_lookup(p, c, radius=4, use_windows=True),
                     [jnp.asarray(p) for p in pyramid], jnp.asarray(coords))
    want_maps, want_coords = vjp(jnp.asarray(cot))
    maps = [nchw(p).requires_grad_() for p in pyramid]
    centres = nchw(coords).requires_grad_()
    out = lookup(maps, centres, radius=4)
    grads = torch.autograd.grad(out, [*maps, centres], nchw(cot))
    for g, w in zip(grads[:-1], want_maps):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(nhwc(grads[-1]), np.asarray(want_coords),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_pyramid_matches_tpureg(dtype):
    """4 levels of [B·H·W, 1, h, w] maps from 128-channel features, fp32
    whatever the features' dtype (tpureg promotes the bf16 product when it
    divides by √C in fp32): within 1e-5 of the largest map value in fp32
    (measured 3.1e-8) and 1/128 of it in bf16, one rounding of the product
    to bf16 (measured 6.1e-8)."""
    rng = np.random.default_rng(4)
    f1, f2 = (rng.standard_normal((2, 8, 8, 128)).astype(np.float32) for _ in "ab")
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax_corr_pyramid(jnp.asarray(f1, jdt), jnp.asarray(f2, jdt), 4)
    got = corr_pyramid(nchw(f1).to(tdt), nchw(f2).to(tdt), 4)
    scale = float(np.abs(np.asarray(want[0])).max())
    tol = 1e-5 if dtype == "float32" else 2.0**-7
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        assert g.shape == (128, 1, *w.shape[1:3])
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=tol * scale, rtol=0)


@pytest.mark.parametrize("final_stride", [2, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_tpureg(dtype, final_stride):
    """The residual encoder with its 11 GroupNorms (flax's: eps 1e-6, the
    one-pass variance in fp32) at 64², weights and input cast to the dtype
    as the bf16 step casts them: fp32 within 1e-4 of the output's scale
    (measured ≤ 2.7e-6), bf16 within 4e-2 of it (measured ≤ 1.8e-2): 8 bits
    through 12 convolutions that XLA:CPU and torch round in another order."""
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    module = JaxEncoder(128, final_stride=final_stride)
    params = numpy_params(module, x, 6)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(module.apply(
        {"params": jax.tree.map(lambda a: jnp.asarray(a, jdt), params)},
        jnp.asarray(x, jdt)), np.float32)
    enc = _Encoder(128, final_stride)
    sd = state_dict_from_jax_raft({"fnet": params}, prefix=())
    enc.load_state_dict({k.removeprefix("fnet."): v for k, v in sd.items()},
                        strict=True)
    with torch.no_grad():
        got = enc.to(tdt)(nchw(x).to(tdt))
    assert got.dtype == tdt and got.shape == (2, 128, *want.shape[1:3])
    tol = 1e-4 if dtype == "float32" else 4e-2
    err = np.abs(nhwc(got) - want).max()
    assert err <= tol * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# the bridge and the registry

@pytest.mark.parametrize("name", ["raft-reg", "raft"])
def test_bridge_places_every_leaf_of_the_flax_tree(trees, name):
    """Every leaf of tpureg's tree goes to one key of the port's RAFT, which
    loads strictly; kernels HWIO → OIHW, GroupNorm's scale → weight; a leaf
    RAFT does not have raises."""
    params = trees[name]["predictor"]
    leaves = jax.tree_util.tree_leaves_with_path(params)
    sd = state_dict_from_jax_raft(trees[name])
    assert len(sd) == len(leaves) == len(build_predictor(name).state_dict())
    build_predictor(name).load_state_dict(sd, strict=True)
    for path, leaf in leaves:
        keys = [p.key for p in path]
        name_ = {"kernel": "weight", "scale": "weight", "bias": "bias"}[keys[-1]]
        got = sd[".".join(keys[:-1] + [name_])].numpy()
        want = np.asarray(leaf).transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf
        np.testing.assert_array_equal(got, want, err_msg="/".join(keys))
    assert sd["fnet.stem_norm.weight"].shape == (32,)
    with pytest.raises(ValueError, match="no counterpart"):
        state_dict_from_jax_raft({"predictor": {"fnet": {"bogus": {
            "kernel": np.zeros((3, 3, 1, 1), np.float32)}}}})


@pytest.mark.parametrize("name,kind", [
    ("raft", RAFT), ("raft-reg", RAFT), ("raft-pwc", RAFT), ("RAFT", RAFT),
    ("my-raft-net", RAFT), ("flownet2-raft", FlowNet2),
])
def test_registry_builds_tpuregs_model(name, kind):
    """tpureg's dispatch: "raft-reg" by name, then "flownet2" before
    "raft" before "pwc"; each name builds tpureg's model, with the same
    ``feed_warped``, ``downsample`` and motion-encoder input (582 channels
    for raft-reg, 326 for raft)."""
    net, want = build_predictor(name), jax_build_predictor(name)
    assert type(net) is kind
    assert type(want).__name__ == kind.__name__
    if kind is RAFT:
        assert (net.feed_warped, net.downsample, net.iters) == (
            want.feed_warped, want.downsample, want.iters)
        assert net.menc1.in_channels == 4 * 81 + 2 + (256 if want.feed_warped else 0)
    else:
        assert isinstance(want, JaxFlowNet2)


# ---------------------------------------------------------------------------
# the head's forward

def assert_close(got, want, err_msg=""):
    """fp32 accumulation-order noise between XLA:CPU and torch/MKL through
    the encoders and 5 GRU iterations: 5e-4 abs / 1e-3 rel, the tolerance of
    tests/test_torch_models.py (measured 2.0e-5 on raft-reg's flows of up
    to 22 px, 5.7e-5 on raft's of up to 41 px)."""
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=5e-4,
                               rtol=1e-3, err_msg=err_msg)


@pytest.fixture(scope="module")
def head_outputs(trees):
    """tpureg's head around raft-reg and raft in eval and train mode (one
    compile a model), and the batches."""
    out = {}
    for name, size in SIZES.items():
        imgs, segs = pair_batch(1, BATCH, size)
        jmodel = JaxOpticalFlowReg(conv_predictor=name)
        out[name] = (jax.jit(lambda p, a, s: tuple(
            jmodel.apply({"params": p}, a, s, train=t) for t in (False, True)))(
            trees[name], jnp.asarray(imgs), jnp.asarray(segs)), imgs, segs)
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["raft-reg", "raft"])
def test_head_forward_matches_tpureg(trees, head_outputs, name, train):
    """The 5 full-resolution flows (finest, the last iteration, first), the 5
    warped images, the warped segmentation and the warped grid through
    ``OpticalFlowReg``."""
    outputs, imgs, segs = head_outputs[name]
    want = outputs[int(train)]
    model = port_head(name, trees[name]).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), torch.from_numpy(segs))
    assert len(got[0]) == len(got[1]) == 5
    for i in range(5):
        assert got[0][i].shape == (BATCH, SIZES[name], SIZES[name], 2)
        assert_close(got[0][i].numpy(), want[0][i], f"flow{i}")
        assert_close(got[1][i].numpy(), want[1][i], f"warped{i}")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert_close(got[3].numpy(), want[3], "grid")
    # the iterations differ: the flows are not one tensor five times
    assert float((got[0][0] - got[0][4]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# one train step against tpureg's fp64 step; one bf16 eval step

def jax_state(params, module):
    return RegTrainState.create(apply_fn=module.apply, params=params,
                                tx=optax.adam(1e-4, eps=1e-4), batch_stats={})


@pytest.fixture(scope="module")
def train_steps(trees):
    """One tpureg step in fp64 and one port step in fp32 from the same
    raft-reg weights (2 iterations on both sides) and a fresh Adam state:
    (tpureg's metrics, gradient and updated weights as port state dicts;
    the port's; the weights before)."""
    imgs, _ = pair_batch(2, BATCH, SIZES["raft-reg"])
    params = trees["raft-reg"]
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        state, m = jax_make_train_step(loss_kwargs=LOSS_KWARGS, donate=False)(
            jax_state(p64, _JaxHead2()), jnp.asarray(imgs, jnp.float64))
        get = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
        want = ({k: float(m[k]) for k in TERMS},
                state_dict_from_jax_raft(get(jax.tree.map(lambda a: a / 0.1,
                                                          state.opt_state[0].mu))),
                state_dict_from_jax_raft(get(state.params)))
    model = port_head("raft-reg", params, iters=2)
    state = create_train_state(model)
    m = make_train_step(state, loss_kwargs=LOSS_KWARGS)(torch.from_numpy(imgs))
    got = ({k: float(m[k]) for k in TERMS},
           {n.removeprefix("predictor."): p.grad.clone()
            for n, p in model.named_parameters()},
           {k: v.clone() for k, v in model.predictor.state_dict().items()})
    return want, got, state_dict_from_jax_raft(params)


def test_train_step_losses_match_tpureg_fp64(train_steps):
    """fp32 sums over the 5 flows against fp64: 1e-5 relative (measured
    ≤ 6.1e-6)."""
    want, got, _ = train_steps
    for k in TERMS:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5, err_msg=k)


def test_train_step_gradients_match_tpureg_fp64(train_steps):
    """The port's fp32 gradient against tpureg's fp64 one (its first Adam
    moment over 1 - b1), by pwc-reg's rule: per tensor ≤ 3e-2 relative L2
    (measured 4.2e-4, ``cnet.stem.weight``) and ≤ 1e-2 over the model
    (measured 1.5e-4)."""
    want, got, _ = train_steps
    assert set(got[1]) == set(want[1])
    worst = max((rel_l2(got[1][k], want[1][k]), k) for k in want[1])
    assert worst[0] <= 3e-2, worst
    diff2 = sum(float(((got[1][k].double() - want[1][k].double()) ** 2).sum())
                for k in want[1])
    ref2 = sum(float((want[1][k].double() ** 2).sum()) for k in want[1])
    assert (diff2 / ref2) ** 0.5 <= 1e-2


def test_train_step_gradients_match_tpureg_in_fp64(trees, train_steps):
    """The port in fp64 against tpureg in fp64, from the same weights and
    batch: per tensor ≤ 3e-3 relative L2, the FlowNet2 step's bound
    (measured 3.5e-6)."""
    want = train_steps[0][1]
    imgs, _ = pair_batch(2, BATCH, SIZES["raft-reg"])
    model = port_head("raft-reg", trees["raft-reg"], iters=2).double().train()
    _, metrics = _loss_terms(model, torch.from_numpy(imgs).double(), None,
                             LOSS_KWARGS, None)
    params = dict(model.named_parameters())
    got = dict(zip(params, torch.autograd.grad(metrics["loss"], list(params.values()))))
    worst = max((rel_l2(got["predictor." + k], want[k]), k) for k in want)
    assert worst[0] <= 3e-3, worst


def test_train_step_updates_match_tpureg_fp64(train_steps):
    """The updated weights against tpureg's, by pwc-reg's rule: the update's
    relative L2 ≤ 0.05 and ≤ 1% of the elements further apart than 1e-6
    (measured 9.4e-3 and 0.07%)."""
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


def test_bf16_eval_step_matches_tpureg(trees):
    """raft-reg's bf16 eval step (weights and images cast; the pyramid and
    every layer after it in fp32, as tpureg promotes them; the loss in
    fp32) against tpureg's bf16 eval step: the losses within 5e-3 relative
    (measured 2.3e-4) and the finest flow within 5e-2 of its scale
    (measured 1.5e-2); the warped segmentation's labels."""
    imgs, segs = pair_batch(3, BATCH, SIZES["raft-reg"])
    params = trees["raft-reg"]
    out, m = jax_make_eval_step(LOSS_KWARGS, compute_dtype=jnp.bfloat16)(
        jax_state(params, JaxOpticalFlowReg(conv_predictor="raft-reg")),
        jnp.asarray(imgs), jnp.asarray(segs))
    model = port_head("raft-reg", params)
    (flows, _, wsegs, _), metrics = make_eval_step(
        model, LOSS_KWARGS, compute_dtype=torch.bfloat16)(
        torch.from_numpy(imgs), torch.from_numpy(segs))
    assert len(flows) == 5 and flows[0].dtype == torch.float32
    assert out[0][0].dtype == jnp.float32
    for k in TERMS:
        np.testing.assert_allclose(float(metrics[k]), float(m[k]), rtol=5e-3,
                                   err_msg=k)
    want = np.asarray(out[0][0], np.float32)
    err = np.abs(flows[0].float().numpy() - want).max()
    assert err <= 5e-2 * np.abs(want).max(), err
    assert set(np.unique(wsegs.float().numpy())) <= {0.0, 1.0, 2.0, 3.0}


@pytest.mark.parametrize("order", ["ascending", "descending"])
def test_ofe_loss_weight_order_matches_tpureg(order):
    """``OFEloss``'s per-scale weights in either order, on 5 flows at one
    resolution (RAFT's): each term within 1e-6 relative (measured ≤ 2.9e-7);
    an unknown order raises."""
    rng = np.random.default_rng(7)
    flows = [rng.normal(0, 2, (2, 16, 16, 2)).astype(np.float32) for _ in range(5)]
    warped = [rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32) for _ in range(5)]
    fixed = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    want = jax_OFEloss([jnp.asarray(f) for f in flows], [jnp.asarray(w) for w in warped],
                       jnp.asarray(fixed), weight_order=order)
    got = OFEloss([nchw(f) for f in flows], [nchw(w) for w in warped], nchw(fixed),
                  weight_order=order)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    with pytest.raises(ValueError, match="weight_order"):
        OFEloss([nchw(f) for f in flows], [nchw(w) for w in warped], nchw(fixed),
                weight_order="sideways")


# ---------------------------------------------------------------------------
# both 2-D CLIs

def test_cli_trains_resumes_and_evaluates_raft_reg(tmp_path, capsys):
    """The training CLI trains raft-reg on 2 random batches at 64², writes
    its state and best weights under ``RAFT``, resumes with ``--cp 1``; the
    inference CLI loads those weights and scores ``--mode synthetic``."""
    from tpureg_torch.cli.inference import main as infer
    from tpureg_torch.cli.train import main as train

    work = str(tmp_path)
    args = ["--model", "raft-reg", "--synthetic", "2", "--image_size", "64",
            "--batch_size", "2", "--workdir", work, "--logdir",
            str(tmp_path / "log")]
    state = train(args + ["--epochs", "1", "--cp", "0"], device="cpu")
    out = capsys.readouterr().out
    assert "EPOCH 1/1" in out and "saving new best weights" in out
    assert state.step == 2
    for path in (training_state_path(work, "RAFT"), best_weight_path(work, "RAFT")):
        assert os.path.isfile(path), path
    state = train(args + ["--epochs", "2", "--cp", "1"], device="cpu")
    out = capsys.readouterr().out
    assert "loading checkpoint state" in out and "EPOCH 1/2" not in out
    assert state.step == 4

    rng = np.random.default_rng(9)
    for d in ("img", "seg"):
        (tmp_path / d).mkdir()
    shape = (24, 30, 142)
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n) for n in shape), indexing="ij")
    for i in range(2):
        r = np.sqrt((x - rng.uniform(-.1, .1)) ** 2 + y ** 2 + (z / 2.5) ** 2)
        seg = np.select([r < 0.35, r < 0.6, r < 0.85], [3, 2, 1], 0)
        write_analyze(str(tmp_path / "img" / f"s{i}_mpr"),
                      seg * 200 + rng.normal(0, 10, shape))
        write_analyze(str(tmp_path / "seg" / f"s{i}_seg"), seg)
    results = infer([
        "--mode", "synthetic", "--model", "raft-reg", "--batch_size", "1",
        "--img_dir", str(tmp_path / "img"), "--seg_dir", str(tmp_path / "seg"),
        "--workdir", work, "--logdir", str(tmp_path / "log_eval"),
        "--max_samples", "2",
    ], device="cpu")
    out = capsys.readouterr().out
    assert "loaded best weights" in out and "===> EVAL summary" in out
    for key in ("loss", "dice", "mse", "psnr", "ssim_img", "mag", "neg_jac"):
        assert key in results and np.isfinite(results[key]), key
