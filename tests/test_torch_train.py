"""The FlowNet2 training step of tpureg_torch against tpureg's on the CPU, at
64², batch 2, from weights bridged from one flax initialisation; the state
around it (Adam, schedule, checkpoints, the Adam bridge); and the two faults
of the eval step that only show once the port trains.

The yardstick for the port's fp32 step is tpureg's step run in fp64
(``jax.enable_x64``), not its fp32 step. FlowNet2's gradient at a random
initialisation is ill-conditioned: measured at this size, tpureg's own fp32
gradient lies 0.15 (whole model) and up to 0.40 (one tensor) in relative L2
from its fp64 gradient, mostly because flax's one-pass batch variance cancels
in fp32 behind the U(0, 1)-biased i_conv blocks. The port's fp32 gradient lies
3.3e-3 and 1.0e-2 from it. Both packages keep the loss and the channel norm in
fp32 even under x64, so the fp64 sides agree to 7.4e-4, not to fp64's
precision.

tpureg's flax initialisation and its three fp64 steps run once a test
session (the ``refcache`` fixture of tests/test_torch_refcache.py): every
worker that draws a test of this module shares them, where each used to
compute them again (about 520 s each, in two workers, of the whole suite's
run on 6 workers). Torch runs on one thread here.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from test_torch_cli import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_refcache import refcache  # noqa: F401 (a fixture)
from tpureg.reg import OpticalFlowReg as JaxOpticalFlowReg
from tpureg.train import create_train_state as jax_create_train_state
from tpureg.train import make_train_step as jax_make_train_step
from tpureg.train.state import RegTrainState
from tpureg_torch.compat import load_adam_state_from_jax, state_dict_from_jax
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
    restore_training_state,
    save_training_state,
    step_decay_schedule,
    training_state_path,
)
from tpureg_torch.train.steps import _loss_terms

SIZE, BATCH = 64, 2
TERMS = ("loss", "photo_loss", "corr_loss", "smooth_loss")


def pair_batch(seed, b, size):
    """Smooth fixed/moving images in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    imgs = np.empty((b, size, size, 2), np.float32)
    for i in range(b):
        for ch in range(2):
            cx, cy, r = rng.uniform(0.3, 0.7, 3)
            imgs[i, ..., ch] = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                                      / (0.1 + 0.1 * r))
    return imgs


def host_state(state, adam=True):
    """A tpureg train state as fp32 numpy trees: params, stats and, with
    ``adam``, Adam's count and moments."""
    get = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32),
                                 jax.device_get(t))
    snap = {"params": get(state.params), "stats": get(state.batch_stats),
            "count": 0}
    if adam:
        moments = state.opt_state[0]
        snap.update(count=int(moments.count), mu=get(moments.mu),
                    nu=get(moments.nu))
    return snap


def x64_state(state):
    """tpureg's train state with fp64 parameters and a fresh Adam state; call
    it under ``jax.enable_x64``. The running statistics stay fp32, as
    tpureg's step keeps them (train mode never reads them)."""
    params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                          state.params)
    return state.replace(params=params, opt_state=state.tx.init(params))


def port_state(snap):
    """The port's train state bridged from a host snapshot (Adam too)."""
    model = OpticalFlowReg("flownet2")
    model.predictor.load_state_dict(
        state_dict_from_jax(snap["params"], snap["stats"]), strict=True)
    state = create_train_state(model)
    if snap["count"]:
        load_adam_state_from_jax(state.optimizer, model, snap["count"],
                                 snap["mu"], snap["nu"])
        state.step = snap["count"]
    return state


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def split_sd(sd):
    """(parameters, BatchNorm statistics) of a predictor state dict."""
    stats = ("running_mean", "running_var", "num_batches_tracked")
    params = {k: v for k, v in sd.items() if not k.endswith(stats)}
    bn = {k: v for k, v in sd.items() if k.endswith(stats[:2])}
    return params, bn


def bn_fed_bias(key):
    """The biases of flownet2's i_conv blocks, whose conv feeds a BatchNorm:
    in train mode the batch mean takes them out again, so their exact
    gradient is zero and what either package computes is rounding noise."""
    return ".inter_conv" in key and key.endswith(".0.bias")


def assert_update_close(got_sd, want_sd, before_sd):
    """One step's parameter update against tpureg's: relative L2 ≤ 0.25 over
    the model, and ≤ 10% of the elements further apart than 1e-6 (measured:
    0.048 and 0.48% at step 1, 5.5% of the elements at step 3, 0.117 for the
    step of two one-pair microbatches). Adam moves each element by about
    ±lr whatever |g| is (for |g| ≫ eps = 1e-4), so an element whose gradient
    lies within the fp32 gradient's error of zero may step the other way,
    up to 2·lr apart. The i_conv biases in front of a BatchNorm, whose
    gradient is noise, are left out."""
    want, _ = split_sd(want_sd)
    got, _ = split_sd(got_sd)
    base, _ = split_sd(before_sd)
    assert set(got) == set(want)
    diff2 = ref2 = 0.0
    far = total = 0
    for k in want:
        if bn_fed_bias(k):
            continue
        d = got[k].double() - want[k].double()
        diff2 += float((d * d).sum())
        ref2 += float(((want[k].double() - base[k].double()) ** 2).sum())
        far += int((d.abs() > 1e-6).sum())
        total += d.numel()
    assert (diff2 / ref2) ** 0.5 <= 0.25, (diff2 / ref2) ** 0.5
    assert far <= 0.1 * total, far / total


def assert_stats_close(got_sd, want_sd):
    """BatchNorm running statistics: each variance within 1e-5 relative L2;
    each mean within 1e-5 of its channels' standard deviation, since the
    mean of a deep layer's few values may nearly cancel (measured 1.1e-6)."""
    _, want = split_sd(want_sd)
    _, got = split_sd(got_sd)
    assert set(got) == set(want) and len(want) > 100
    for k in want:
        if k.endswith("running_var"):
            assert rel_l2(got[k], want[k]) <= 1e-5, k
        else:
            std = want[k.replace("running_mean", "running_var")].double().sqrt()
            err = (got[k].double() - want[k].double()).norm() / std.norm()
            assert err <= 1e-5, (k, float(err))


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def flax_init():
    """The batch and tpureg's parameters and statistics at its flax
    initialisation (``create_train_state``), as numpy trees."""
    imgs = pair_batch(0, BATCH, SIZE)
    model = JaxOpticalFlowReg(conv_predictor="flownet2")
    state = jax_create_train_state(model, jax.random.key(0), jnp.asarray(imgs))
    return imgs, host_state(state, adam=False)


@pytest.fixture(scope="module")
def jax_init(refcache):  # noqa: F811
    """The batch and tpureg's fp32 parameters and statistics at its flax
    initialisation, in a train state whose Adam state is left out (the
    tests make their own): ``create_train_state``'s, rebuilt around the
    session's one initialisation."""
    imgs, snap = refcache("flownet2_flax_init", flax_init)
    state = RegTrainState.create(
        apply_fn=JaxOpticalFlowReg(conv_predictor="flownet2").apply,
        params=jax.tree.map(jnp.asarray, snap["params"]),
        batch_stats=jax.tree.map(jnp.asarray, snap["stats"]),
        tx=optax.adam(1e-4, b1=0.9, b2=0.999, eps=1e-4))
    return imgs, state.replace(opt_state=None)


@pytest.fixture(scope="module")
def jax_run(refcache, jax_init):  # noqa: F811
    """tpureg in fp64: three steps on one batch; fp32 snapshots of the
    parameters and statistics before and after each step (with Adam's state
    after steps 1 and 2), and each step's metrics. Computed once a
    session; the snapshot before step 1 is the initialisation's entry, not
    stored twice."""
    def run():
        imgs, state = jax_init
        snaps, metrics = {}, []
        with jax.enable_x64(True):
            state = x64_state(state)
            step = jax_make_train_step(donate=False)
            x = jnp.asarray(imgs, jnp.float64)
            for i in (1, 2, 3):
                state, m = step(state, x)
                metrics.append({k: float(m[k]) for k in TERMS})
                snaps[i] = host_state(state, adam=i < 3)
        return snaps, metrics

    snaps, metrics = refcache("flownet2_fp64_run", run)
    imgs, init = refcache("flownet2_flax_init", flax_init)
    return imgs, {0: init, **snaps}, metrics


def sd_of(snap):
    return state_dict_from_jax(snap["params"], snap["stats"])


def predictor_sd(state):
    return {k: v.clone() for k, v in state.model.predictor.state_dict().items()}


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port in fp32: three steps from the bridged initial state, keeping
    step 1's gradients and state dict, each step's metrics and the step
    count."""
    imgs, snaps, _ = jax_run
    state = port_state(snaps[0])
    step = make_train_step(state)
    metrics = []
    for i in (1, 2, 3):
        m = step(torch.from_numpy(imgs))
        metrics.append({k: float(m[k]) for k in TERMS})
        if i == 1:
            sd1 = predictor_sd(state)
            grads = {n.removeprefix("predictor."): p.grad.clone()
                     for n, p in state.model.named_parameters()}
    return sd1, metrics, grads, state.step


def tpureg_gradients(jax_run):
    """tpureg's fp64 step-1 gradient: its first Adam moment over (1 - b1)."""
    return state_dict_from_jax(jax.tree.map(lambda m: m / 0.1, jax_run[1][1]["mu"]))


def test_first_step_losses_match_tpureg(jax_run, port_run):
    for k in TERMS:
        # fp32 sums over every pixel of both scales, against fp64
        np.testing.assert_allclose(port_run[1][0][k], jax_run[2][0][k],
                                   rtol=1e-5, err_msg=k)


def test_first_step_gradients_match_tpureg(jax_run, port_run):
    """The port's fp32 gradient against tpureg's fp64 one: per-tensor
    relative L2 ≤ 3e-2 and ≤ 1e-2 over the whole model (measured 1.0e-2 and
    3.3e-3; see the module's docstring). The i_conv biases in front of a
    BatchNorm have a zero gradient: theirs stays below 1e-5 of their conv
    weight's (measured 2.5e-7)."""
    want = tpureg_gradients(jax_run)
    grads = port_run[2]
    assert set(grads) == set(want)
    keys = [k for k in want if not bn_fed_bias(k)]
    worst = max((rel_l2(grads[k], want[k]), k) for k in keys)
    assert worst[0] <= 3e-2, worst
    diff2 = sum(float(((grads[k].double() - want[k].double()) ** 2).sum()) for k in keys)
    ref2 = sum(float((want[k].double() ** 2).sum()) for k in keys)
    assert (diff2 / ref2) ** 0.5 <= 1e-2
    fed = [k for k in want if bn_fed_bias(k)]
    assert len(fed) == 6
    for k in fed:
        w = k.replace(".bias", ".weight")
        assert grads[k].norm() <= 1e-5 * grads[w].norm(), k


def test_first_step_gradients_match_tpureg_in_fp64(jax_run):
    """The port in fp64 against tpureg in fp64, from the same weights:
    per-tensor relative L2 ≤ 3e-3 (measured 7.4e-4). The residual is the
    fp32 loss and channel norm that both keep under fp64."""
    imgs, snaps, _ = jax_run
    model = port_state(snaps[0]).model.double().train()
    _, metrics = _loss_terms(model, torch.from_numpy(imgs).double(), None, {}, None)
    params = dict(model.named_parameters())
    got = dict(zip(params, torch.autograd.grad(metrics["loss"], list(params.values()))))
    want = tpureg_gradients(jax_run)
    worst = max((rel_l2(got["predictor." + k], want[k]), k)
                for k in want if not bn_fed_bias(k))
    assert worst[0] <= 3e-3, worst


@pytest.mark.parametrize("after", [1, 3])
def test_parameters_match_tpureg(jax_run, port_run, after):
    """One port step from tpureg's state before step ``after`` (bridged,
    Adam's moments and count included) against tpureg's step ``after``.
    Each comparison starts from one state: over several steps the two
    trajectories part, since each step's fp32 error is amplified by the
    next gradient (measured: the updates of three steps in a row differ by
    0.62 relative L2)."""
    imgs, snaps, metrics = jax_run
    if after == 1:
        got = port_run[0]
    else:
        state = port_state(snaps[after - 1])
        m = make_train_step(state)(torch.from_numpy(imgs))
        # the forward ran on tpureg's weights
        np.testing.assert_allclose(float(m["loss"]), metrics[after - 1]["loss"],
                                   rtol=1e-5)
        assert state.step == after
        got = predictor_sd(state)
    assert_update_close(got, sd_of(snaps[after]), sd_of(snaps[after - 1]))


def test_batchnorm_statistics_match_tpureg(jax_run, port_run):
    """Running statistics after step 1: flax's momentum 0.9 and biased
    variance."""
    assert_stats_close(port_run[0], sd_of(jax_run[1][1]))


def test_loss_falls_on_a_fixed_batch(port_run):
    losses = [m["loss"] for m in port_run[1]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert port_run[3] == 3


def test_training_continues_from_a_bridged_state(jax_run):
    """After one tpureg step, the whole state (weights, statistics, Adam's
    moments and count) crosses the bridge and the port takes two more steps:
    the first loss is that of tpureg's weights (≤ 1e-5), the second that of
    weights one port update apart (≤ 1e-4, measured 5.3e-5)."""
    imgs, snaps, metrics = jax_run
    state = port_state(snaps[1])
    assert state.step == 1
    step = make_train_step(state)
    for i, rtol in ((0, 1e-5), (1, 1e-4)):
        m = step(torch.from_numpy(imgs))
        np.testing.assert_allclose(float(m["loss"]), metrics[i + 1]["loss"],
                                   rtol=rtol)
    assert state.step == 3
    for p in state.model.parameters():
        assert float(state.optimizer.state[p]["step"]) == 3.0
        assert bool(torch.isfinite(p).all())


def test_adam_bridge_refuses_missing_moments(jax_run):
    snap = jax_run[1][1]
    mu = jax.tree.map(lambda a: a, snap["mu"])
    del mu["predictor"]["flownetc"]["conv1"]
    state = create_train_state(OpticalFlowReg("flownet2"))
    with pytest.raises(ValueError, match="do not cover"):
        load_adam_state_from_jax(state.optimizer, state.model, 1, mu, snap["nu"])


# ---------------------------------------------------------------------------
# the two eval-step faults, repaired

def test_bf16_eval_step_reflects_the_current_weights():
    """A bf16 eval step made before a train step gives what one made after
    it gives: each call casts the current parameters."""
    imgs = torch.from_numpy(pair_batch(1, BATCH, SIZE))
    model = OpticalFlowReg("flownet2", generator=torch.Generator().manual_seed(0))
    before = make_eval_step(model, compute_dtype=torch.bfloat16)
    loss0 = float(before(imgs)[1]["loss"])
    make_train_step(create_train_state(model, learning_rate=1e-3))(imgs)
    after = make_eval_step(model, compute_dtype=torch.bfloat16)
    got = {k: float(v) for k, v in before(imgs)[1].items()}
    want = {k: float(v) for k, v in after(imgs)[1].items()}
    assert got == want
    assert got["loss"] != loss0
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_each_step_sets_the_mode_it_needs():
    """The train step runs BatchNorm on batch statistics and updates the
    running ones; the eval step, called after it on the same module,
    normalises with the running statistics and leaves them alone."""
    imgs = torch.from_numpy(pair_batch(2, BATCH, SIZE))
    model = OpticalFlowReg("flownet2", generator=torch.Generator().manual_seed(1))
    eval_step = make_eval_step(model)
    train_step = make_train_step(create_train_state(model))
    train_step(imgs)
    assert model.training
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    first = eval_step(imgs)[1]
    assert not model.training
    for k, v in model.state_dict().items():
        if "running" in k:
            assert torch.equal(v, stats[k]), k
    again = make_eval_step(model)(imgs)[1]
    assert float(first["loss"]) == float(again["loss"])
    train_step(imgs)
    assert model.training
    # FlowNetC's siamese tower runs conv1 on both images: two batches a step
    assert int(model.predictor.flownetc.conv1[1].num_batches_tracked) == 4


# ---------------------------------------------------------------------------
# schedule, train state, checkpoints

def test_step_decay_schedule_matches_optax():
    sched = step_decay_schedule(1e-3, step_size=4, gamma=0.5, enabled=True)
    want = optax.exponential_decay(1e-3, 4, 0.5, staircase=True)
    for step in range(20):
        assert sched(step) == pytest.approx(float(want(step)), rel=1e-6)
    assert step_decay_schedule(1e-3) == 1e-3  # the reference never steps it


def test_train_state_uses_the_count_before_the_update():
    """optax evaluates the schedule at the pre-increment count: the first
    update sees schedule(0)."""
    lin = nn.Linear(3, 1)
    state = create_train_state(lin, step_decay_schedule(0.1, 1, 0.5, True))
    seen = []
    for _ in range(3):
        lin(torch.ones(1, 3)).sum().backward()
        seen.append(state.lr())
        state.apply_gradients()
        assert state.optimizer.param_groups[0]["lr"] == seen[-1]
        lin.zero_grad()
    assert seen == [0.1, 0.05, 0.025] and state.step == 3
    group = state.optimizer.param_groups[0]
    assert group["eps"] == 1e-4 and group["betas"] == (0.9, 0.999)


def test_training_state_round_trip(tmp_path):
    torch.manual_seed(0)
    lin = nn.Sequential(nn.Linear(3, 4), nn.BatchNorm1d(4))
    state = create_train_state(lin)
    lin(torch.randn(5, 3)).sum().backward()
    state.apply_gradients()
    path = save_training_state(str(tmp_path), "Net", state, epoch=2, best_loss=0.5)
    assert path == training_state_path(str(tmp_path), "Net")
    fresh = create_train_state(nn.Sequential(nn.Linear(3, 4), nn.BatchNorm1d(4)))
    restored, epoch, best = restore_training_state(str(tmp_path), "Net", fresh)
    assert (epoch, best, restored.step) == (3, 0.5, 1)
    for a, b in zip(lin.state_dict().values(), restored.model.state_dict().values()):
        assert torch.equal(a, b)
    sa = state.optimizer.state_dict()["state"]
    sb = restored.optimizer.state_dict()["state"]
    for i in sa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k])
    assert restore_training_state(str(tmp_path / "none"), "Net", fresh) is None
