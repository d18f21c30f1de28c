"""The flow-supervised step of tpureg_torch against tpureg's on the CPU:
``stn_inverse_target`` at square, non-square and 1-wide scales (tpureg
resizes with ``jax.image.resize``, which antialiases when it shrinks), and
one ``make_flow_supervised_step`` of flownets at 64², batch 2, in both
``flow_units``, against tpureg's step in fp64 from the same weights.

The weights are those of tests/test_torch_zoo.py's flownets tree (numpy
draws laid into ``jax.eval_shape``'s tree). tpureg's two steps compile once,
in a module fixture.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_refcache import refcache  # noqa: F401 (a fixture)
from test_torch_zoo import SIZE, BATCH, numpy_variables, pair_batch, port_head, rel_l2
from tpureg.reg import OpticalFlowReg as JaxOpticalFlowReg
from tpureg.train import make_flow_supervised_step as jax_make_flow_supervised_step
from tpureg.train.steps import stn_inverse_target as jax_stn_inverse_target
from tpureg.train.state import RegTrainState
from tpureg_torch.compat import state_dict_from_jax
from tpureg_torch.train import (
    create_train_state,
    make_flow_supervised_step,
    stn_inverse_target,
)

UNITS = ("resolution", "pwc20")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def smooth_disp(seed, b, h, w, amp=1.5):
    """A smooth [B, H, W, 2] pixel displacement: a few random sinusoids."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.zeros((b, h, w, 2))
    for i in range(b):
        for c in range(2):
            for _ in range(3):
                fy, fx = rng.uniform(0.5, 3, 2) * 2 * np.pi
                py, px = rng.uniform(0, 2 * np.pi, 2)
                out[i, ..., c] += np.sin(fy * yy / h + py) * np.cos(fx * xx / w + px)
    return (amp / 3 * out).astype(np.float32)


# (H, W, h, w): every scale of FlowNetS and FlowNetSFull at 64², flow0's
# own size, non-square inputs and scales, and the 1-wide scales
SCALES = [(64, 64, 64 >> i, 64 >> i) for i in range(7)] + [
    (256, 256, 64, 64), (48, 80, 12, 20), (48, 80, 3, 5), (48, 80, 1, 2),
    (48, 80, 2, 1), (48, 80, 48, 80)]


def scale_disp(H, W, h, w):
    return np.random.default_rng(H * w + h).normal(0, 2, (2, H, W, 2)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_targets():
    """tpureg's targets at every case of SCALES, in one program."""
    disps = [jnp.asarray(scale_disp(*c)) for c in SCALES]
    return jax.jit(lambda ds: [jax_stn_inverse_target(d, c[2], c[3], c[0])
                               for d, c in zip(ds, SCALES)])(disps)


@pytest.mark.parametrize("H,W,h,w", SCALES)
def test_stn_inverse_target_matches_tpureg(jax_targets, H, W, h, w):
    """Against ``tpureg.train.stn_inverse_target``: within 5e-7 px (measured
    ≤ 2.4e-7: the antialiased filter's weights are summed in another
    order); without the antialiasing a 256² → 64² target lies ~1 px
    away."""
    want = np.asarray(jax_targets[SCALES.index((H, W, h, w))])
    got = stn_inverse_target(torch.from_numpy(scale_disp(H, W, h, w)), h, w, H)
    assert got.shape == (2, h, w, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-7, rtol=0)


def test_stn_inverse_target_undoes_the_synthesis_warp():
    """At full size the target is the flow whose "stn" warp samples where
    the synthesis's inverse does: (x + flow)·(s-1)/s = x - d."""
    disp = smooth_disp(3, 1, 32, 48)
    t = stn_inverse_target(torch.from_numpy(disp), 32, 48, 32).numpy()
    yy, xx = np.mgrid[0:32, 0:48]
    np.testing.assert_allclose((xx + t[0, ..., 0]) * 47 / 48, xx - disp[0, ..., 0],
                               atol=1e-5)
    np.testing.assert_allclose((yy + t[0, ..., 1]) * 31 / 32, yy - disp[0, ..., 1],
                               atol=1e-5)


@pytest.fixture(scope="module")
def steps(refcache):  # noqa: F811
    """Per unit: one tpureg step in fp64 and one port step in fp32 from the
    same flownets weights, statistics and fresh Adam state (tpureg's
    metrics, gradient and updated state dict; the port's; the state dict
    before). Once a session."""
    return refcache("flow_supervised_steps", _steps)


def _steps():
    imgs, _ = pair_batch(4, BATCH, SIZE)
    disp = smooth_disp(5, BATCH, SIZE, SIZE)
    params, stats = numpy_variables(JaxOpticalFlowReg(conv_predictor="flownets"),
                                    imgs, 10)
    jsteps = {u: jax_make_flow_supervised_step(donate=False, flow_units=u)
              for u in UNITS}
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        state = RegTrainState.create(
            apply_fn=JaxOpticalFlowReg(conv_predictor="flownets").apply,
            params=p64, tx=optax.adam(1e-4, eps=1e-4), batch_stats=stats)
        # both units in one program, one compile
        results = jax.jit(lambda st, a, d: {u: jsteps[u](st, a, d) for u in UNITS})(
            state, jnp.asarray(imgs, jnp.float64), jnp.asarray(disp, jnp.float64))
    get = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
    out = {}
    for units in UNITS:
        state, m = results[units]
        want = ({k: float(m[k]) for k in ("epe", "epe0")},
                state_dict_from_jax(get(jax.tree.map(lambda a: a / 0.1,
                                                     state.opt_state[0].mu))),
                state_dict_from_jax(get(state.params), get(state.batch_stats)))
        model = port_head("flownets", (params, stats))
        pstate = create_train_state(model)
        m = make_flow_supervised_step(pstate, flow_units=units)(
            torch.from_numpy(imgs), torch.from_numpy(disp))
        assert pstate.step == 1 and set(m) == {"epe", "epe0"}
        got = ({k: float(m[k]) for k in m},
               {n.removeprefix("predictor."): p.grad.clone()
                for n, p in model.named_parameters()},
               {k: v.clone() for k, v in model.predictor.state_dict().items()})
        out[units] = (want, got)
    return out, state_dict_from_jax(params, stats)


@pytest.mark.parametrize("units", UNITS)
def test_flow_supervised_metrics_match_tpureg_fp64(steps, units):
    """``epe`` and ``epe0`` against tpureg's fp64 step: 1e-5 relative."""
    want, got = steps[0][units]
    for k in ("epe", "epe0"):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5, err_msg=k)
    # the units take effect: pwc20's targets differ at every scale at ¼ or less
    other = steps[0][UNITS[1 - UNITS.index(units)]][1][0]["epe"]
    assert abs(got[0]["epe"] - other) > 1e-2 * other


@pytest.mark.parametrize("units", UNITS)
def test_flow_supervised_gradients_match_tpureg_fp64(steps, units):
    """The port's fp32 gradient against tpureg's fp64 one, by the train
    steps' rule: per tensor ≤ 3e-2 relative L2 and ≤ 1e-2 over the model."""
    want, got = steps[0][units]
    assert set(got[1]) == set(want[1])
    worst = max((rel_l2(got[1][k], want[1][k]), k) for k in want[1])
    assert worst[0] <= 3e-2, worst
    diff2 = sum(float(((got[1][k].double() - want[1][k].double()) ** 2).sum())
                for k in want[1])
    ref2 = sum(float((want[1][k].double() ** 2).sum()) for k in want[1])
    assert (diff2 / ref2) ** 0.5 <= 1e-2


@pytest.mark.parametrize("units", UNITS)
def test_flow_supervised_updates_match_tpureg_fp64(steps, units):
    """The updated weights against tpureg's, as for the train step: the
    update's relative L2 ≤ 0.05, ≤ 1% of the elements further apart than
    1e-6; the running statistics within 1e-5 relative L2."""
    (want, got), before = steps[0][units], steps[1]
    diff2 = ref2 = 0.0
    far = total = 0
    stats = ("running_mean", "running_var", "num_batches_tracked")
    for k in want[2]:
        if k.endswith(stats):
            if not k.endswith(stats[2]):
                assert rel_l2(got[2][k], want[2][k]) <= 1e-5, k
            continue
        d = got[2][k].double() - want[2][k].double()
        diff2 += float((d * d).sum())
        ref2 += float(((want[2][k].double() - before[k].double()) ** 2).sum())
        far += int((d.abs() > 1e-6).sum())
        total += d.numel()
    assert (diff2 / ref2) ** 0.5 <= 0.05
    assert far <= 0.01 * total, far / total


def test_flow_supervised_step_refuses_unknown_units():
    with torch.device("meta"):
        model = torch.nn.Linear(1, 1)
    with pytest.raises(ValueError, match="flow_units"):
        make_flow_supervised_step(create_train_state(model), flow_units="px")
