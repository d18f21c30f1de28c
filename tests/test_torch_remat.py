"""``make_train_step(remat=...)`` of tpureg_torch against the port's own base
step on the CPU: tpureg's remat changes what is kept for the backward, not
what is computed (tests/test_train_e2e.py::test_remat_step_matches_base), so
the metrics, the updated parameters and the BatchNorm running statistics of
a remat step must equal the base step's within 1e-6 (absolute), in fp32 and
bf16, with one microbatch and two. The base step is held against tpureg's
by tests/test_torch_train.py, so no tpureg step is compiled here.

FlowNetC (correlation and BatchNorm) runs at 64², batch 2; raft-reg (the
all-pairs product, a ``bmm``) at 32² with ``iters=2`` and pwc-reg (five
correlations, the "pwc" warps) at 64², in fp32. Torch runs on one thread:
the base step is then deterministic (on two threads two runs of it differ
by 4e-6 in pwc-reg's weights at two microbatches).
"""

import copy

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import tpureg_torch.models.flownet_c as flownet_c
import tpureg_torch.reg.head as head
from test_torch_cli import one_torch_thread  # noqa: F401 (a fixture)
from tpureg_torch.models.raft import RAFT
from tpureg_torch.nn.layers import BatchNorm2d
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.train import create_train_state, default_loss_kwargs, make_train_step

TOL = 1e-6
SIZES = {"flownetc": 64, "raft-reg": 32, "pwc-reg": 64}
TERMS = ("loss", "photo_loss", "corr_loss", "smooth_loss")


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def head_of(name):
    model = OpticalFlowReg(name, generator=torch.Generator().manual_seed(3))
    if name == "raft-reg":
        model.predictor = RAFT(iters=2, feed_warped=True, downsample=4,
                               generator=torch.Generator().manual_seed(3))
    return model


_MODELS = {}
_BASE = {}


def model_of(name):
    if name not in _MODELS:
        _MODELS[name] = head_of(name)
    return _MODELS[name]


def imgs_of(name):
    s = SIZES[name]
    return torch.rand(2, s, s, 2, generator=torch.Generator().manual_seed(4))


def one_step(name, remat, dtype, accum):
    """(metrics, state dict after the step) of one step from the module's
    shared initial weights."""
    model = copy.deepcopy(model_of(name))
    state = create_train_state(model, learning_rate=1e-3)
    step = make_train_step(state, loss_kwargs=default_loss_kwargs(name),
                           compute_dtype=dtype, remat=remat, accum_steps=accum)
    metrics = step(imgs_of(name))
    assert state.step == 1
    return ({k: float(metrics[k]) for k in TERMS},
            {k: v.clone() for k, v in model.state_dict().items()})


def base_step(name, dtype, accum):
    key = (name, dtype, accum)
    if key not in _BASE:
        _BASE[key] = one_step(name, None, dtype, accum)
    return _BASE[key]


def assert_same_step(got, want):
    (gm, gsd), (wm, wsd) = got, want
    for k in TERMS:
        assert abs(gm[k] - wm[k]) <= TOL, (k, gm[k], wm[k])
    assert set(gsd) == set(wsd)
    stats = [k for k in wsd if k.endswith(("running_mean", "running_var"))]
    for k in wsd:
        err = float((gsd[k].double() - wsd[k].double()).abs().max())
        assert err <= TOL, (k, err)
    return stats


CASES = ([("flownetc", remat, dtype, accum) for remat in ("full", "dots")
          for dtype in (None, torch.bfloat16) for accum in (1, 2)]
         + [(name, remat, None, 1) for name in ("raft-reg", "pwc-reg")
            for remat in ("full", "dots")])


@pytest.mark.parametrize("name,remat,dtype,accum", CASES)
def test_remat_step_matches_the_base_step(name, remat, dtype, accum):
    stats = assert_same_step(one_step(name, remat, dtype, accum),
                             base_step(name, dtype, accum))
    if name == "flownetc":
        assert len(stats) >= 20  # the running statistics were compared


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_recomputes_batchnorm_and_keeps_one_update(remat):
    """Each BatchNorm runs again in the backward, which updates its running
    statistics a second time; the step keeps those of the first forward,
    and their update counts (num_batches_tracked), bit for bit as the base
    step leaves them."""
    calls = {}

    def step_counting_batchnorms(mode):
        calls[mode] = 0

        def count(*_):
            calls[mode] += 1

        model = copy.deepcopy(model_of("flownetc"))
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.register_forward_hook(count)
        state = create_train_state(model, learning_rate=1e-3)
        make_train_step(state, remat=mode)(imgs_of("flownetc"))
        return model

    step_counting_batchnorms(None)
    model = step_counting_batchnorms(remat)
    # the siamese towers' BatchNorms run once for each image
    assert calls[None] == 14 and calls[remat] == 2 * calls[None]
    _, want = base_step("flownetc", None, 1)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("remat", [None, "full", "dots"])
def test_remat_runs_the_heads_warps_and_correlation_again(monkeypatch, remat):
    """What the card's launch gates rest on: in the backward the recompute
    runs the whole head's forward again, up to its last saved tensor, the
    grid warp's, so each warp and the correlation is called twice a step
    (on the card each is one K3 or K1 launch) and once without remat."""
    calls = {"warp": 0, "corr": 0}

    def counted(fn, key):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(head, "warp2d", counted(head.warp2d, "warp"))
    monkeypatch.setattr(flownet_c, "correlation",
                        counted(flownet_c.correlation, "corr"))
    model = copy.deepcopy(model_of("flownetc"))
    make_train_step(create_train_state(model), remat=remat)(imgs_of("flownetc"))
    # FlowNetC's head in train mode: 5 flows' image warps and the grid warp
    times = 1 if remat is None else 2
    assert calls == {"warp": 6 * times, "corr": times}


class _CountConvolutions(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def count_convolutions(fn):
    with _CountConvolutions() as mode:
        fn()
    return mode.n


@pytest.mark.parametrize("remat", [None, "full", "dots"])
def test_dots_keeps_the_convolutions(remat):
    """``"full"`` runs every convolution of the head again in the backward;
    ``"dots"`` keeps their outputs (tpureg's checkpoint_dots), so none runs
    again."""
    imgs = imgs_of("flownetc")
    in_head = count_convolutions(
        lambda: copy.deepcopy(model_of("flownetc")).train()(imgs))
    n = {}
    for mode in (None, remat):
        step = make_train_step(create_train_state(
            copy.deepcopy(model_of("flownetc"))), remat=mode)
        n[mode] = count_convolutions(lambda: step(imgs))
    assert in_head >= 20
    assert n[remat] == n[None] + (in_head if remat == "full" else 0)


def test_remat_refuses_an_unknown_mode():
    state = create_train_state(head_of("flownetc"))
    with pytest.raises(ValueError, match=r"remat must be None\|'full'\|'dots', "
                                         r"got 'some'"):
        make_train_step(state, remat="some")
