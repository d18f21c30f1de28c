"""The port's spans (``tpureg_torch/utils/profiling.py``) on the CPU, at 64²,
batch 2: the shared null context while nothing records; the nesting of a
FlowNet2 train step's and a pwc-reg eval step's ranges in a
``torch.profiler`` trace; every convolution's backward node tied by its
sequence number to a forward op inside a model stage; a step's loss,
gradients and parameters bit for bit the same with the profiler on and
off."""

import copy
import json
from functools import partial

import pytest
import torch

from test_torch_cli import one_torch_thread  # noqa: F401 (a fixture)
from tpureg_torch.data.pipeline import synth_image_batch
from tpureg_torch.ops.library import OPS
from tpureg_torch.reg.head import OpticalFlowReg
from tpureg_torch.train import (
    create_train_state,
    default_loss_kwargs,
    make_eval_step,
    make_train_step,
)
from tpureg_torch.utils import profiling

SIZE, BATCH = 64, 2
FLOWNET2_STAGES = ["flownetc", "flownets_1", "flownets_2", "flownets_d", "fusion"]
PWC_STAGES = ["pyramid", "level6", "level5", "level4", "level3", "level2", "context"]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _head(name, seed):
    return OpticalFlowReg(name, generator=torch.Generator().manual_seed(seed))


def _train_step(head, name):
    state = create_train_state(head)
    synth = partial(synth_image_batch, size=SIZE, magnitude=(0.0, 0.5))
    step = make_train_step(state, loss_kwargs=default_loss_kwargs(name), synth=synth)
    flat = torch.rand(6, 80, 80, generator=torch.Generator().manual_seed(1))
    return step, (7, flat, torch.tensor([1, 4]))


def _profiled(fn, path):
    """``fn()`` under ``torch.profiler`` on the CPU; (its result, the
    trace's complete events)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return out, [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _spans(events):
    """[(name, start, end)] of the ``tpureg.*`` ranges, by start."""
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("tpureg.")), key=lambda s: s[1])


def _children(spans, parent):
    """Names of the spans directly inside the one span named ``parent``, in
    order."""
    (p0, p1), = [(a, b) for n, a, b in spans if n == parent]
    inside = [(n, a, b) for n, a, b in spans if p0 <= a and b <= p1 and n != parent]
    return [n for n, a, b in inside
            if not any(m != n and c <= a and b <= d and (c, d) != (a, b)
                       for m, c, d in inside)]


@pytest.fixture(scope="module")
def flownet2_trace(tmp_path_factory):
    """The events of a profiled FlowNet2 train step, after one unprofiled."""
    step, spec = _train_step(_head("flownet2", 0), "flownet2")
    step(spec)
    _, events = _profiled(lambda: step(spec),
                          tmp_path_factory.mktemp("trace") / "flownet2.json")
    return events


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("tpureg.model"), profiling.span("tpureg.loss")
    assert a is b is profiling._NULL
    with a:
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        inside = profiling.span("tpureg.model")
        with inside:
            torch.ones(2).sum()
    assert isinstance(inside, torch.profiler.record_function)
    assert [e.name for e in prof.events() if e.name.startswith("tpureg.")] == \
        ["tpureg.model"]
    assert profiling.span("tpureg.model") is profiling._NULL


def test_kernel_launches_sums_every_counter(monkeypatch):
    base = profiling.kernel_launches()
    assert base == sum(launch.launches for _, _, launch in OPS)
    for i, (_, _, launch) in enumerate(OPS):
        monkeypatch.setattr(launch, "launches", launch.launches + 10 ** i)
    assert profiling.kernel_launches() == base + sum(10 ** i for i in range(len(OPS)))


def test_flownet2_train_step_spans(flownet2_trace):
    spans = _spans(flownet2_trace)
    assert _children(spans, "tpureg.train_step") == [
        "tpureg.synth", "tpureg.model", "tpureg.warp", "tpureg.loss",
        "tpureg.backward", "tpureg.optimizer"]
    assert _children(spans, "tpureg.model") == [
        f"tpureg.model.{s}" for s in FLOWNET2_STAGES]


def test_convolution_backward_links_to_a_model_stage(flownet2_trace):
    """Each ``evaluate_function`` node of a convolution's backward carries
    the sequence number of its forward op, which lies inside a stage; one
    node a forward convolution of the model."""
    stages = [(a, b) for n, a, b in _spans(flownet2_trace)
              if n.startswith("tpureg.model.")]
    (m0, m1), = [(a, b) for n, a, b in _spans(flownet2_trace) if n == "tpureg.model"]
    forward, convs = {}, 0
    for e in flownet2_trace:
        seq = e.get("args", {}).get("Sequence number")
        if e.get("cat") != "cpu_op" or seq is None or "Backward" in e["name"]:
            continue
        forward.setdefault(seq, []).append(e["ts"])
        convs += e["name"] == "aten::convolution" and m0 <= e["ts"] <= m1
    nodes = [e for e in flownet2_trace
             if e["name"] == "autograd::engine::evaluate_function: ConvolutionBackward0"]
    assert len(nodes) == convs > 0
    for node in nodes:
        # the latest forward op of that number before the node
        ts = max(t for t in forward[node["args"]["Sequence number"]] if t < node["ts"])
        assert any(a <= ts <= b for a, b in stages), node


def test_pwc_eval_step_spans(tmp_path):
    head = _head("pwc-reg", 3)
    step = make_eval_step(head, loss_kwargs=default_loss_kwargs("pwc-reg"))
    imgs = torch.rand(BATCH, SIZE, SIZE, 2, generator=torch.Generator().manual_seed(2))
    _, events = _profiled(lambda: step(imgs, imgs.round()), tmp_path / "pwc.json")
    spans = _spans(events)
    assert _children(spans, "tpureg.eval_step") == [
        "tpureg.model", "tpureg.warp", "tpureg.loss"]
    assert _children(spans, "tpureg.model") == [f"tpureg.model.{s}" for s in PWC_STAGES]


def test_profiler_changes_no_number_of_a_train_step(tmp_path):
    """pwc-reg's train step from one state, with the profiler off and on:
    the loss terms, the gradients and the updated parameters bit for bit."""
    head = _head("pwc-reg", 5)
    results = []
    for profiled in (False, True):
        h = copy.deepcopy(head)
        step, spec = _train_step(h, "pwc-reg")
        if profiled:
            metrics, events = _profiled(lambda: step(spec), tmp_path / "t.json")
            assert _spans(events)
        else:
            metrics = step(spec)
        results.append((metrics, {n: (p.detach().clone(), p.grad.clone())
                                  for n, p in h.named_parameters()}))
    (m0, p0), (m1, p1) = results
    assert m0.keys() == m1.keys() and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert p0.keys() == p1.keys()
    for n in p0:
        assert torch.equal(p0[n][0], p1[n][0]) and torch.equal(p0[n][1], p1[n][1]), n
