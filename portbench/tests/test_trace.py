"""The trace readers on a small hand-written Chrome trace: ``stages``
(device and idle time by the program's spans, backward work through the
autograd nodes' sequence numbers) and ``trace.summarize``'s fields, pinned.

The fixture, in µs on a window of 1000: the main thread (1) opens
``dispatch`` and ``tpureg.train_step`` holding the model's two stages, the
loss, the backward and the optimizer; autograd's worker thread (2) runs
three ``evaluate_function`` nodes, whose sequence numbers lead to the
forward ops of the loss and of the stages b and a."""

import json

import pytest

from portbench import stages, trace

MAIN, WORKER = 1, 2


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def _kernel(name, corr, ts, dur, launch=None):
    """A kernel and, with ``launch`` (tid, ts), its launch."""
    out = [_x("kernel", name, 7, ts, dur, correlation=corr)]
    if launch:
        out.append(_x("cuda_runtime", "cudaLaunchKernel", launch[0], launch[1], 1,
                      correlation=corr))
    return out


def _events():
    ann = "user_annotation"
    ev = [
        _x(ann, "pb.window", MAIN, 0, 1000),
        _x(ann, "dispatch", MAIN, 10, 890),
        _x(ann, "sync", MAIN, 900, 100),
        _x(ann, "tpureg.train_step", MAIN, 20, 860),
        _x(ann, "tpureg.model", MAIN, 25, 275),
        _x(ann, "tpureg.model.a", MAIN, 40, 110),
        _x(ann, "tpureg.model.b", MAIN, 160, 130),
        _x(ann, "tpureg.loss", MAIN, 310, 40),
        _x(ann, "tpureg.backward", MAIN, 360, 340),
        _x(ann, "tpureg.optimizer", MAIN, 720, 150),
        # forward ops, with the sequence numbers of their autograd nodes
        _x("cpu_op", "aten::convolution", MAIN, 50, 12, **{"Sequence number": 5}),
        _x("cpu_op", "aten::cudnn_convolution", MAIN, 52, 8),
        _x("cpu_op", "tpureg::correlation", MAIN, 170, 10, **{"Sequence number": 6}),
        _x("cpu_op", "aten::mm", MAIN, 320, 8, **{"Sequence number": 7}),
        # the backward, on the worker thread
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", WORKER,
           400, 50, **{"Sequence number": 7, "Fwd thread id": 1}),
        _x("cpu_op", "autograd::engine::evaluate_function: TpuregBackward", WORKER,
           460, 100, **{"Sequence number": 6, "Fwd thread id": 1}),
        _x("cpu_op", "TpuregBackward", WORKER, 461, 98, **{"Sequence number": 6}),
        _x("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0",
           WORKER, 570, 120, **{"Sequence number": 5, "Fwd thread id": 1}),
        _x("cpu_op", "aten::convolution_backward", WORKER, 575, 110),
    ]
    ev += _kernel("conv_fwd", 1, 60, 40, (MAIN, 55))
    ev += _kernel("corr_fwd_kernel", 2, 110, 90, (MAIN, 175))
    ev += _kernel("gemm", 3, 330, 10, (MAIN, 325))
    ev += _kernel("gemm", 4, 420, 40, (WORKER, 410))
    ev += _kernel("corr_bwd_kernel", 5, 480, 80, (WORKER, 470))
    ev += _kernel("dgrad", 6, 600, 90, (WORKER, 580))
    ev += _kernel("adam", 7, 730, 130, (MAIN, 730))
    ev += _kernel("lost", 99, 870, 10)                  # no launch in the trace
    ev += _kernel("fill", 8, 885, 10, (MAIN, 884))      # dispatch, no program span
    return ev


@pytest.fixture
def path(tmp_path):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": _events()}))
    return str(p)


def test_stages_by_program_span(path):
    s = stages.summarize(path)
    rows = {n: r for n, *r in s.rows}
    us = 1e-6
    assert rows == {
        "tpureg.model": pytest.approx([0, 0, 60 * us]),
        "tpureg.model.a": pytest.approx([40 * us, 90 * us, 50 * us]),
        "tpureg.model.b": pytest.approx([90 * us, 80 * us, 150 * us]),
        "tpureg.loss": pytest.approx([10 * us, 40 * us, 0]),
        "tpureg.backward": pytest.approx([0, 0, 80 * us]),
        "tpureg.train_step": pytest.approx([0, 0, 40 * us]),
        "tpureg.optimizer": pytest.approx([130 * us, 0, 10 * us]),
        "other": pytest.approx([10 * us, 0, 0]),
        "dispatch": pytest.approx([10 * us, 0, 5 * us]),
        "sync": pytest.approx([0, 0, 105 * us]),
    }
    assert s.busy_s == pytest.approx(500 * us) and s.idle_s == pytest.approx(500 * us)
    assert s.unspanned_device_share() == pytest.approx(20 / 500)
    assert s.unspanned_device_share(also=("other",)) == pytest.approx(10 / 500)
    assert s.dispatch_idle_s == pytest.approx(395 * us)
    assert s.unspanned_dispatch_idle_share() == pytest.approx(5 / 395)
    assert [r[0] for r in s.rows][:2] == ["tpureg.model.b", "tpureg.model.a"]


def test_backward_kernel_goes_to_the_stage_of_its_forward_op(path):
    """The worker's kernel under the node of sequence number 5 is stage a's
    backward, though stage a closed long before its launch; the idle gap
    while that node is open (560-600) is stage a's too."""
    events = [e for e in _events() if e["args"].get("correlation") not in (1, 2, 3)]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    rows = {n: r for n, *r in stages.summarize(path).rows}
    assert rows["tpureg.model.a"][:2] == pytest.approx([0, 90e-6])
    assert rows["tpureg.model.a"][2] == pytest.approx(40e-6)


def test_trace_without_a_window_is_refused(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": _events()[1:]}))
    with pytest.raises(RuntimeError, match="pb.window"):
        stages.summarize(str(p))


def test_summary_fields_as_pinned(path):
    """``trace.summarize``'s fields on the fixture, pinned."""
    s = trace.summarize(path)
    us = 1e-6
    assert s.window_s == pytest.approx(1000 * us)
    assert s.busy_s == pytest.approx(500 * us)
    assert s.program_ops_s == pytest.approx(90 * us)
    assert s.products_s == pytest.approx(140 * us)
    assert s.unattributed == 1
    assert [n for n, _ in s.device_ops] == ["adam", "corr_fwd_kernel", "dgrad",
                                            "corr_bwd_kernel", "gemm", "conv_fwd",
                                            "lost", "fill"]
    assert [v for _, v in s.device_ops] == pytest.approx(
        [130 * us, 90 * us, 90 * us, 80 * us, 50 * us, 40 * us, 10 * us, 10 * us])
    assert s.idle_gaps == [("dispatch", pytest.approx(395 * us)),
                           ("sync", pytest.approx(105 * us))]


def test_kernel_launches_a_step_from_the_program_counter(monkeypatch):
    """Launches over every step the run made; None for another kind or a
    program without the counter."""
    from types import SimpleNamespace

    from portbench import counters
    from tpureg_torch.utils import profiling

    traffic = {"checked_steps": 2, "warmup_steps": 3, "warmup_requests": 1}
    run = SimpleNamespace(kind="train", attempted=10, traced_units=5,
                          cell=SimpleNamespace(traffic=traffic))
    monkeypatch.setattr(profiling, "kernel_launches", lambda: 14 * 20)
    assert counters.kernel_launches(run, "train") == 14
    assert counters.kernel_launches(run, "reg") is None
    run.kind = "reg"
    assert counters.kernel_launches(run, "reg") == 14 * 20 / 16
    monkeypatch.delattr(profiling, "kernel_launches")
    assert counters.kernel_launches(run, "reg") is None
