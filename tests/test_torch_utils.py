"""The port's host utilities on the CPU: ``MetricWriter`` (events read back
with TensorBoard's ``EventAccumulator``, the tensorboardX fallback, and the
no-op path with its one warning), ``flow_io`` bit for bit against tpureg's
on the same arrays, and ``profiling.trace`` (a ``torch.profiler`` trace;
the spans are ``test_torch_tracing.py``'s)."""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from tpureg.utils import flow_io as jax_flow_io
from tpureg_torch.utils import flow_io, span, trace
from tpureg_torch.utils.tb import MetricWriter

# ---------------------------------------------------------------------------
# TensorBoard


def test_metric_writer_events_read_back(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    logdir = str(tmp_path / "log")
    w = MetricWriter(logdir, flush_secs=1)
    assert w.enabled
    w.add_scalar("lr", np.float32(0.25), 3)
    w.add_scalars("loss", {"train": 1.5, "val": torch.tensor(2.5)}, 3)
    w.add_images("fixed_img", np.full((2, 8, 8, 1), 0.5, np.float32), 3)
    w.add_images("flow_mag", np.zeros((1, 3, 8, 8), np.uint8), 3,
                 dataformats="NCHW")
    w.close()

    acc = EventAccumulator(logdir).Reload()
    assert [(e.step, e.value) for e in acc.Scalars("lr")] == [(3, 0.25)]
    assert set(acc.Tags()["images"]) == {"fixed_img", "flow_mag"}
    for member, value in (("train", 1.5), ("val", 2.5)):
        group = EventAccumulator(os.path.join(logdir, f"loss_{member}")).Reload()
        assert [(e.step, e.value) for e in group.Scalars("loss")] == [(3, value)]


def test_metric_writer_falls_back_to_tensorboardx(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = MetricWriter(str(tmp_path / "log"))
    assert type(w._w).__module__.startswith("tensorboardX")
    w.add_scalar("lr", 1.0, 1)
    w.close()
    assert glob.glob(str(tmp_path / "log" / "events.out.tfevents.*"))
    assert "WARNING" not in capsys.readouterr().err


def test_metric_writer_without_a_backend_warns_once(tmp_path, monkeypatch, capsys):
    """As on the card's machine, which has neither package: one warning on
    stderr, every call a no-op, nothing written."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    logdir = tmp_path / "log"
    w = MetricWriter(str(logdir))
    assert not w.enabled
    w.add_scalar("lr", 1.0, 1)
    w.add_scalars("loss", {"train": 1.0}, 1)
    w.add_images("fixed_img", np.zeros((1, 4, 4, 1), np.float32), 1)
    w.close()
    err = capsys.readouterr().err
    assert err.count("WARNING: no TensorBoard backend available") == 1
    assert repr(str(logdir)) in err and "DISABLED" in err
    assert not logdir.exists()


# ---------------------------------------------------------------------------
# flow_io


def flows(seed, h=13, w=17):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 4, (h, w, 2)).astype(np.float32)
    f[0, 0] = (4e7, 0)        # unknown: rendered black
    f[1, 1] = (np.nan, 1)
    f[2, 2] = (0, 0)
    return f


def test_flo_files_are_tpuregs_byte_for_byte(tmp_path):
    f = flows(0)
    flow_io.write_flo(str(tmp_path / "a.flo"), f)
    jax_flow_io.write_flo(str(tmp_path / "b.flo"), f)
    a, b = ((tmp_path / n).read_bytes() for n in ("a.flo", "b.flo"))
    assert a == b and len(a) == 12 + f.nbytes
    for read in (flow_io.read_flo, flow_io.read_gen):
        got = read(str(tmp_path / "b.flo"))
        want = jax_flow_io.read_flo(str(tmp_path / "a.flo"))
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want, equal_nan=True)


def test_read_flo_refuses_what_tpureg_refuses(tmp_path):
    path = tmp_path / "bad.flo"
    path.write_bytes(np.array([1.0], np.float32).tobytes())
    for read in (flow_io.read_flo, jax_flow_io.read_flo):
        with pytest.raises(ValueError, match="bad .flo magic"):
            read(str(path))
    flow_io.write_flo(str(path), flows(1))
    path.write_bytes(path.read_bytes()[:-4])
    for read in (flow_io.read_flo, jax_flow_io.read_flo):
        with pytest.raises(ValueError, match="truncated"):
            read(str(path))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flow_to_image_is_tpuregs(seed):
    f = flows(seed) * (seed + 0.5)
    got, want = flow_io.flow_to_image(f), jax_flow_io.flow_to_image(f)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (13, 17, 3)
    assert np.array_equal(got, want)
    assert not got[0, 0].any()   # the unknown flow is black
    assert np.array_equal(flow_io.make_color_wheel(), jax_flow_io.make_color_wheel())


def test_read_gen_reads_images_as_tpureg(tmp_path):
    from PIL import Image

    img = np.random.default_rng(3).integers(0, 256, (6, 5), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    got = flow_io.read_gen(str(tmp_path / "a.png"))
    assert got.shape == (6, 5, 1)
    assert np.array_equal(got, jax_flow_io.read_gen(str(tmp_path / "a.png")))
    with pytest.raises(ValueError, match="unsupported extension .txt"):
        flow_io.read_gen(str(tmp_path / "a.txt"))


# ---------------------------------------------------------------------------
# profiling


def test_trace_writes_a_tensorboard_profile(tmp_path):
    a = torch.ones(16, 16)
    with trace(str(tmp_path / "prof")) as prof:
        with span("tpureg.model"):
            (a @ a).sum()
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    (path,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.get("name") == "tpureg.model" for e in events)
