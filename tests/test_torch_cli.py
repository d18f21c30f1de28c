"""The port's two CLIs on the CPU: training on random batches with its
two checkpoint tiers and resume, evaluation in ``--mode synthetic`` on small
Analyze volumes, the TensorBoard tags each writes, and the training CLI's
refusal without a card.

The CLIs' TensorBoard writer is replaced by ``RecordingWriter`` (fixture
``tb_records``), which keeps the tag, step and shape of each call: the
tags are held against tpureg's, and no test pays for importing
``torch.utils.tensorboard`` (which loads TensorFlow here, about 10 s a
process).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import tpureg_torch.utils.tb as tb
from test_torch_elastic import write_analyze
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.train import (
    best_weight_path,
    save_best_weights,
    training_state_path,
)

TRAIN_ARGS = ["--model", "flownet2", "--synthetic", "2", "--image_size", "64",
              "--batch_size", "2"]


@pytest.fixture(scope="module")
def one_torch_thread():
    """Torch on one thread for a module's tests: six test workers on eight
    cores, each on every core, oversubscribe them (the FlowNet2 CLI test
    below took 322 s in a whole run on 6 workers; alone 25.5 s on 8
    threads, 36.7 s on one). Modules take it with
    ``pytestmark = pytest.mark.usefixtures("one_torch_thread")``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


class RecordingWriter:
    """Stands in for TensorBoard's ``SummaryWriter`` behind ``MetricWriter``:
    keeps ``(kind, tag, step, detail)`` of each call (the members of a
    scalar group, the shape of an image batch) and checks each value."""

    def __init__(self, logdir):
        self.logdir = logdir
        self.calls = []
        self.closed = False

    def add_scalar(self, tag, value, step):
        assert np.isfinite(value), (tag, value)
        self.calls.append(("scalar", tag, step, None))

    def add_scalars(self, tag, values, step):
        assert all(np.isfinite(v) for v in values.values()), (tag, values)
        self.calls.append(("scalars", tag, step, tuple(sorted(values))))

    def add_images(self, tag, images, step):
        assert images.ndim == 4, (tag, images.shape)
        self.calls.append(("images", tag, step, images.shape))

    def close(self):
        self.closed = True

    def tags(self):
        """Each (kind, tag) in the order of its first call."""
        return list(dict.fromkeys((kind, tag) for kind, tag, _, _ in self.calls))


@pytest.fixture
def tb_records(monkeypatch):
    """The writers the CLIs make, as ``RecordingWriter``s, in order."""
    writers = []

    def make(logdir, flush_secs):
        writers.append(RecordingWriter(logdir))
        return writers[-1]

    monkeypatch.setattr(tb, "_make_writer", make)
    return writers


# the training CLI's tags an epoch: tpureg/cli/train.py:341 (lr) and :365
# (each loss term's train/val/test group)
TRAIN_TAGS = [("scalar", "lr")] + [
    ("scalars", t) for t in ("loss", "photo_loss", "corr_loss", "smooth_loss")]
# the inference CLI's, a batch: tpureg/cli/inference.py:92-97 (the panels;
# flow_mag needs OpenCV) and :100-101 (each metric's average and latest
# value); then :189 (each loss term's eval group)
EVAL_METRICS = ("dice", "mse", "psnr", "hausdorff", "ssim_img", "ssim_seg",
                "mi", "corr", "mag", "neg_jac", "log_jac_std")
EVAL_TAGS = ([("images", t) for t in ("fixed_img", "moving_img", "warped_img",
                                      "warped_grid", "flow_mag")]
             + [("scalar", f"{m}_{s}") for m in EVAL_METRICS
                for s in ("avg", "single")]
             + [("scalars", t) for t in ("loss", "photo_loss", "corr_loss",
                                         "smooth_loss")])


def eval_tags():
    """EVAL_TAGS without the JET panel where OpenCV does not import."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return [t for t in EVAL_TAGS if t != ("images", "flow_mag")]
    return EVAL_TAGS


@pytest.fixture
def work_path(tmp_path):
    """``tmp_path``, deleted when the test ends. A CLI test's checkpoints are
    large (FlowNet2's training state and best weights: 2.5 GB), and pytest
    keeps the temporary directories of its last three runs: left in place,
    they filled the disk under a whole run of the suite."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_train_cli_writes_both_tiers_and_resumes(work_path, capsys, tb_records):
    from tpureg_torch.cli.train import main

    work = str(work_path)
    args = TRAIN_ARGS + ["--workdir", work, "--logdir", str(work_path / "log")]
    state = main(args + ["--epochs", "1", "--cp", "0"], device="cpu")
    out = capsys.readouterr().out
    assert "EPOCH 1/1" in out and "[TRAIN batch 001/2]" in out
    assert "===> VAL done" in out and "===> TEST done" in out
    assert "saving new best weights" in out and "Train complete" in out
    assert state.step == 2
    tiers = (training_state_path(work, "FlowNet2"), best_weight_path(work, "FlowNet2"))
    for path in tiers:
        assert os.path.isfile(path), path
    stamps = [os.path.getmtime(p) for p in tiers]

    # a rerun with --cp 1 restores the state and skips the finished epoch
    state = main(args + ["--epochs", "2", "--cp", "1"], device="cpu")
    out = capsys.readouterr().out
    assert "loading checkpoint state" in out
    assert "EPOCH 1/2" not in out and "EPOCH 2/2" in out
    assert state.step == 4
    assert os.path.getmtime(tiers[0]) > stamps[0]
    # each run's writer: its epochs' tags, under --logdir, closed
    assert [w.logdir for w in tb_records] == [str(work_path / "log")] * 2
    for w, epochs in zip(tb_records, ([1], [2])):
        assert w.closed and w.tags() == TRAIN_TAGS
        assert sorted({step for *_, step, _ in w.calls}) == epochs
        assert all(d == ("test", "train", "val") for k, _, _, d in w.calls
                   if k == "scalars")


def test_train_cli_halts_on_a_non_finite_loss(tmp_path, monkeypatch, tb_records):
    from tpureg_torch.cli import train as cli_train

    real = cli_train.make_train_step

    def poisoned(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda imgs: {k: v * float("nan") for k, v in step(imgs).items()}

    monkeypatch.setattr(cli_train, "make_train_step", poisoned)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        cli_train.main(TRAIN_ARGS + ["--epochs", "1", "--cp", "0", "--workdir",
                                     str(tmp_path), "--logdir",
                                     str(tmp_path / "log")], device="cpu")
    assert not os.path.exists(training_state_path(str(tmp_path), "FlowNet2"))


def test_inference_cli_synthetic_mode_runs_on_cpu(work_path, capsys, tb_records):
    from tpureg_torch.cli.inference import main

    rng = np.random.default_rng(5)
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
    model = OpticalFlowReg("flownet2", generator=torch.Generator().manual_seed(0))
    save_best_weights(str(work_path), "FlowNet2", model, {"loss": 1.0})

    results = main([
        "--mode", "synthetic", "--model", "flownet2", "--batch_size", "1",
        "--img_dir", str(work_path / "img"), "--seg_dir", str(work_path / "seg"),
        "--workdir", str(work_path), "--logdir", str(work_path / "log"),
        "--max_samples", "2",
    ], device="cpu")
    out = capsys.readouterr().out
    assert "[EVAL batch 001/160]" in out and "===> EVAL summary" in out
    for key in ("loss", "dice", "mse", "psnr", "ssim_img", "mag", "neg_jac"):
        assert key in results and np.isfinite(results[key]), key
    (w,) = tb_records
    assert w.closed and w.tags() == eval_tags()
    assert {step for kind, _, step, _ in w.calls if kind != "scalars"} == {1, 2}
    assert all(d == ("eval",) for k, _, _, d in w.calls if k == "scalars")
    panels = [d for k, _, step, d in w.calls if k == "images" and step == 1]
    assert all(d[0] == 1 and d[2:] == (256, 256) for d in panels)


def test_train_cli_refuses_a_missing_card(monkeypatch, tmp_path):
    from tpureg_torch.cli.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(TRAIN_ARGS + ["--workdir", str(tmp_path)])
    assert not os.listdir(tmp_path)
