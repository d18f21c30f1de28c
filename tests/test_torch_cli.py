"""The port's two CLIs on the CPU: training on random batches with its
two checkpoint tiers and resume, evaluation in ``--mode synthetic`` on small
Analyze volumes, and the training CLI's refusal without a card."""

import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_elastic import write_analyze
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.train import (
    best_weight_path,
    save_best_weights,
    training_state_path,
)

TRAIN_ARGS = ["--model", "flownet2", "--synthetic", "2", "--image_size", "64",
              "--batch_size", "2"]


@pytest.fixture
def work_path(tmp_path):
    """``tmp_path``, deleted when the test ends. A CLI test's checkpoints are
    large (FlowNet2's training state and best weights: 2.5 GB), and pytest
    keeps the temporary directories of its last three runs: left in place,
    they filled the disk under a whole run of the suite."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_train_cli_writes_both_tiers_and_resumes(work_path, capsys):
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


def test_train_cli_halts_on_a_non_finite_loss(tmp_path, monkeypatch):
    from tpureg_torch.cli import train as cli_train

    real = cli_train.make_train_step

    def poisoned(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda imgs: {k: v * float("nan") for k, v in step(imgs).items()}

    monkeypatch.setattr(cli_train, "make_train_step", poisoned)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        cli_train.main(TRAIN_ARGS + ["--epochs", "1", "--cp", "0", "--workdir",
                                     str(tmp_path)], device="cpu")
    assert not os.path.exists(training_state_path(str(tmp_path), "FlowNet2"))


def test_inference_cli_synthetic_mode_runs_on_cpu(work_path, capsys):
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


def test_train_cli_refuses_a_missing_card(monkeypatch, tmp_path):
    from tpureg_torch.cli.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(TRAIN_ARGS + ["--workdir", str(tmp_path)])
    assert not os.listdir(tmp_path)
