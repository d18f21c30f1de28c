"""The frozen reference agrees with tpureg_torch at a small size on the CPU:
the synthesis, both predictors' flows in both modes, the head's outputs,
the loss and the first training step. The two compute in fp32 by other
routes (grid_sample against the port's gathers, a shifted-product
correlation against the port's), so the tolerances are fp32 rounding's,
times the depth of the nets."""

import dataclasses
import time

import pytest
import torch

from conftest import small_cell

from portbench import checks, corpus, loops, system
from portbench.loops import reg as reg_loop, train as train_loop
from portbench.reference import steps as ref_steps

CELLS = {"flownet2": "flownet2-train-b24", "pwc-reg": "pwcreg-train-b24"}


def _run(workload):
    return loops.Run(small_cell(workload), 7, 0.0, False, torch.device("cpu"),
                     time.perf_counter())


def _both(workload):
    run = _run(workload)
    head = system.build_head(run.cell.config, loops.make_weights(run, 11))
    return run, head, loops.reference_predictor(run, 11)


def test_synthesis_matches(cpu_threads):
    from tpureg_torch.data.pipeline import synth_image_batch

    images, _ = corpus.make_corpus(5, 1, torch.device("cpu"))
    idx = torch.tensor([4, 50, 71])
    ours = synth_image_batch(123, images, idx, size=64, magnitude=(0.0, 0.5))
    ref, _ = ref_steps.synthesize(123, images, idx, 64, (0.0, 0.5))
    assert ours.shape == ref.shape == (3, 64, 64, 2)
    assert float((ours - ref).abs().max()) < 1e-5


@pytest.mark.parametrize("model", sorted(CELLS))
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_flows_match(model, train, cpu_threads):
    run, head, ref = _both(CELLS[model])
    head.train(train)
    ref.train(train)
    images, _ = corpus.make_corpus(5, 1, torch.device("cpu"))
    x, _ = ref_steps.synthesize(9, images, torch.tensor([10, 20]), 64, (0.0, 0.5))
    x = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        ours, theirs = head.predictor(x), ref(x)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1.0)


@pytest.mark.parametrize("model", sorted(CELLS))
def test_registration_outputs_match(model, cpu_threads):
    run = _run("flownet2-reg-b16")
    if model != "flownet2":  # pwc-reg under the same mix
        from portbench import cell as cell_mod
        run.cell = dataclasses.replace(run.cell, config=cell_mod.load(CELLS[model]).config)
    pool = reg_loop.request_pool(run, 3)[:2]
    head = system.build_head(run.cell.config, loops.make_weights(run, 11))
    step = system.eval_step(run.cell.config, head)
    prog = []
    for imgs, segs in pool:
        outputs, _ = step(imgs, segs)
        prog.append({"flow": outputs[0][0], "image": outputs[1][0], "seg": outputs[2]})
    ref = reg_loop.reference(run, pool, 11)
    gaps = checks.reg_gaps(prog, ref)
    assert gaps["flow_gap"] < 1e-5 and gaps["image_gap"] < 1e-4
    assert gaps["seg_gap"] < 1e-3


@pytest.mark.parametrize("model", sorted(CELLS))
def test_loss_matches(model, cpu_threads):
    from tpureg_torch.train import default_loss_kwargs, loss_from_outputs

    run, head, _ = _both(CELLS[model])
    head.train()
    images, _ = corpus.make_corpus(5, 1, torch.device("cpu"))
    x, _ = ref_steps.synthesize(9, images, torch.tensor([10, 20]), 64, (0.0, 0.5))
    with torch.no_grad():
        flows, warped, _, _ = head.register(x.permute(0, 3, 1, 2))
        ours = loss_from_outputs((flows, warped), x.permute(0, 3, 1, 2),
                                 default_loss_kwargs(model))
        theirs = ref_steps.ofe_loss(flows, warped, x.permute(0, 3, 1, 2)[:, 0:1],
                                    run.cell.config["loss"]["num_scales"])
    for a, b in zip(ours, theirs):
        assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b))


def test_first_train_step_matches(cpu_threads):
    """pwc-reg's first step through the harness's own train loop: the loss
    to fp32 rounding, the first gradient by the worst leaf within 1% in
    norm and 1e-4 in direction."""
    run = _run("pwcreg-train-b24")
    run.seconds = 0.0
    train_loop.run(run)
    assert run.gaps["loss1_gap"] < 1e-5
    assert run.gaps["grad_gap"] < 1e-2
    assert run.gaps["grad_dir_gap"] < 1e-4
