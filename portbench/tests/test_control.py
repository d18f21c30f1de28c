"""What decides ``correct`` fails what it must: the control (the reference
in TF32, one precision below the configurations' fp32) against each cell's
limits, and a run whose timed path is broken underneath (the harness's
look for a card skipped, the CPU at a small size): a training step that
leaves its state unchanged, sees half of each batch, or whose backward
gives every other leaf a gradient of the right norm in a wrong direction
(its elements permuted, which no norm sees), a registration
whose answer is altered where it is produced or that serves half of each
request. On the card, the control at the cells' own size."""

import time

import pytest
import torch

from conftest import WORKLOADS, small_cell

from portbench import checks, loops, system
from portbench.run import execute, result_line

def _train_fault(kind, real):
    """``system.train_step`` with its step broken underneath: "unchanged"
    leaves the state as it was, "half_batch" trains on the first half of
    each batch (its loss the mean over those rows), "wrong_backward"
    permutes the elements of every other leaf's gradient before Adam."""

    def patched(config, traffic, head):
        state, step = real(config, traffic, head)
        if kind == "unchanged":
            state.apply_gradients = lambda: None
            return state, step
        if kind == "wrong_backward":
            apply = state.apply_gradients
            gen = torch.Generator().manual_seed(5)

            def scrambled():
                for p in list(head.parameters())[::2]:
                    if p.grad is not None:
                        g = p.grad.flatten()
                        perm = torch.randperm(g.numel(), generator=gen).to(g.device)
                        p.grad = g[perm].view_as(p.grad)
                apply()

            state.apply_gradients = scrambled
            return state, step

        def half(spec):
            seed, corpus, rows = spec
            return step((seed, corpus, rows[:rows.shape[0] // 2]))

        return state, half

    return patched


def _reg_fault(kind, real):
    """``system.eval_step`` broken underneath: "altered" changes one value
    of the finest flow where it is produced, "half_batch" serves the first
    half of each request and leaves the rest of the answer empty."""

    def patched(config, head):
        step = real(config, head)

        def broken(imgs, segs):
            if kind == "altered":
                (flows, *rest), metrics = step(imgs, segs)
                flow = flows[0].clone()
                flow[0, 0, 0, 0] += 0.5 * (1.0 + flow[0].abs().max())
                return ((flow, *flows[1:]), *rest), metrics
            n = imgs.shape[0] // 2
            outputs, metrics = step(imgs[:n], segs[:n])
            pad = lambda t: torch.cat([t, torch.zeros_like(t)])
            flows, warped, seg, grid = outputs
            return ((tuple(pad(f) for f in flows), tuple(pad(w) for w in warped),
                     pad(seg), pad(grid)), metrics)

        return broken

    return patched


FAULTS = [("pwcreg-train-b24", "unchanged"), ("pwcreg-train-b24", "half_batch"),
          ("pwcreg-train-b24", "wrong_backward"),
          ("flownet2-reg-b16", "altered"), ("flownet2-reg-b16", "half_batch")]


@pytest.mark.parametrize("workload, fault", FAULTS)
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch, cpu_threads):
    cell = small_cell(workload)
    if cell.kind == "train":
        monkeypatch.setattr(system, "train_step", _train_fault(fault, system.train_step))
    else:
        monkeypatch.setattr(system, "eval_step", _reg_fault(fault, system.eval_step))
    run = execute(cell, 2**31 + 77, 0.3, False, [torch.device("cpu")], time.perf_counter())
    out = result_line(run, cell)
    assert out["correct"] is False
    assert list(out)[-1] == "checks"
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def _control(cell, device, seed):
    run = loops.Run(cell, seed, 0.0, False, device, time.perf_counter())
    return cell.loop().control(run)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload, cpu_threads):
    cell = small_cell(workload)
    ok, readings = checks.judge(_control(cell, torch.device("cpu"), 2**31 + 3),
                                cell.limits)
    assert not ok, readings


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_on_the_card(workload, card):
    from portbench import cell as cell_mod

    cell = cell_mod.load(workload)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        ok, readings = checks.judge(_control(cell, card, seed), cell.limits)
        print(workload, seed, readings)
        assert not ok, readings


@pytest.mark.gpu
def test_wrong_backward_is_not_correct_on_the_card(card, monkeypatch):
    """pwc-reg at its own size with every other leaf's gradient permuted:
    the direction of the first gradient catches what no norm sees."""
    from portbench import cell as cell_mod

    cell = cell_mod.load("pwcreg-train-b24")
    monkeypatch.setattr(system, "train_step",
                        _train_fault("wrong_backward", system.train_step))
    run = execute(cell, 2**31 + 21, 1.0, False, [card], time.perf_counter())
    out = result_line(run, cell)
    print(out["checks"])
    assert out["correct"] is False
    assert out["checks"]["grad_dir_gap_p90"]["value"] > out["checks"]["grad_dir_gap_p90"]["limit"]
