"""The frozen work arithmetic reproduces the bounds that PERF.md's kernel
table (§6) gives, and the FLOP count on meta tensors the forward's
operations of each configuration."""

import pytest
import torch

from portbench.work import work
from portbench.work.count import count

US = 1e-6


@pytest.mark.parametrize("name, fn, expect_us, by", [
    ("K1 FlowNetC fp32", lambda: work.correlation_work((8, 256, 32, 32), 20, 2),
     12.49, "operations"),
    ("K2 FlowNetC fp32", lambda: work.correlation_bwd_work((8, 256, 32, 32), 20, 2),
     24.98, "operations"),
    ("K1 PWC level 2", lambda: work.correlation_work((8, 32, 64, 64), 4, 1), 5.67,
     "bytes"),
    ("K2 PWC level 2", lambda: work.correlation_bwd_work((8, 32, 64, 64), 4, 1), 8.18,
     "bytes"),
    ("K3 stn", lambda: work.warp_work((8, 1, 256, 256), 256 * 256), 2.50, "bytes"),
    ("K4 FlowNet2", lambda: work.warp_dpos_work((8, 1, 256, 256), 256 * 256), 3.76,
     "bytes"),
    ("K5 stn", lambda: work.warp_dimg_work((8, 1, 256, 256), 256 * 256), 2.50, "bytes"),
    ("K6a final warp", lambda: work.warp3d_work((2, 1, 176, 256, 256), 176 * 256 * 256),
     137.72, "bytes"),
])
def test_bounds_of_perf_table(name, fn, expect_us, by):
    t, what = work.bound(*fn())
    assert what == by
    assert t / US == pytest.approx(expect_us, abs=0.006)


@pytest.mark.parametrize("workload, gflop_per_pair, calls", [
    ("flownet2-reg-b16", 64.088, 8),       # K1 1, K3 7
    ("flownet2-train-b24", 191.907, 8),    # K1 1, K3 6 and the synthesis's
    ("pwcreg-train-b24", 78.794, 22),      # K1 5, K3 16 and the synthesis's
])
def test_step_work(workload, gflop_per_pair, calls):
    from portbench import cell as cell_mod

    cell = cell_mod.load(workload)
    t = cell.traffic
    w = count(cell.reference().build, cell.config, cell.kind, t["batch"],
              t["image_size"])
    assert w.flops / t["batch"] / 1e9 == pytest.approx(gflop_per_pair, abs=1e-3)
    assert w.calls == calls
    assert w.kernel_bound_s > 0


def test_correlation_flops_of_flownetc():
    """0.105 GFLOP a pair of FlowNet2's forward is the correlation's: 256
    channels at 32², 452 in-image taps an axis."""
    _, flops = work.correlation_work((1, 256, 32, 32), 20, 2)
    assert flops == 2 * 256 * 452 * 452
    assert work.PEAK_FLOPS[torch.float32] == 67e12
