"""Shared pieces of the benchmark's tests: the repository root on the
path, small copies of the cells for the CPU, and the card fixture."""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

WORKLOADS = tuple(w["name"] for w in
                  json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])
# a size the CPU runs in seconds: every width as configured, 64² images,
# two pairs a step or request, one volume
SMALL = dict(batch=2, image_size=64, volumes=1, pool=3,
             trace_steps=1, trace_requests=1, warmup_requests=1, checked_requests=2)


def small_cell(workload: str):
    from portbench import cell as cell_mod

    cell = cell_mod.load(workload)
    return dataclasses.replace(cell, traffic={**cell.traffic, **SMALL})


@pytest.fixture
def cpu_threads():
    """Four threads for the CPU runs, put back after."""
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    """The first CUDA card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
