"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name:

- the configuration: ``configs[].file`` (a JSON file of sizes, with the
  name of its plain reference in ``portbench/reference/<reference>.py``);
- the traffic mix: ``portbench/traffic/<traffic>.json``, parameters that
  the loop of its ``kind`` (``portbench/loops/<kind>.py``) reads;
- the limits of the numbers that decide ``correct``:
  ``portbench/limits/<workload>.json``;
- each end-to-end metric: ``portbench/end_to_end/<metric>.py``, and each
  per-layer metric: ``portbench/layer_metrics/<metric>.py``, whose
  ``read(run)`` returns the metric or None.

A later cell, mix, kind of loop, configuration or metric is new files and
new entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def loop(self):
        """The loop module of the mix's kind."""
        from . import loops
        return loops.kind(self.kind)

    def reference(self):
        """The configuration's plain reference module (``build``, ``init_rule``)."""
        return importlib.import_module(f"portbench.reference.{self.config['reference']}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_path.name}: "
                         f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((bench_path.parent / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return Cell(workload, w["chips"], config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])


def reader(metric: str, folder: str = "layer_metrics"):
    """The ``read`` function of ``<folder>/<metric>.py``: ``layer_metrics``
    or ``end_to_end``."""
    path = HERE / folder / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
