"""BENCHMARK.json keeps to the benchmark's contract, and every cell's
files resolve by name, including a cell that a later change adds as new
files and new entries only."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, WORKLOADS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert UNIT.match(m["unit"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves(workload):
    from portbench import cell as cell_mod

    cell = cell_mod.load(workload)
    assert callable(cell.loop().run) and callable(cell.loop().control)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end:
        assert callable(cell_mod.reader(m["name"], "end_to_end"))
    for m in cell.per_layer:
        assert callable(cell_mod.reader(m["name"]))
        # a per-layer metric of a cell moves an end-to-end metric the cell reports
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
    ref = cell.reference()
    assert callable(ref.build) and callable(ref.init_rule)
    assert set(cell.limits)


def test_new_cell_from_new_files_only(tmp_path):
    """A throwaway configuration, mix of a new kind, loop, limits file,
    end-to-end and per-layer metric, added to a copy as new files and new
    entries, load by name."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "pwc-reg.json").read_text())
    (pb / "configs" / "pwc-md2.json").write_text(json.dumps(
        {**cfg, "name": "pwc-md2", "correlation": {"max_displacement": 2, "stride2": 1}}))
    (pb / "traffic" / "train_b8.json").write_text(json.dumps(
        {**json.loads((pb / "traffic" / "train_b24.json").read_text()), "batch": 8,
         "kind": "train_twice"}))
    (pb / "loops" / "train_twice.py").write_text(
        "from portbench.loops.train import control, run as _run\n"
        "def run(run):\n    _run(run)\n")
    (pb / "end_to_end" / "train_steps_per_s.py").write_text(
        "def read(run):\n    return run.attempted / run.window_s\n")
    (pb / "limits" / "pwcmd2-train-b8.json").write_text(
        (pb / "limits" / "pwcreg-train-b24.json").read_text())
    (pb / "layer_metrics" / "steps_per_s.train.py").write_text(
        "def read(run):\n    return run.attempted / run.window_s\n")
    bench["configs"].append({"name": "pwc-md2", "source": "x",
                             "file": "portbench/configs/pwc-md2.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "pwcmd2-train-b8", "config": "pwc-md2",
                               "traffic": "train_b8", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps_per_s.train", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "steps and registrations",
                               "moves": "train_pairs_per_s",
                               "workloads": ["pwcmd2-train-b8"]})
    bench["end_to_end"][0]["workloads"].append("pwcmd2-train-b8")
    bench["end_to_end"].insert(1, {"name": "train_steps_per_s", "unit": "1/s",
                                   "better": "higher", "bound": 0.05,
                                   "source": "host_clock",
                                   "workloads": ["pwcmd2-train-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from portbench import cell as c\n"
            "x = c.load('pwcmd2-train-b8')\n"
            "assert x.config['correlation']['max_displacement'] == 2\n"
            "assert x.traffic['batch'] == 8\n"
            "assert [m['name'] for m in x.per_layer][-1] == 'steps_per_s.train'\n"
            "assert c.reader('steps_per_s.train')\n"
            "assert [m['name'] for m in x.end_to_end] == "
            "['train_pairs_per_s', 'train_steps_per_s', 'setup_s']\n"
            "assert c.reader('train_steps_per_s', 'end_to_end')\n"
            "assert callable(x.loop().run) and x.loop().__name__.endswith('train_twice')\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("precision", ["bf16", "fp16", "float32"])
def test_unknown_precision_is_refused(precision):
    """A configuration whose precision the benchmark does not implement is
    refused by the program's side and the reference's, not run in fp32."""
    from portbench import cell as cell_mod, loops, system

    config = {**cell_mod.load(WORKLOADS[0]).config, "precision": precision}
    with pytest.raises(ValueError, match="precision"):
        system.check_precision(config)
    with pytest.raises(ValueError, match="precision"):
        loops.precisions(config)


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    """Without a card, or in a directory holding only BENCHMARK.json and
    portbench/, a run exits non-zero and prints no result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "flownet2-reg-b16", "--seed", str(2**31 + 5), "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
