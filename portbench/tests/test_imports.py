"""Nothing the benchmark loads imports JAX or the JAX package, and the
frozen reference and work arithmetic load nothing of the program. Module
names are compared by their whole top-level name: ``tpureg_torch`` begins
with ``tpureg`` and is not it."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

PB = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "tpureg"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(*parts):
    return sorted((PB.joinpath(*parts)).rglob("*.py"))


@pytest.mark.parametrize("path", [p for p in _sources() if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_or_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("reference") + _sources("work"),
                         ids=lambda p: str(p.relative_to(PB)))
def test_reference_and_work_load_nothing_of_the_program(path):
    assert "tpureg_torch" not in _imports(path)


def test_loaded_modules_at_run_time():
    """What run.py loads, with the program's modules that the system under
    test imports, holds no JAX; the reference alone holds no tpureg_torch."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.reference.flownet2, portbench.reference.pwcnet\n"
        "import portbench.reference.steps, portbench.work.count\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'tpureg_torch' not in tops, 'the reference loaded the program'\n"
        "sys.argv = ['run.py']\n"
        "import runpy; ns = runpy.run_path(%r, run_name='not_main')\n"
        "import portbench.loops.train, portbench.loops.reg, portbench.readers, portbench.calibrate\n"
        "import tpureg_torch.reg.head, tpureg_torch.train, tpureg_torch.data.pipeline\n"
        "print(ns['forbidden_modules']())\n") % (str(ROOT), str(PB / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_whole():
    sys.path.insert(0, str(PB))
    try:
        import run as run_mod
    finally:
        sys.path.remove(str(PB))
    saved = dict(sys.modules)
    try:
        sys.modules["tpureg_torch_like"] = sys
        assert "tpureg" not in run_mod.forbidden_modules()
        sys.modules["tpureg.x"] = sys
        assert "tpureg" in run_mod.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]
