"""The serving export (tpureg_torch/serving/export.py, tpureg_torch/cli/export.py)
against the port's live head and tpureg's export on the CPU.

FlowNetS (tpureg's export default) at 64², batch 1, with and without
segmentations, holding tpureg's weights (numpy draws in the tree that
``jax.eval_shape`` gives, bridged by ``state_dict_from_jax``): the
exported graph names the ops ``tpureg::sample2d``, the artifact survives
``torch.export.save``/``load`` and equals the live head bit for bit, it
serves in a process that imports ``tpureg_torch.ops`` and no model code,
and its outputs hold against tpureg's ``export_registration`` artifact
(computed once a session through ``refcache``). The CLI runs with
``--random_weights --check``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_cli import one_torch_thread, work_path  # noqa: F401 (fixtures)
from test_torch_refcache import refcache  # noqa: F401 (a fixture)
from test_torch_zoo import assert_close, numpy_variables, pair_batch, port_head
from tpureg.reg import OpticalFlowReg as JaxOpticalFlowReg
from tpureg.serving import export_registration as jax_export_registration
from tpureg_torch.serving import export_registration, load_artifact, save_artifact

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BATCH = 64, 1
SEGS = {"segs": True, "no_segs": False}

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def variables():
    imgs, _ = pair_batch(0, BATCH, SIZE)
    return numpy_variables(JaxOpticalFlowReg(conv_predictor="flownets"), imgs, 31)


@pytest.fixture(scope="module")
def batch():
    imgs, segs = pair_batch(5, BATCH, SIZE)
    return torch.from_numpy(imgs), torch.from_numpy(segs)


@pytest.fixture(scope="module")
def tpureg_artifact_outputs(refcache, variables, batch):  # noqa: F811
    """tpureg's serving artifact of the same head, exported, serialised,
    deserialised and called on the batch, with and without segmentations."""
    imgs, segs = (t.numpy() for t in batch)

    def compute():
        from jax import export as jexport
        params, stats = variables
        v = {"params": jax.tree.map(jnp.asarray, params),
             "batch_stats": jax.tree.map(jnp.asarray, stats)}
        out = {}
        for key, with_segs in SEGS.items():
            exp = jax_export_registration(
                JaxOpticalFlowReg(conv_predictor="flownets"), v, BATCH, SIZE,
                with_segs=with_segs)
            call = jexport.deserialize(exp.serialize()).call
            out[key] = call(imgs, segs) if with_segs else call(imgs)
        return out

    return refcache("export_flownets_tpureg", compute)


@pytest.fixture(scope="module")
def head(variables):
    return port_head("flownets", variables).eval()


def _inputs(batch, with_segs):
    return batch if with_segs else batch[:1]


def assert_equal_outputs(got, want):
    """The same structure (None where there are no segmentations) and every
    tensor equal bit for bit, in the same dtype."""
    leaves, spec = torch.utils._pytree.tree_flatten(got)
    want_leaves, want_spec = torch.utils._pytree.tree_flatten(want)
    assert spec == want_spec
    for g, w in zip(leaves, want_leaves):
        assert (g is None and w is None) or (g.dtype == w.dtype and torch.equal(g, w))


@pytest.mark.parametrize("key", list(SEGS))
def test_exported_graph_names_the_ops(head, key):
    """Every warp of the eval forward is a ``tpureg::sample2d`` node: the
    two flows' images, the segmentation and the grid (three without
    segmentations); nothing else of the port's is left as a Python call."""
    ep = export_registration(head, BATCH, SIZE, with_segs=SEGS[key])
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    ours = [t for t in targets if getattr(t, "namespace", None) == "tpureg"]
    assert ours == [torch.ops.tpureg.sample2d.default] * (4 if SEGS[key] else 3)
    assert all(getattr(t, "namespace", "aten") in ("aten", "tpureg")
               or t.__module__ == "_operator" for t in targets)


@pytest.mark.parametrize("key", list(SEGS))
def test_spans_leave_the_exported_graph_as_it_is(head, key):
    """Exported while a profiler records (every span of the head a
    ``record_function``), the graph has the nodes of the graph exported
    while nothing records (every span a no-op)."""
    def nodes():
        ep = export_registration(head, BATCH, SIZE, with_segs=SEGS[key])
        return [(n.op, str(n.target)) for n in ep.graph.nodes]

    quiet = nodes()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = nodes()
    assert any(e.name == "tpureg.warp" for e in prof.events())
    assert traced == quiet


@pytest.mark.parametrize("key", list(SEGS))
def test_artifact_round_trip_equals_the_live_head(head, batch, key, work_path):  # noqa: F811
    with_segs = SEGS[key]
    path = str(work_path / "flownets.pt2")
    save_artifact(path, export_registration(head, BATCH, SIZE, with_segs=with_segs))
    served = load_artifact(path, "cpu")
    inputs = _inputs(batch, with_segs)
    with torch.no_grad():
        live = head(*inputs)
    got = served(*inputs)
    assert (got[2] is None) == (not with_segs)
    assert_equal_outputs(got, live)


@pytest.mark.parametrize("key", list(SEGS))
def test_artifact_matches_tpureg_artifact(head, batch, tpureg_artifact_outputs,
                                          key, work_path):  # noqa: F811
    """The port's artifact against tpureg's on the same weights and batch:
    flows, warped images and grid within the zoo's forward tolerance (5e-4
    abs, 1e-3 rel: XLA:CPU and torch sum the convolutions in different
    orders), the warped segmentation equal."""
    with_segs = SEGS[key]
    path = str(work_path / "flownets.pt2")
    save_artifact(path, export_registration(head, BATCH, SIZE, with_segs=with_segs))
    got = load_artifact(path)(*_inputs(batch, with_segs))
    want = tpureg_artifact_outputs[key]
    assert len(got[0]) == len(want[0]) == 2 and len(got[1]) == len(want[1]) == 2
    for name, g, w in (*((f"flow{i}", *p) for i, p in enumerate(zip(got[0], want[0]))),
                       *((f"warped{i}", *p) for i, p in enumerate(zip(got[1], want[1]))),
                       ("grid", got[3], want[3])):
        assert tuple(g.shape) == np.shape(w), name
        assert_close(g.numpy(), w, name)
    if with_segs:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    else:
        assert got[2] is None and want[2] is None


def test_artifact_serves_without_model_code(head, batch, work_path):  # noqa: F811
    """A fresh process that imports ``tpureg_torch.ops`` (which registers the
    ops) and torch, and nothing of the port's models, head or serving code,
    loads the file with ``torch.export.load`` and gives the live outputs."""
    path = work_path / "flownets.pt2"
    save_artifact(str(path), export_registration(head, BATCH, SIZE, with_segs=True))
    with torch.no_grad():
        live = head(*batch)
    np.savez(work_path / "io.npz", imgs=batch[0].numpy(), segs=batch[1].numpy(),
             **{f"out{i}": t.numpy() for i, t in
                enumerate(torch.utils._pytree.tree_leaves(live))})
    code = (
        "import sys, numpy as np, torch\n"
        "import tpureg_torch.ops\n"
        f"io = np.load({str(work_path / 'io.npz')!r})\n"
        f"f = torch.export.load({str(path)!r}).module()\n"
        "with torch.no_grad():\n"
        "    out = f(torch.from_numpy(io['imgs']), torch.from_numpy(io['segs']))\n"
        "leaves = torch.utils._pytree.tree_leaves(out)\n"
        "assert len(leaves) == len([k for k in io.files if k.startswith('out')])\n"
        "for i, t in enumerate(leaves):\n"
        "    assert np.array_equal(t.numpy(), io[f'out{i}']), i\n"
        "bad = sorted(m for m in sys.modules if m.startswith('tpureg_torch.')\n"
        "             and not m.startswith('tpureg_torch.ops'))\n"
        "assert not bad, bad\n"
        "assert not any(m.split('.')[0] in ('jax', 'tpureg') for m in sys.modules)\n"
        "print('served', len(leaves))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("served")


def test_bf16_artifact_matches_the_bf16_eval_step(head, batch):
    """``dtype=torch.bfloat16`` exports the bf16 eval step's forward: the
    weights cast on every call, BatchNorm in fp32."""
    from tpureg_torch.train import make_eval_step

    imgs = batch[0].to(torch.bfloat16)
    ep = export_registration(head, BATCH, SIZE, dtype=torch.bfloat16)
    got = ep.module()(imgs)
    want, _ = make_eval_step(head, compute_dtype=torch.bfloat16)(imgs)
    assert got[0][0].dtype == torch.bfloat16
    assert_equal_outputs(got, want)


def test_export_refuses_unknown_platforms(head):
    with pytest.raises(ValueError, match="unknown platforms"):
        export_registration(head, BATCH, SIZE, platforms=["tpu", "cpu"])


def test_export_cli_random_weights_check(work_path, capsys):  # noqa: F811
    """tpureg's flags; ``--check`` reloads the file and compares every
    output with the live head."""
    from tpureg_torch.cli.export import main

    out = work_path / "model.pt2"
    assert main(["--random_weights", "--check", "--with_segs", "--image_size",
                 str(SIZE), "--out", str(out), "--platforms", "cuda", "cpu"],
                device="cpu") == 0
    text = capsys.readouterr().out
    assert f"wrote {out}" in text and "platforms=['cuda', 'cpu']" in text
    assert "artifact check OK" in text and out.is_file()


def test_export_cli_loads_the_best_weights(head, batch, work_path, capsys):  # noqa: F811
    """Without ``--random_weights`` the CLI exports the weights of
    ``best_weight.pt`` under ``--workdir``."""
    from tpureg_torch.cli.export import main
    from tpureg_torch.train import save_best_weights

    save_best_weights(str(work_path), "FlowNetS", head, {"loss": 0.5})
    out = work_path / "best.pt2"
    main(["--workdir", str(work_path), "--image_size", str(SIZE), "--out", str(out)],
         device="cpu")
    assert "loaded best weights ({'loss': 0.5})" in capsys.readouterr().out
    got = load_artifact(str(out))(batch[0])
    with torch.no_grad():
        want = head(batch[0])
    assert_equal_outputs(got, want)
