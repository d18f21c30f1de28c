"""``convert_checkpoint.py`` (tpureg's orbax checkpoints to the port's
``.pt`` files) on the CPU.

tpureg takes one train step on FlowNetS (tpureg's export default) at 64², batch 2,
with the training CLI's optimizer (Adam over ``step_decay_schedule``),
writes both checkpoint tiers with its own ``save_best_weights`` and
``save_training_state``, and the converter turns them into the port's
files. The port's ``load_best_weights`` then gives an eval forward that
holds against tpureg's on the same weights (the zoo's forward tolerance),
and ``restore_training_state`` gives tpureg's weights, BatchNorm
statistics, Adam moments and counts exactly. RAFT's tree (no batch
statistics) goes through ``state_dict_from_jax_raft``. The checkpoints
(up to 0.5 GB) are deleted when each test ends (``work_path``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_cli import one_torch_thread, work_path  # noqa: F401 (fixtures)
from test_torch_zoo import assert_close, numpy_variables, pair_batch
from tpureg.reg import OpticalFlowReg as JaxOpticalFlowReg
from tpureg.train import make_eval_step as jax_make_eval_step
from tpureg.train import make_train_step as jax_make_train_step
from tpureg.train.checkpoint import save_best_weights as jax_save_best
from tpureg.train.checkpoint import save_training_state as jax_save_state
from tpureg.train.schedule import step_decay_schedule
from tpureg.train.state import RegTrainState
from tpureg_torch.compat import state_dict_from_jax, state_dict_from_jax_raft
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.train import (
    create_train_state,
    load_best_weights,
    make_eval_step,
    make_train_step,
    restore_training_state,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from convert_checkpoint import convert, main  # noqa: E402

SIZE = 64
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def jax_state(name, seed, size=SIZE):
    imgs, _ = pair_batch(0, 1, size)
    model = JaxOpticalFlowReg(conv_predictor=name)
    params, stats = numpy_variables(model, imgs, seed)
    return RegTrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats),
        tx=optax.adam(step_decay_schedule(1e-4, step_size=2, gamma=0.5), eps=1e-4))


def test_converted_flownets_serves_and_resumes_as_tpureg(work_path):  # noqa: F811
    tpu, gpu = str(work_path / "tpu"), str(work_path / "gpu")
    state = jax_state("flownets", 50)
    imgs, _ = pair_batch(1, 2, SIZE)
    state, metrics = jax_make_train_step(donate=False)(state, jnp.asarray(imgs))
    assert all(bool(jnp.isfinite(a).all()) for a in jax.tree.leaves(state.params))
    jax_save_best(tpu, "FlowNetS", state, {"loss": float(metrics["loss"])})
    jax_save_state(tpu, "FlowNetS", state, 4, 0.25)

    assert main(["--model", "flownets", "--workdir", tpu, "--out", gpu]) == 0
    assert sorted(os.listdir(gpu)) == ["Checkpoints", "model_weight"]

    # best weights -> the port's eval step, against tpureg's
    model = OpticalFlowReg("flownets")
    assert load_best_weights(gpu, "FlowNetS", model) == {
        "loss": pytest.approx(float(metrics["loss"]), rel=1e-6)}
    batch, segs = pair_batch(2, 1, SIZE)
    (want, _), got = (jax_make_eval_step()(state, jnp.asarray(batch), jnp.asarray(segs)),
                      make_eval_step(model)(torch.from_numpy(batch),
                                            torch.from_numpy(segs))[0])
    assert len(got[0]) == len(want[0]) == 2
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert bool(torch.isfinite(g).all())
        assert_close(g.numpy(), w, f"flow{i}")
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        assert_close(g.numpy(), w, f"warped{i}")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))

    # training state -> the port's resume: weights, statistics, Adam
    port = create_train_state(OpticalFlowReg("flownets"))
    port, epoch, best = restore_training_state(gpu, "FlowNetS", port)
    assert (epoch, best, port.step) == (5, 0.25, 1)
    get = lambda t: jax.tree.map(np.asarray, t)
    want_sd = state_dict_from_jax(get(state.params), get(state.batch_stats))
    for k, v in port.model.predictor.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    adam = state.opt_state[0]
    mu, nu = (state_dict_from_jax(get(t)) for t in (adam.mu, adam.nu))
    for name, p in port.model.named_parameters():
        s = port.optimizer.state[p]
        key = name.removeprefix("predictor.")
        assert float(s["step"]) == int(adam.count) == 1
        assert torch.equal(s["exp_avg"], mu[key]) and torch.equal(s["exp_avg_sq"], nu[key])
    m = make_train_step(port)(torch.from_numpy(imgs))
    assert port.step == 2 and bool(torch.isfinite(m["loss"]))


def test_converted_raft_reg_weights_and_moments(work_path):  # noqa: F811
    """RAFT's tree carries no batch statistics; its weights and its (fresh)
    Adam moments cross through the RAFT mapping."""
    tpu, gpu = str(work_path / "tpu"), str(work_path / "gpu")
    state = jax_state("raft-reg", 51, size=32)
    jax_save_best(tpu, "RAFT", state, {"loss": 1.5})
    jax_save_state(tpu, "RAFT", state, 0, 1.5)
    written = convert("raft-reg", tpu, gpu)
    assert [os.path.basename(p) for p in written] == ["best_weight.pt", "training_state.pt"]
    model = OpticalFlowReg("raft-reg")
    load_best_weights(gpu, "RAFT", model)
    want = state_dict_from_jax_raft(jax.tree.map(np.asarray, state.params))
    for k, v in model.predictor.state_dict().items():
        assert torch.equal(v, want[k]), k
    port = create_train_state(OpticalFlowReg("raft-reg"))
    port, epoch, _ = restore_training_state(gpu, "RAFT", port)
    assert epoch == 1 and port.step == 0
    assert all(not port.optimizer.state[p]["exp_avg"].any()
               for p in port.model.parameters())


def test_convert_refuses_a_workdir_without_checkpoints(work_path):  # noqa: F811
    with pytest.raises(FileNotFoundError, match="no tpureg checkpoint of FlowNetS"):
        convert("flownets", str(work_path), str(work_path / "out"))


def test_converter_is_a_script_of_the_jax_side():
    """The converter imports tpureg, which runs where JAX is; the port and
    chip_smoke.py never import the converter."""
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, tpureg_torch.compat, tpureg_torch.serving, tpureg_torch.cli.export\n"
         "assert 'convert_checkpoint' not in sys.modules\n"
         "assert not any(m.split('.')[0] in ('jax', 'tpureg') for m in sys.modules)\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stderr
    source = open(os.path.join(ROOT, "convert_checkpoint.py")).read()
    assert "from tpureg." in source
    for path in ("chip_smoke.py",):
        assert "convert_checkpoint" not in open(os.path.join(ROOT, path)).read()
