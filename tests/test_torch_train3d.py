"""The 3-D volumetric training path of tpureg_torch against tpureg's on the
CPU: one train step of each stage (VoxelMorph3D + DEFloss3D, AffineNet3D +
Affloss) from weights bridged from one flax initialisation, the volume data
synthesis with injected draws, the volume dataset, and the CLI.

The yardstick for the port's fp32 step is tpureg's step run in fp64
(``jax.enable_x64``; tpureg's 3-D warp still samples in fp32 there). The
deformable loss's smoothness term is a Charbonnier of neighbouring flow
differences, whose gradient |x|^-1/2 is singular where a smooth flow's
differences vanish, so its fp32 gradient is noisy: measured here, tpureg's
own fp32 gradient lies 6.0e-3 (whole model) and 1.1e-2 (median tensor) in
relative L2 from its fp64 gradient, the port's 7.7e-3 and 1.1e-2. As in the
FlowNet2 step's tests, the port's fp32 gradient may lie at most twice as far
from the fp64 one as tpureg's fp32 gradient does. The photometric Charbonnier is
singular where the two volumes agree, so the fixed volumes here sit 1.5
above the moving ones.

tpureg's step is run as it is, with a gradient transformation that keeps the
gradient in the optimizer state in place of Adam's update, so that the
gradient is read exactly; the port's Adam update is held against optax's
Adam on the port's gradient. tpureg's steps compile once per module.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.training import train_state as ts

import tpureg.data.pipeline as jax_pipeline
from tpureg.data import split_volumes as jax_split_volumes
from tpureg.models import AffineNet3D as JaxAffineNet3D
from tpureg.models import VoxelMorph3D as JaxVoxelMorph3D
from tpureg.train.steps import make_affine_train_step as jax_affine_step
from tpureg.train.steps import make_deform3d_train_step as jax_deform_step
from test_torch_cli import tb_records, one_torch_thread  # noqa: F401 (fixtures)
from test_torch_elastic import write_analyze
from test_torch_models3d import blob_pair
from tpureg_torch.compat import state_dict_from_jax_3d
from tpureg_torch.data import VolumePairDataset, volume_dataset
from tpureg_torch.data.pipeline import _process_volume
from tpureg_torch.models import AffineNet3D, VoxelMorph3D
from tpureg_torch.train import (
    create_train_state,
    make_affine_train_step,
    make_deform3d_train_step,
)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


ROOT = Path(__file__).resolve().parents[1]
SIZE, BATCH, LR = (16, 32, 32), 2, 1e-4


def volume_pairs(seed):
    """[B, D, H, W, 2]: Gaussian blobs, fixed 1.5 + 0.5·blob in channel 0,
    moving 0.5·blob in channel 1."""
    vols = blob_pair(seed, BATCH, SIZE)
    vols[..., 0] = 1.5 + 0.5 * vols[..., 0]
    vols[..., 1] *= 0.5
    return vols


def keep_gradient():
    """An optax transformation whose state is the last gradient and whose
    update is zero."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def tpureg_step(model, make_step, params, vols, dtype):
    """(metrics, gradient) of tpureg's train step in ``dtype`` (fp64 under
    ``jax.enable_x64``) from ``params``."""
    with jax.enable_x64(dtype == np.float64):
        p = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dtype)), params)
        state = ts.TrainState.create(apply_fn=model.apply, params=p,
                                     tx=keep_gradient())
        state, metrics = make_step(donate=False)(state, jnp.asarray(vols.astype(dtype)))
        return ({k: float(v) for k, v in metrics.items()},
                jax.tree.map(np.asarray, state.opt_state))


def deform_params(vols):
    params = jax.tree.map(np.asarray, jax.jit(JaxVoxelMorph3D().init)(
        jax.random.key(0), jnp.asarray(vols))["params"])
    # flows of about a voxel: off the voxel grid, where floor is stable
    params["flow_head"]["kernel"] = params["flow_head"]["kernel"] * 3e4
    return params


def affine_params(vols):
    params = jax.tree.map(np.asarray, jax.jit(JaxAffineNet3D().init)(
        jax.random.key(0), jnp.asarray(vols))["params"])
    rng = np.random.default_rng(1)
    # θ off the identity, a dense kernel that passes a gradient to the convs
    params["fc"]["bias"] = params["fc"]["bias"] + (
        rng.standard_normal(12) * 0.05).astype(np.float32)
    params["fc"]["kernel"] = (rng.standard_normal(params["fc"]["kernel"].shape)
                              * 1e-3).astype(np.float32)
    return params


STAGES = {
    "deform": (JaxVoxelMorph3D, jax_deform_step, deform_params,
               lambda: VoxelMorph3D(), make_deform3d_train_step),
    "affine": (JaxAffineNet3D, jax_affine_step, affine_params,
               lambda: AffineNet3D(SIZE), make_affine_train_step),
}


@pytest.fixture(scope="module", params=sorted(STAGES))
def stage(request):
    """One step of the stage on both sides from the same weights: tpureg's
    fp64 metrics and gradient and its fp32 gradient, the port's fp32
    metrics, gradient and update."""
    jmodel, jstep, make_params, pmodel, pstep = STAGES[request.param]
    vols = volume_pairs(2)
    params = make_params(vols)
    want_metrics, want_grads = tpureg_step(jmodel(), jstep, params, vols, np.float64)
    _, fp32_grads = tpureg_step(jmodel(), jstep, params, vols, np.float32)
    model = pmodel()
    model.load_state_dict(state_dict_from_jax_3d(params), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, learning_rate=LR, adam_eps=1e-8)
    metrics = pstep(state)(torch.from_numpy(vols))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return {"name": request.param, "params": params, "want_metrics": want_metrics,
            "want_grads": state_dict_from_jax_3d(want_grads),
            "tpureg_fp32_grads": state_dict_from_jax_3d(fp32_grads),
            "metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "before": before, "after": model.state_dict(), "state": state}


def test_step_metrics_match_tpureg(stage):
    keys = ("loss", "photo_loss", "corr_loss") + (
        ("smooth_loss",) if stage["name"] == "deform" else ())
    assert set(stage["metrics"]) == set(keys) == set(stage["want_metrics"])
    for k in keys:
        got, want = stage["metrics"][k], stage["want_metrics"][k]
        # fp32 sums over the volume against fp64 ones (measured ≤ 1e-7)
        assert abs(got / want - 1) <= 1e-5, (k, got, want)
    assert stage["state"].step == 1


def test_step_gradients_match_tpureg_fp64(stage):
    want = stage["want_grads"]
    assert set(stage["grads"]) == set(want)

    def spread(grads):
        """(whole-model relative L2, per-tensor median) from fp64."""
        errs, diff2, ref2 = [], 0.0, 0.0
        for k in want:
            d = grads[k].double() - want[k].double()
            errs.append(float(d.norm() / want[k].double().norm()))
            diff2 += float((d * d).sum())
            ref2 += float((want[k].double() ** 2).sum())
        return (diff2 / ref2) ** 0.5, sorted(errs)[len(errs) // 2]

    port, tpureg32 = spread(stage["grads"]), spread(stage["tpureg_fp32_grads"])
    # at most twice tpureg's own fp32 distance from fp64 (measured, whole
    # model: deform 7.7e-3 against 6.0e-3, affine 2.8e-7 against 2.6e-7);
    # 1e-5 where fp32 rounding alone sets it
    for got, bound in zip(port, tpureg32):
        assert got <= max(2 * bound, 1e-5), (port, tpureg32)


def test_step_update_is_optax_adam(stage):
    """The port's Adam (eps 1e-8, optax's default) takes optax.adam's first
    step from the port's own gradient."""
    names = list(stage["grads"])
    grads = {k: stage["grads"][k].numpy() for k in names}
    params = {k: stage["before"][k].numpy() for k in names}
    opt = optax.adam(LR)

    @jax.jit
    def first_step(g, p):
        return optax.apply_updates(p, opt.update(g, opt.init(p), p)[0])

    stepped = first_step(grads, params)
    for k in names:
        want = np.asarray(stepped[k])
        # the update, ±lr·g/(|g| + eps), rounded once more on either side
        np.testing.assert_allclose(stage["after"][k].numpy(), want, atol=1e-8,
                                   rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the volume data

def jax_rigid_draws(key, b):
    """The draws of tpureg's ``_process_volume`` from ``key``, in voxels."""
    k_rot, k_tx, k_ty = jax.random.split(key, 3)
    ang = jax.random.uniform(k_rot, (b,), minval=-jnp.pi / 4, maxval=jnp.pi / 4)
    tx = jax.random.uniform(k_tx, (b,), minval=-5.0, maxval=5.0)
    ty = jax.random.uniform(k_ty, (b,), minval=-5.0, maxval=5.0)
    return [torch.from_numpy(np.array(v)) for v in (ang, tx, ty)]


def test_process_volume_matches_tpureg_with_injected_draws():
    rng = np.random.default_rng(3)
    raw = (rng.random((2, 13, 11, 9)) * 500).astype(np.float32)
    size = (11, 16, 16)
    key = jax.random.key(5)
    want = np.asarray(jax_pipeline._process_volume(key, jnp.asarray(raw), size)["image_c"])
    got = _process_volume(torch.from_numpy(raw), size,
                          draws=jax_rigid_draws(key, 2))["image_c"].numpy()
    assert got.shape == want.shape == (2, *size, 2)
    # the fixed volume: a trilinear resize in one pass against three
    # separable products, then the min-max scaling
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=2e-6)
    # the moving one: cos and sin of the angle and θ·(x, y, z, 1) summed in
    # another order move positions by fp32 roundings
    np.testing.assert_allclose(got[..., 1], want[..., 1], atol=2e-5)
    # each volume is scaled on its own, as tpureg's [B, D, H, W, 2]
    # reduction over axes (1, 2, 3) does
    for c in range(2):
        assert np.allclose(got[..., c].min(axis=(1, 2, 3)), 0)
        assert np.allclose(got[..., c].max(axis=(1, 2, 3)), 1)


def test_volume_dataset_split_and_batches(tmp_path):
    rng = np.random.default_rng(4)
    for i in range(10):
        write_analyze(str(tmp_path / f"vol{i:02d}"),
                      rng.integers(0, 300, (9, 13, 11)).astype(np.float32))
    size = (11, 16, 16)
    train, val, test, n_train, n_val = volume_dataset(str(tmp_path), 2, "cpu",
                                                      size=size)
    items = [{"image": p} for p in sorted(map(str, tmp_path.glob("*.img")))]
    want = jax_split_volumes(items, 0.1, 0.1, 6, 20)
    assert [train.items, val.items, test.items] == list(want)
    assert (n_train, n_val) == (8, 1)
    batches = list(train)
    assert len(batches) == 4 and len(list(val)) == 0
    again = list(train)
    for b, a in zip(batches, again):
        assert b["image_c"].shape == (2, *size, 2)
        torch.testing.assert_close(b["image_c"], a["image_c"], atol=0, rtol=0)
    # the fixed channel is tpureg's (the moving one depends on the draws)
    jax_ds = jax_pipeline.VolumePairDataset(train.items[:2], 2, jax.random.key(0),
                                            size)
    (jb,) = list(jax_ds)
    np.testing.assert_allclose(batches[0]["image_c"][..., 0].numpy(),
                               np.asarray(jb["image_c"])[..., 0], atol=2e-6)
    assert isinstance(train, VolumePairDataset)


# ---------------------------------------------------------------------------
# the CLI

@pytest.mark.parametrize("stage_name", ["affine", "deform"])
def test_train_affine_cli_on_cpu(stage_name, capsys, tb_records, tmp_path):  # noqa: F811
    from tpureg_torch.cli.train_affine import main

    state = main(["--stage", stage_name, "--synthetic", "1", "--epochs", "2",
                  "--volume_size", "16,16,16", "--batch_size", "1",
                  "--logdir", str(tmp_path / "log")], device="cpu")
    out = capsys.readouterr().out
    tag = "DEFORM" if stage_name == "deform" else "AFFINE"
    lines = [line for line in out.splitlines() if line.startswith(f"[{tag} epoch")]
    assert [line.split("]")[0] for line in lines] == [f"[{tag} epoch 1/2",
                                                      f"[{tag} epoch 2/2"]
    assert all("loss" in line and "photo" in line and "corr" in line for line in lines)
    assert state.step == 2
    assert state.optimizer.param_groups[0]["eps"] == 1e-8
    assert isinstance(state.model, VoxelMorph3D if stage_name == "deform" else AffineNet3D)
    # each epoch's averages as <stage>_<metric> (tpureg/cli/train_affine.py:126)
    terms = ("loss", "photo_loss", "corr_loss") + (
        ("smooth_loss",) if stage_name == "deform" else ())
    (w,) = tb_records
    assert w.closed and w.tags() == [("scalar", f"{tag.lower()}_{k}") for k in terms]
    assert sorted({step for *_, step, _ in w.calls}) == [1, 2]


def test_train_affine_cli_refusals(monkeypatch):
    """``--spatial_shards 2`` without a process group to join;
    ``--spatial_shards 3`` over a world of two gloo ranks (tpureg's
    ``make_mesh`` asserts the same); no CUDA device without ``device``."""
    from test_torch_parallel import spawn
    from tpureg_torch.cli.train_affine import main

    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="no process group to join"):
        main(["--spatial_shards", "2", "--synthetic", "1"], device="cpu")
    ranks = spawn("spatial_cli", {"runs": {}, "dtype": torch.float32})
    assert [r["refusal"] for r in ranks] == [
        "--spatial_shards 3 does not divide a world of 2 ranks"] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--synthetic", "1"])


def test_train_affine_cli_runs_with_jax_blocked(tmp_path):
    """The port trains with JAX and tpureg unimportable, and without a
    TensorBoard package, as on the card's machine (its writer warns once
    and writes nothing)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'tpureg',\n"
        "          'torch.utils.tensorboard', 'tensorboardX'):\n"
        "    sys.modules[m] = None\n"
        "from tpureg_torch.cli.train_affine import main\n"
        "s = main(['--stage', 'affine', '--synthetic', '1', '--epochs', '1',\n"
        "          '--volume_size', '16,16,16', '--batch_size', '1',\n"
        f"          '--logdir', {str(tmp_path / 'log')!r}], device='cpu')\n"
        "assert s.step == 1\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
    assert res.stderr.count("WARNING: no TensorBoard backend available") == 1
    assert not (tmp_path / "log").exists()
