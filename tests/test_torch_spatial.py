"""The spatially sharded 3-D steps of tpureg_torch (``--spatial_shards``,
``tpureg_torch/parallel/spatial.py``) against one process and against
tpureg's sharded step, on the CPU, with two gloo processes.

tpureg's 3-D step over a batch placed with ``spatial_sharding(mesh, 5,
axis=2)`` is one GSPMD program over the global batch and the whole volume
(tpureg/parallel/mesh.py:1-16), so the port's step over a ('data',
'spatial') grid, each rank holding its rows and its slab of their H, must
give the single-process step's results. Held here:

- (a) the grid: the port's rank → (data index, spatial index) map and its
  spatial groups are ``make_mesh(n_data, S)``'s device array, for S = 1, 2,
  4 over 2, 4 and 8 of conftest's host devices; both refuse a world that S
  does not divide;
- (b) the pieces over two ranks, in fp64: the gather (equal to the bit),
  the halo exchange, and the slab convolution of every (kernel, stride,
  padding) along H of both models, its output and its input and weight
  gradients against one process on the whole tensor, within 1e-12 of their
  largest values; a convolution whose rows stop splitting evenly (run
  whole on every rank) too;
- the bytes each rank reduces through ``all_sum`` in a step at the full
  width, counted on meta tensors (PERF.md's prediction for phase 8n);
- (c) the deform step (VoxelMorph3D, 16 x 32 x 32, the least H that splits
  through four stride-2 levels over two ranks; 16 x 16 x 32, where enc3
  and the decoder run whole) and (d) the affine step (AffineNet3D at 16 x
  128 x 64, where every layer's rows split over two ranks, and at 16 x 64
  x 64, where conv6's input has 2 rows in all and runs whole), batch 2, in
  fp64, as data 1 x spatial 2 and as data 2 x spatial 1, and over four
  ranks as data 2 x spatial 2 and data 1 x spatial 4, against the
  single-process port step on the same batch from the same weights: the
  flow and warped volume gathered over the ranks, the metrics, the
  gradients summed over the ranks and the updated weights, within 1e-10 of
  their largest values (the affine gradient within 1e-6: its warp's
  positions are fp32 in every dtype, ``GRAD_TOL``);
- (e) the two-rank steps against tpureg's own step jitted over
  ``make_mesh(1, 2)`` with the batch placed by ``spatial_sharding``, on the
  same weights (``state_dict_from_jax_3d``) and volumes, both stages, by the
  rule of ``tests/test_torch_train3d.py``'s parity tests;
- (f) the CLI's ``--spatial_shards 2`` over two ranks that join through
  ``init_from_env`` from torchrun's environment, both stages, against a
  single-process run (in fp64, torch's default dtype set so in the ranks
  and here): the printed metrics equal, rank 0 alone printing and making a
  TensorBoard writer.

The ranks run in ``tests/torch_parallel_worker.py`` (cases
``spatial_pieces``, ``spatial_steps``, ``spatial_cli``) through
``test_torch_parallel.spawned``; their results, one process's and
tpureg's are computed once a session (``refcache``).
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax
from flax.training import train_state as ts
from jax.sharding import NamedSharding, PartitionSpec

from test_torch_cli import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_models3d import blob_pair
from test_torch_parallel import assert_close, spawn, spawned, to_numpy
from test_torch_refcache import refcache  # noqa: F401 (a fixture)
from test_torch_train3d import affine_params, deform_params, keep_gradient
from tpureg.models import AffineNet3D as JaxAffineNet3D
from tpureg.models import VoxelMorph3D as JaxVoxelMorph3D
from tpureg.parallel import make_mesh, spatial_sharding
from tpureg.train.steps import make_affine_train_step as jax_affine_step
from tpureg.train.steps import make_deform3d_train_step as jax_deform_step
from tpureg_torch.compat import state_dict_from_jax_3d
from tpureg_torch.models import AffineNet3D, VoxelMorph3D
from tpureg_torch.parallel import grid_position, local_rows, spatial_ranks
from tpureg_torch.train import (create_train_state, make_affine_train_step,
                                make_deform3d_train_step)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BATCH, LR = 2, 1e-4
DEFORM_SIZE, DEFORM_WHOLE_SIZE = (16, 32, 32), (16, 16, 32)
AFFINE_SIZE, AFFINE_WHOLE_SIZE = (16, 128, 64), (16, 64, 64)


# ---------------------------------------------------------------------------
# (a) the grid


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("spatial", [1, 2, 4])
def test_grid_matches_make_mesh(n, spatial):
    """Rank r sits where ``make_mesh`` puts device r: (r // S, r % S); each
    data index's spatial group is a row of its device array. A world that S
    does not divide is refused by both."""
    devices = jax.devices()[:n]
    if n % spatial:
        with pytest.raises(AssertionError):
            make_mesh(n // spatial, spatial, devices=devices)
        with pytest.raises(ValueError, match="does not divide"):
            grid_position(0, n, spatial)
        with pytest.raises(ValueError, match="does not divide"):
            spatial_ranks(n, spatial)
        return
    mesh = make_mesh(n // spatial, spatial, devices=devices)
    assert mesh.axis_names == ("data", "spatial")
    for r in range(n):
        (where,) = np.argwhere(mesh.devices == devices[r])
        assert tuple(int(i) for i in where) == grid_position(r, n, spatial)
    assert spatial_ranks(n, spatial) == [[devices.index(d) for d in row]
                                         for row in mesh.devices]


# ---------------------------------------------------------------------------
# (b) the pieces

# (k, stride along H, padding) of every convolution of both models:
# VoxelMorph3D's stride-2 and stride-1 3³ convolutions, AffineNet3D's conv1,
# conv2 and conv3-6; and a stride-2 3³ convolution on an input of 2 rows
# (1 a rank), which runs whole
CONV_CASES = [(3, 2, 1, 8), (3, 1, 1, 8), (7, 2, 3, 8), (5, 2, 2, 8), (3, 2, 1, 2)]
# (above, below) halo rows: the convolutions' and the smoothness term's
HALOS = [(1, 0), (1, 1), (3, 2), (2, 1), (0, 1)]


def _piece_inputs():
    rng = np.random.default_rng(21)
    t = lambda *shape: torch.from_numpy(rng.uniform(-1, 1, shape))
    convs = []
    for k, s, p, h in CONV_CASES:
        x = t(2, 3, 4, h, 5)
        conv = torch.nn.Conv3d(3, 4, k, s, p).double()
        with torch.no_grad():
            y = conv(x)
        convs.append({"k": k, "stride": s, "p": p, "x": x, "weight": t(*conv.weight.shape),
                      "bias": t(4), "cot": t(*y.shape)})
    return {"convs": convs, "halos": HALOS, "x": t(2, 3, 4, 8, 5), "cot": t(2, 3, 4, 12, 5)}


@pytest.fixture(scope="module")
def piece_runs(refcache):  # noqa: F811
    """(inputs, the two ranks' results, one process's results), once a
    session."""
    def compute():
        inputs = _piece_inputs()
        ranks = spawn("spatial_pieces", inputs)
        one = {"convs": [], "halos": []}
        for case in inputs["convs"]:
            conv = torch.nn.Conv3d(3, 4, case["k"], case["stride"], case["p"]).double()
            conv.load_state_dict({"weight": case["weight"], "bias": case["bias"]})
            x = case["x"].clone().requires_grad_(True)
            y = conv(x)
            (y * case["cot"]).sum().backward()
            one["convs"].append({"y": y.detach(), "dx": x.grad,
                                 "dweight": conv.weight.grad, "dbias": conv.bias.grad})
        for above, below in inputs["halos"]:
            x = inputs["x"].clone().requires_grad_(True)
            padded = F.pad(x, (0, 0, above, below))
            cot = F.pad(inputs["cot"], (0, 0, above, below))
            loss = 0.0
            for r in range(2):  # each rank's window of the padded tensor
                n = 4 + above + below  # the slab and its halos
                loss = loss + (padded.narrow(3, 4 * r, n) * cot.narrow(3, 4 * r, n)).sum()
            loss.backward()
            one["halos"].append({"windows": [padded.detach().narrow(3, 4 * r, 4 + above + below)
                                             for r in range(2)], "dx": x.grad})
        return to_numpy(inputs), to_numpy(ranks), to_numpy(one)

    return refcache("spatial_pieces", compute)


@pytest.mark.parametrize("i", range(len(CONV_CASES)),
                         ids=[f"k{k}-s{s}-p{p}-h{h}" for k, s, p, h in CONV_CASES])
def test_slab_conv_over_two_ranks_matches_one_process(piece_runs, i):
    """The slab convolution's output, gathered, and each rank's input
    gradient rows equal one process's on the whole tensor, and the ranks'
    weight gradients sum to its, within 1e-12 of their largest values; the
    gather of the input equals it to the bit. The stride-2 case on 2 rows
    runs whole on both ranks."""
    inputs, ranks, one = piece_runs
    want = one["convs"][i]
    slab = CONV_CASES[i][3] // 2 % CONV_CASES[i][1] == 0
    for r, res in enumerate(ranks):
        got = res["convs"][i]
        assert got["slab"] == slab
        np.testing.assert_array_equal(got["gathered"], inputs["convs"][i]["x"])
        assert_close(got["y"], want["y"], 1e-12, "output")
        h = want["dx"].shape[3] // 2
        assert_close(got["dx"], want["dx"][:, :, :, r * h:(r + 1) * h], 1e-12,
                     "input gradient")
    for k in ("dweight", "dbias"):
        assert_close(ranks[0]["convs"][i][k] + ranks[1]["convs"][i][k], want[k], 1e-12, k)


@pytest.mark.parametrize("i", range(len(HALOS)), ids=[f"{a}-{b}" for a, b in HALOS])
def test_halo_exchange_over_two_ranks_matches_one_process(piece_runs, i):
    """Each rank's haloed slab is its window of the tensor zero-padded along
    H (its neighbour's rows, zeros beyond the volume's edges), to the bit;
    the halos' cotangents reach their owners' rows."""
    _, ranks, one = piece_runs
    want = one["halos"][i]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["halos"][i]["y"], want["windows"][r])
        assert_close(res["halos"][i]["dx"], want["dx"][:, :, :, 4 * r:4 * (r + 1)],
                     1e-12, "input gradient")


# bytes each rank reduces through all_sum in one step at 176 x 256 x 256,
# batch 2, fp32, by stage and S (chip_smoke.py phase 8n prints the card's)
FULL_WIDTH_BYTES = {("deform", 2): 756580352, ("affine", 2): 155713728,
                    ("deform", 4): 867237888, ("affine", 4): 219152576}


@pytest.mark.parametrize("stage,spatial", sorted(FULL_WIDTH_BYTES))
def test_all_sum_bytes_at_full_width(monkeypatch, stage, spatial):
    """What each rank of a data index reduces through ``all_sum`` in a
    step's forward and backward at the full width, counted by
    ``all_sum.bytes`` on meta tensors (no collective runs): the gathers of
    the moving volume and of the half-resolution fields, the halos and the
    affine θ; the loss's scalars reduce over the world, not counted here."""
    import tpureg_torch.parallel.mesh as mesh
    from tpureg_torch.losses import Affloss, DEFloss3D
    from tpureg_torch.parallel import HSplit, all_sum

    monkeypatch.setattr(mesh.dist, "all_reduce", lambda t, group=None: None)
    d, h, w = 176, 256, 256
    for index in range(spatial):
        split = HSplit(None, index, spatial)
        with torch.device("meta"):
            model = VoxelMorph3D() if stage == "deform" else AffineNet3D((d, h, w))
            x = torch.empty((2, 2, d, h // spatial, w))
        model.split = split
        monkeypatch.setattr(all_sum, "bytes", 0)
        outputs = model(x)
        if stage == "deform":
            total = DEFloss3D(outputs[0], outputs[1], x[:, :1], split=split)[3]
        else:
            total = Affloss(outputs[1], x[:, :1])[2]
        total.backward()
        assert all_sum.bytes == FULL_WIDTH_BYTES[(stage, spatial)], (index, all_sum.bytes)


# ---------------------------------------------------------------------------
# (c), (d) the 3-D steps


def volume_pairs(seed, size):
    """[B, D, H, W, 2] blobs, fixed 1.5 + 0.5·blob, moving 0.5·blob
    (test_torch_train3d.py's construction at ``size``)."""
    vols = blob_pair(seed, BATCH, size)
    vols[..., 0] = 1.5 + 0.5 * vols[..., 0]
    vols[..., 1] *= 0.5
    return vols


STAGES = {"deform": (JaxVoxelMorph3D, jax_deform_step, deform_params,
                     lambda size: VoxelMorph3D(), make_deform3d_train_step),
          "affine": (JaxAffineNet3D, jax_affine_step, affine_params,
                     lambda size: AffineNet3D(size), make_affine_train_step)}
# (stage, volume, spatial shards, dtype, ranks); the fp32 cases are (e)'s
STEP_CONFIGS = {
    "deform-spatial2": ("deform", DEFORM_SIZE, 2, torch.float64, 2),
    "deform-data2": ("deform", DEFORM_SIZE, 1, torch.float64, 2),
    # H = 16: enc3's input has 2 rows (1 a rank, stride 2), so enc3 and the
    # decoder run whole, the skips gathered, and each rank takes its slabs
    # of the outputs
    "deform-enc3-whole-spatial2": ("deform", DEFORM_WHOLE_SIZE, 2, torch.float64, 2),
    "affine-spatial2": ("affine", AFFINE_SIZE, 2, torch.float64, 2),
    "affine-data2": ("affine", AFFINE_SIZE, 1, torch.float64, 2),
    "affine-conv6-whole-spatial2": ("affine", AFFINE_WHOLE_SIZE, 2, torch.float64, 2),
    # four ranks: data 2 x spatial 2, and spatial 4 (H = 64: every level of
    # VoxelMorph3D splits; AffineNet3D's conv6 runs whole)
    "deform-data2-spatial2": ("deform", DEFORM_SIZE, 2, torch.float64, 4),
    "deform-spatial4": ("deform", (16, 64, 32), 4, torch.float64, 4),
    "affine-data2-spatial2": ("affine", AFFINE_SIZE, 2, torch.float64, 4),
    "affine-spatial4": ("affine", AFFINE_SIZE, 4, torch.float64, 4),
    "deform-spatial2-fp32": ("deform", DEFORM_SIZE, 2, torch.float32, 2),
    "affine-spatial2-fp32": ("affine", AFFINE_SIZE, 2, torch.float32, 2),
}
FP64_CONFIGS = [n for n, c in STEP_CONFIGS.items() if c[3] == torch.float64]
# the summed gradients' tolerance: the affine warp computes its positions in
# fp32 in every dtype (affine_warp3d's theta.float(), a single-process
# result that stays as it is), so the gradient of θ, a sum over the
# positions, is summed in fp32 and in another order over two slabs
# (measured 6.1e-8 and 9.0e-8 relative L2)
GRAD_TOL = {"deform": 1e-10, "affine": 1e-6}


def stage_inputs(stage, size):
    """(volumes, tpureg's parameters, the port's state dict) of ``stage``
    at ``size``: test_torch_train3d.py's weights (tpureg's initialisation,
    moved off its degenerate points)."""
    vols = volume_pairs(2, size)
    params = STAGES[stage][2](vols)
    return vols, params, state_dict_from_jax_3d(params)


def _port_model(stage, size, sd, dtype):
    model = STAGES[stage][3](size).to(dtype)
    model.load_state_dict(sd)
    return model


def one_process_step(stage, size, vols, sd, dtype=torch.float64):
    """The single-process port step: flow (deform) and warped volume before
    it, metrics, gradients, weights after."""
    model = _port_model(stage, size, sd, dtype)
    x = torch.from_numpy(vols).to(dtype)
    with torch.no_grad():
        outputs = model(x.permute(0, 4, 1, 2, 3).contiguous())
    state = create_train_state(model, learning_rate=LR, adam_eps=1e-8)
    metrics = STAGES[stage][4](state)(x)
    return {"flow": outputs[0] if stage == "deform" else None, "warped": outputs[1],
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "after": {k: v.clone() for k, v in model.state_dict().items()}}


def adam_after(stage, size, sd, grads, dtype):
    """The weights after one process's Adam step from ``sd`` given
    ``grads``."""
    model = _port_model(stage, size, sd, dtype)
    state = create_train_state(model, learning_rate=LR, adam_eps=1e-8)
    for n, p in model.named_parameters():
        p.grad = grads[n].clone()
    state.apply_gradients()
    return model.state_dict()


def relative_l2(got, want):
    """Relative L2 distance of dict ``got`` from ``want`` over all tensors."""
    diff2 = sum(float(((np.asarray(got[k], np.float64) - np.asarray(w, np.float64)) ** 2
                       ).sum()) for k, w in want.items())
    ref2 = sum(float((np.asarray(w, np.float64) ** 2).sum()) for w in want.values())
    return (diff2 / ref2) ** 0.5


def _largest_error(got, want):
    """The largest difference of tensors ``got`` from ``want``, each relative
    to that tensor's largest value, over a dict (or one tensor)."""
    if isinstance(want, dict):
        return max(_largest_error(got[k], want[k]) for k in want)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _summary(stage, size, spatial, dtype, res, one, sd):
    """What (c)-(d) read of one configuration: the ranks' results ``res``
    against one process's ``one``."""
    rows = [local_rows(BATCH, len(res) // spatial, r["data_index"]) for r in res]
    grads = res[0]["grads"]
    after = adam_after(stage, size, sd, grads, dtype)
    return {
        "warped": max(_largest_error(r["warped"], one["warped"][i])
                      for r, i in zip(res, rows)),
        "flow": None if stage != "deform" else max(
            _largest_error(r["flow"], one["flow"][i]) for r, i in zip(res, rows)),
        "metrics": max(abs(r["metrics"][k] / one["metrics"][k] - 1)
                       for r in res for k in one["metrics"]),
        "metrics_equal": all(r["metrics"] == res[0]["metrics"] for r in res),
        "grads": (_largest_error(grads, one["grads"]) if stage == "deform"
                  else relative_l2(grads, one["grads"])),
        "grads_equal": all(torch.equal(grads[k], r["grads"][k]) for r in res
                           for k in grads),
        "after": _largest_error(res[0]["after"], one["after"]),
        "after_is_adam": all(torch.equal(r["after"][k], after[k]) for r in res
                             for k in after),
        "steps": [r["step"] for r in res]}


@pytest.fixture(scope="module")
def step_runs(refcache):  # noqa: F811
    """Per fp64 configuration, ``_summary`` of the ranks against one
    process; per stage, the two ranks' fp32 metrics and gradients, which
    (e) holds against tpureg. Once a session; one process's steps run while
    the two ranks do, then the four ranks run."""
    def compute():
        inputs, sds = {2: {"configs": {}}, 4: {"configs": {}}}, {}
        for name, (stage, size, spatial, dtype, world) in STEP_CONFIGS.items():
            vols, _, sds[name] = stage_inputs(stage, size)
            inputs[world]["configs"][name] = {
                "stage": stage, "spatial": spatial, "dtype": dtype,
                "vols": torch.from_numpy(vols).to(dtype), "state_dict": sds[name]}
        ones = {}
        with spawned("spatial_steps", inputs[2]) as collect:
            for name in FP64_CONFIGS:
                stage, size = STEP_CONFIGS[name][:2]
                if (stage, size) not in ones:
                    vols = volume_pairs(2, size)
                    ones[(stage, size)] = one_process_step(stage, size, vols, sds[name])
            ranks = {2: collect()}
        ranks[4] = spawn("spatial_steps", inputs[4], world=4)
        out = {}
        for name, (stage, size, spatial, dtype, world) in STEP_CONFIGS.items():
            res = [r[name] for r in ranks[world]]
            if dtype == torch.float64:
                out[name] = _summary(stage, size, spatial, dtype, res,
                                     ones[(stage, size)], sds[name])
            else:
                out[name] = {"metrics": res[0]["metrics"], "grads": res[0]["grads"]}
        return to_numpy(out)

    return refcache("spatial_step_runs", compute)


@pytest.mark.parametrize("name", FP64_CONFIGS)
def test_spatial_step_matches_one_process(step_runs, name):
    """Two ranks, as data 1 x spatial 2 (each rank both rows, half of H) and
    data 2 x spatial 1 (a row each, the whole H), and four, as data 2 x
    spatial 2 and data 1 x spatial 4, against one process on the batch, in
    fp64: the flow and warped volume gathered over H, each rank's rows, the
    metrics, equal on every rank, and (deform) the weights after one Adam
    update, within 1e-10 of their largest values; the gradients summed over
    the ranks, equal on every rank, within ``GRAD_TOL`` (the affine warp's
    fp32 positions, relative L2); the weights after, on every rank, one
    Adam step on the summed gradients to the bit (an affine gradient within
    fp32 rounding of zero moves Adam's sign-like first step: measured 3.9e-6
    and 1.1e-5 relative L2 of the update)."""
    run = step_runs[name]
    stage, world = STEP_CONFIGS[name][0], STEP_CONFIGS[name][4]
    assert run["steps"] == [1] * world
    assert run["metrics_equal"] and run["grads_equal"] and run["after_is_adam"]
    for k in ("warped", "flow", "metrics"):
        if run[k] is not None:
            assert run[k] <= 1e-10, (k, run[k])
    assert run["grads"] <= GRAD_TOL[stage], run["grads"]
    if stage == "deform":
        assert run["after"] <= 1e-10, run["after"]


# ---------------------------------------------------------------------------
# (e) against tpureg's spatially sharded step

# the two ranks' fp32 step each stage is held against, at its size
TPUREG_CASES = {"deform": "deform-spatial2-fp32", "affine": "affine-spatial2-fp32"}


def tpureg_sharded_step(stage, params, vols, dtype, sharded=True):
    """(metrics, gradient in the port's names) of tpureg's train step in
    ``dtype`` (fp64 under ``jax.enable_x64``), jitted over ``make_mesh(1,
    2)`` with the state replicated and the batch placed by
    ``spatial_sharding(mesh, 5, axis=2)`` (tpureg/cli/train_affine.py:81-88,
    :112-114), or on one device."""
    jmodel, jstep = STAGES[stage][:2]
    with jax.enable_x64(dtype == np.float64):
        p = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dtype)), params)
        state = ts.TrainState.create(apply_fn=jmodel().apply, params=p,
                                     tx=keep_gradient())
        v = jnp.asarray(vols.astype(dtype))
        if sharded:
            mesh = make_mesh(1, 2, devices=jax.devices()[:2])
            state = jax.device_put(state, NamedSharding(mesh, PartitionSpec()))
            v = jax.device_put(v, spatial_sharding(mesh, 5, axis=2))
            assert len(v.sharding.device_set) == 2
        state, metrics = jstep(donate=False)(state, v)
        return ({k: float(x) for k, x in metrics.items()},
                state_dict_from_jax_3d(jax.tree.map(np.asarray, state.opt_state)))


def _distances(grads, want):
    """(whole-model relative L2, per-tensor median) of ``grads`` from
    ``want`` (test_torch_train3d.py's measure)."""
    errs = sorted(float(np.linalg.norm(np.asarray(grads[k], np.float64) - np.asarray(w))
                        / np.linalg.norm(np.asarray(w))) for k, w in want.items())
    return relative_l2(grads, want), errs[len(errs) // 2]


@pytest.fixture(scope="module")
def tpureg_runs(step_runs, refcache):  # noqa: F811
    """Per stage: tpureg's sharded fp32 step, its fp64 yardstick (sharded
    for the affine stage; unsharded for the deform stage, whose sharded fp64
    step aborts in XLA's SPMD partitioner), and the two ranks' fp32 step:
    metrics and gradient distances. Once a session."""
    def compute():
        out = {}
        for stage, name in TPUREG_CASES.items():
            size = STEP_CONFIGS[name][1]
            vols, params, _ = stage_inputs(stage, size)
            # XLA's SPMD partitioner aborts the process on tpureg's sharded
            # fp64 deform step (spmd_partitioner_util.h:117: "Check failed:
            # ShapeUtil::IsScalarWithElementType"): its fp64 yardstick is
            # the unsharded step
            want_m, want_g = tpureg_sharded_step(stage, params, vols, np.float64,
                                                 sharded=stage == "affine")
            tp_m, tp_g = tpureg_sharded_step(stage, params, vols, np.float32)
            port = step_runs[name]
            out[stage] = {"want": want_m, "tpureg32": tp_m, "port": port["metrics"],
                          "port_dist": _distances(port["grads"], want_g),
                          "tpureg_dist": _distances(tp_g, want_g),
                          "keys": sorted(want_g) == sorted(port["grads"])}
        return out

    return refcache("spatial_tpureg_runs", compute)


@pytest.mark.parametrize("stage", sorted(TPUREG_CASES))
def test_spatial_step_matches_tpureg_sharded_step(tpureg_runs, stage):
    """The two ranks' fp32 step (data 1 x spatial 2) against tpureg's fp32
    step over a (1, 2) mesh with the batch's H on 'spatial', by
    test_torch_train3d.py's rule against the fp64 step: the metrics within
    1e-5 of the fp64 step's (tpureg's sharded fp32 affine loss lies 2.9e-5
    from it, the port's 6e-9: it is no yardstick for the metrics); the summed
    gradient, over the model and per tensor (median), at most twice as far
    from the fp64 gradient as tpureg's sharded fp32 gradient lies (1e-5
    where fp32 rounding alone sets it)."""
    run = tpureg_runs[stage]
    assert run["keys"]
    assert set(run["port"]) == set(run["want"]) == set(run["tpureg32"])
    for k, want in run["want"].items():
        assert abs(run["port"][k] / want - 1) <= 1e-5, (k, run["port"][k], want)
    for got, bound in zip(run["port_dist"], run["tpureg_dist"]):
        assert got <= max(2 * bound, 1e-5), (run["port_dist"], run["tpureg_dist"])


# ---------------------------------------------------------------------------
# (f) the CLI

CLI_ARGS = ["--synthetic", "1", "--epochs", "1", "--batch_size", "2", "--logdir", "unused"]
CLI_RUNS = {"deform": ["--stage", "deform", "--volume_size", "16,32,32"],
            "affine": ["--stage", "affine", "--volume_size", "16,64,64"]}


def _cli(argv):
    """The 3-D CLI in this process on the CPU, torch's default dtype fp64, no
    TensorBoard backend loaded: (printed text, writers made, step count)."""
    import tpureg_torch.utils.tb as tb
    from tpureg_torch.cli import train_affine

    writers, make = [], tb._make_writer
    tb._make_writer = lambda logdir, flush_secs: writers.append(logdir)
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    text = io.StringIO()
    try:
        with redirect_stdout(text):
            state = train_affine.main(argv, device="cpu")
    finally:
        tb._make_writer = make
        torch.set_default_dtype(dtype)
    return text.getvalue(), writers, state.step


@pytest.fixture(scope="module")
def cli_runs(refcache):  # noqa: F811
    """Per stage, the two ranks' CLI runs with ``--spatial_shards 2`` and one
    process's without it. Once a session."""
    def compute():
        runs = {k: CLI_ARGS + v + ["--spatial_shards", "2"] for k, v in CLI_RUNS.items()}
        with spawned("spatial_cli", {"runs": runs, "dtype": torch.float64}) as collect:
            one = {k: _cli(CLI_ARGS + v) for k, v in CLI_RUNS.items()}
            ranks = collect()
        return {k: {"ranks": [r[k] for r in ranks], "one": one[k]} for k in CLI_RUNS}

    return refcache("spatial_cli_runs", compute)


@pytest.mark.parametrize("stage", sorted(CLI_RUNS))
def test_spatial_cli_over_two_ranks_matches_one_process(cli_runs, stage):
    """``--spatial_shards 2 --synthetic 1`` over two ranks joined from
    torchrun's environment (the CLI's own branch, then the group it left
    initialised): each rank takes its step, both end on the same weights,
    rank 0 prints one process's epoch line, to the printed digits, and
    makes the one TensorBoard writer; rank 1 prints and makes nothing."""
    run = cli_runs[stage]
    text, writers, step = run["one"]
    (r0, r1) = run["ranks"]
    tag = stage.upper()
    assert f"[{tag} epoch 1/1] loss" in text
    assert [r["step"] for r in run["ranks"]] == [step, step] == [1, 1]
    assert r0["from_rank0"] == r1["from_rank0"] == 0.0
    assert r0["text"] == text
    assert r1["text"] == ""
    assert len(r0["writers"]) == len(writers) == 1 and r1["writers"] == []
