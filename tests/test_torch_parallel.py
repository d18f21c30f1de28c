"""Data-parallel training of tpureg_torch (``tpureg_torch/parallel/``) against
tpureg's semantics on the CPU, with two gloo processes.

tpureg's step over a batch sharded on ``'data'`` is one program over the
global batch (tpureg/parallel/mesh.py:1-16), so the port's data-parallel
step, each rank holding its rows, must give the single-process step's
results on the concatenated batch. Held here:

- (a) the FSDP rule: ``fsdp_param_dim`` with ``flax_dims`` picks the
  parameters and the dimension that ``tpureg.parallel.fsdp_param_sharding``
  picks, for every parameter of flownet2 and flownets at 2, 3, 4 and 8
  devices (conftest's host devices);
- (b) the per-process split of ``volume2slices_datasets`` against tpureg's,
  on the same Analyze volumes, for 1-4 processes;
- (c) ``BatchNorm2d`` and ``OFEloss`` over two ranks against one process on
  the concatenation, in fp64;
- (d) the train step (flownetc, BatchNorm on, 32², global batch 4) over two
  ranks against the single-process step, in fp64 with one and two
  microbatches, with ``remat`` and under FSDP, and in bf16; the fp64 step
  also against tpureg's step on the global batch;
- (e) the training CLI's ``--fsdp`` over two ranks (flownets, 64²,
  ``--synthetic 2``) against single-process runs without it, the batch
  sharded (4) and replicated (3), and its checkpoint resumed in one process.

The ranks run in ``tests/torch_parallel_worker.py``, two processes on a
free port, each spawn bounded by ``SPAWN_TIMEOUT`` seconds and its children
killed on failure; their results, and tpureg's reference step, are computed
once a session (``refcache``). The single-process references run here, on
one torch thread.

Tolerances. fp64 quantities that only fp64 arithmetic reaches (BatchNorm's
output and gradients, the loss's terms and gradients on fp64 inputs, the
updated weights) agree to 1e-10. The train step evaluates its loss in fp32
even on fp64 flows (steps.py), and BatchNorm takes its running statistics
in fp32 in one process (layers.py): the step's metrics and the running
statistics are therefore held at fp32's rounding, 1e-6 relative, where the
ranks sum their rows in another order than one process does.
"""

import contextlib
import functools
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_cli import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_elastic import write_analyze
from test_torch_refcache import refcache  # noqa: F401 (a fixture)
from test_torch_zoo import numpy_variables, pair_batch
from torch_parallel_worker import recording
from tpureg.data import volume2slices_datasets as jax_volume2slices_datasets
from tpureg.parallel import fsdp_param_sharding, make_mesh
from tpureg.reg import OpticalFlowReg as JaxOpticalFlowReg
from tpureg.train import make_train_step as jax_make_train_step
from tpureg.train.state import RegTrainState
from tpureg_torch.cli import train as cli_train
from tpureg_torch.compat import state_dict_from_jax
from tpureg_torch.compat.from_jax import _leaves, _torch_key
from tpureg_torch.data import volume2slices_datasets
from tpureg_torch.losses import OFEloss
from tpureg_torch.nn.layers import batch_norm
from tpureg_torch.parallel import flax_dims, fsdp_param_dim, local_rows
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.train import (create_train_state, make_eval_step, make_train_step,
                                training_state_path)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")
SPAWN_TIMEOUT = 120
TERMS = ("loss", "photo_loss", "corr_loss", "smooth_loss")
STATS = ("running_mean", "running_var", "num_batches_tracked")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def spawned(case, inputs, world=2):
    """Start ``case`` of the worker on ``world`` gloo ranks and give a
    function that waits for them and returns each rank's results; the
    caller may compute meanwhile. The ranks get ``SPAWN_TIMEOUT`` seconds
    from their start (at least 10 from the wait) and are killed if any
    fails, if they outlast it or if the caller raises."""
    folder = tempfile.mkdtemp(prefix="torch_parallel_")
    procs, logs = [], []
    try:
        torch.save(inputs, os.path.join(folder, "inputs.pt"))
        # torchrun's environment: the ranks join through init_from_env
        env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(os.path.dirname(WORKER)), env.get("PYTHONPATH", "")])
        deadline = time.monotonic() + SPAWN_TIMEOUT
        for r in range(world):
            logs.append(open(os.path.join(folder, f"log{r}.txt"), "wb"))
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, case, folder],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=logs[-1],
                stderr=subprocess.STDOUT))

        def collect():
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 10))
            for r, p in enumerate(procs):
                if p.returncode:
                    with open(os.path.join(folder, f"log{r}.txt"), "rb") as f:
                        log = f.read().decode(errors="replace")[-4000:]
                    raise AssertionError(f"rank {r} of {case} exited "
                                         f"{p.returncode}:\n{log}")
            return [torch.load(os.path.join(folder, f"rank{r}.pt"), weights_only=False)
                    for r in range(world)]

        yield collect
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        shutil.rmtree(folder, ignore_errors=True)


def spawn(case, inputs, world=2):
    """Each rank's results of ``case`` on ``world`` gloo ranks."""
    with spawned(case, inputs, world) as collect:
        return collect()


def to_numpy(tree):
    """Torch tensors in nested dicts, lists and tuples as numpy arrays."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def assert_close(got, want, tol, what):
    """``got`` within ``tol`` of ``want``, relative to ``want``'s largest
    value (at least 1e-30)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0)) / scale
    assert err <= tol, f"{what}: {err:.3g} relative to its largest value"


# ---------------------------------------------------------------------------
# (a) the FSDP rule


def _port_dims(model, n):
    """{torch key: dimension or None} of the port's rule at ``n`` ranks."""
    out = {}
    for prefix, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            flax = flax_dims(module, name)
            d = fsdp_param_dim([p.shape[t] for t in flax], n)
            out[f"{prefix}.{name}" if prefix else name] = None if d is None else flax[d]
    return out


@functools.lru_cache(maxsize=None)
def flax_shapes(name):
    """tpureg's predictor parameter shapes for ``name`` (``jax.eval_shape``
    of its initialisation at 64²)."""
    module = JaxOpticalFlowReg(conv_predictor=name)
    imgs = jnp.zeros((1, 64, 64, 2), jnp.float32)
    return jax.eval_shape(lambda k, a: module.init(k, a, train=True),
                          jax.random.key(0), imgs)["params"]["predictor"]


@pytest.mark.parametrize("name", ["flownet2", "flownets"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_fsdp_rule_matches_tpureg(name, n):
    """For every parameter tpureg's ``fsdp_param_sharding`` shards on a mesh
    of ``n`` host devices, the port shards the same weight along the torch
    dimension that holds the flax dimension tpureg picked (found by
    carrying an index along that dimension through the weight bridge);
    every parameter tpureg replicates, the port replicates."""
    mesh = make_mesh(n_data=n, devices=jax.devices()[:n])
    with torch.device("meta"):
        port = _port_dims(OpticalFlowReg(name).predictor, n)
    seen, sharded = set(), 0
    for path, leaf in _leaves(flax_shapes(name)):
        key = _torch_key(path)
        spec = tuple(fsdp_param_sharding(mesh, leaf).spec)
        assert key in port, (path, key)
        seen.add(key)
        if "data" not in spec:
            assert port[key] is None, (key, port[key])
            continue
        sharded += 1
        d = spec.index("data")
        index = np.broadcast_to(
            np.arange(leaf.shape[d]).reshape([-1 if i == d else 1
                                              for i in range(leaf.ndim)]),
            leaf.shape).astype(np.float32)
        tree = {}
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = index
        carried = state_dict_from_jax(tree, None, prefix=())[key].numpy()
        varies = [i for i in range(carried.ndim)
                  if np.ptp(carried, axis=i).max() > 0]
        assert varies == [port[key]], (key, varies, port[key])
    assert seen == set(port) and sharded > 0


# ---------------------------------------------------------------------------
# (b) the per-process split of the training volumes


@pytest.fixture(scope="module")
def volume_dirs(tmp_path_factory):
    """img/ and seg/ holding 12 small Analyze volumes: 10 training volumes,
    one for val and one for test under the default fractions."""
    root = tmp_path_factory.mktemp("parallel_volumes")
    dirs = {k: root / k for k in ("img", "seg")}
    rng = np.random.default_rng(5)
    for d in dirs.values():
        d.mkdir()
    for i in range(12):
        vol = (rng.random((8, 12, 10, 1)) * 1000).astype(np.int16)
        seg = rng.integers(0, 4, (8, 12, 10, 1)).astype(np.int16)
        write_analyze(str(dirs["img"] / f"sub{i:02d}_mpr"), vol)
        write_analyze(str(dirs["seg"] / f"sub{i:02d}_seg"), seg)
    return str(dirs["img"]), str(dirs["seg"])


@pytest.mark.parametrize("limit", [12, 2], ids=["10-train-volumes", "2-train-volumes"])
@pytest.mark.parametrize("pc", [1, 2, 3, 4])
def test_volume_split_matches_tpureg(volume_dirs, pc, limit):
    """Each process's training volumes, and the split's lengths, as tpureg's
    ``volume2slices_datasets(process_index=, process_count=)`` gives them:
    round-robin, truncated to a common count, one volume repeated where
    there are fewer volumes than processes; the shards disjoint when there
    are enough volumes; val and test not split; the training seed folded
    with the index only when ``pc`` > 1."""
    img_dir, seg_dir = volume_dirs
    shards, seeds = [], []
    for pi in range(pc):
        want = jax_volume2slices_datasets(img_dir, seg_dir, 2, limit=limit,
                                          process_index=pi, process_count=pc)
        got = volume2slices_datasets(img_dir, seg_dir, 2, "cpu", limit=limit,
                                     process_index=pi, process_count=pc)
        for split in range(3):
            assert ([it["image"] for it in got[split].source.items]
                    == [it["image"] for it in want[split].source.items]), split
        assert got[3:] == want[3:]
        shards.append([it["image"] for it in got[0].source.items])
        seeds.append(got[0].seed)
    assert len({len(s) for s in shards}) == 1
    n_train = len(volume2slices_datasets(img_dir, seg_dir, 2, "cpu", limit=limit,
                                         process_index=0, process_count=1
                                         )[0].source.items)
    if n_train >= pc:
        flat = [v for s in shards for v in s]
        assert len(flat) == len(set(flat))
    assert seeds == ([(6, 0)] if pc == 1 else [(6, 0, pi) for pi in range(pc)])


def test_volume_split_defaults_to_one_process(volume_dirs):
    """Without a process group the split is tpureg's for one process."""
    img_dir, seg_dir = volume_dirs
    got = volume2slices_datasets(img_dir, seg_dir, 2, "cpu")
    want = volume2slices_datasets(img_dir, seg_dir, 2, "cpu", process_index=0,
                                  process_count=1)
    assert ([it["image"] for it in got[0].source.items]
            == [it["image"] for it in want[0].source.items])
    assert got[0].seed == want[0].seed == (6, 0)


# ---------------------------------------------------------------------------
# (c) BatchNorm2d and OFEloss over two ranks


def _bn_loss_inputs():
    rng = np.random.default_rng(11)
    t = lambda *shape, lo=-1.0, hi=1.0: torch.from_numpy(rng.uniform(lo, hi, shape))
    bn = batch_norm(3).double()
    with torch.no_grad():
        bn.weight.copy_(t(3, lo=0.5, hi=1.5))
        bn.bias.copy_(t(3))
        bn.running_mean.copy_(t(3))
        bn.running_var.copy_(t(3, lo=0.5, hi=1.5))
    # a U(0, 1) offset on one channel, as behind flownet2's i_conv biases
    x = t(4, 3, 5, 6) + torch.tensor([0.0, 0.7, 0.0], dtype=torch.float64)[:, None, None]
    return {"bn": bn.state_dict(), "x": x, "cot": t(4, 3, 5, 6),
            "flows": [t(4, 2, 8, 8), t(4, 2, 4, 4), t(4, 2, 1, 1)],
            "warped": [t(4, 1, 8, 8, lo=0, hi=1), t(4, 1, 4, 4, lo=0, hi=1),
                       t(4, 1, 1, 1, lo=0, hi=1)],
            "fixed": t(4, 1, 16, 16, lo=0, hi=1)}


@pytest.fixture(scope="module")
def bn_loss_runs(refcache):  # noqa: F811
    """(inputs, the two ranks' results, one process's results), once a
    session."""
    def compute():
        inputs = _bn_loss_inputs()
        ranks = spawn("bn_loss", inputs)
        bn = batch_norm(3).double()
        bn.load_state_dict(inputs["bn"])
        x = inputs["x"].clone().requires_grad_(True)
        y = bn(x)
        (y * inputs["cot"]).sum().backward()
        one = {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad,
               "dbias": bn.bias.grad, "running_mean": bn.running_mean,
               "running_var": bn.running_var}
        flows = [f.clone().requires_grad_(True) for f in inputs["flows"]]
        warped = [w.clone().requires_grad_(True) for w in inputs["warped"]]
        fixed = inputs["fixed"].clone().requires_grad_(True)
        terms = OFEloss(flows, warped, fixed)
        terms[3].backward()
        one.update(terms=torch.stack([t.detach() for t in terms]),
                   dflows=[f.grad for f in flows], dwarped=[w.grad for w in warped],
                   dfixed=fixed.grad)
        return to_numpy(inputs), to_numpy(ranks), to_numpy(one)

    return refcache("parallel_bn_loss", compute)


def test_batchnorm_over_two_ranks_matches_one_process(bn_loss_runs):
    """The global batch's normalisation: each rank's output rows and input
    gradient rows equal one process's on the concatenation, the ranks'
    weight gradients sum to its, to 1e-10; the running statistics, equal
    on both ranks, at fp32's rounding (one process takes them in fp32)."""
    _, ranks, one = bn_loss_runs
    for r in ranks:
        assert_close(r["y"], one["y"][r["rows"]], 1e-10, "output")
        assert_close(r["dx"], one["dx"][r["rows"]], 1e-10, "input gradient")
    for k in ("dweight", "dbias"):
        assert_close(ranks[0][k] + ranks[1][k], one[k], 1e-10, k)
    for k in ("running_mean", "running_var"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
        assert_close(ranks[0][k], one[k], 1e-6, k)


def test_ofe_loss_over_two_ranks_matches_one_process(bn_loss_runs):
    """The ranks' shares of the photometric, correlation and smoothness
    terms and of the total sum to one process's terms on the concatenation
    (the correlation a global Pearson, the 1×1 scale degenerate), and each
    rank's input gradients are that process's rows, to 1e-10."""
    _, ranks, one = bn_loss_runs
    assert_close(ranks[0]["terms"] + ranks[1]["terms"], one["terms"], 1e-10, "terms")
    for r in ranks:
        rows = r["rows"]
        for i in range(3):
            assert_close(r["dflows"][i], one["dflows"][i][rows], 1e-10, f"dflow {i}")
            assert_close(r["dwarped"][i], one["dwarped"][i][rows], 1e-10,
                         f"dwarped {i}")
        assert_close(r["dfixed"], one["dfixed"][rows], 1e-10, "dfixed")


def test_local_rows_follow_tpureg_microbatches():
    """Rank r holds the r-th half of each microbatch (tpureg steps.py:186:
    microbatch k is the global rows k·B/A ... (k+1)·B/A - 1), so its own
    split into ``accum_steps`` gives it its part of every microbatch."""
    assert local_rows(8, 2, 0).tolist() == [0, 1, 2, 3]
    assert local_rows(8, 2, 1, accum_steps=2).tolist() == [2, 3, 6, 7]
    assert local_rows(8, 4, 3, accum_steps=2).tolist() == [3, 7]
    with pytest.raises(ValueError):
        local_rows(6, 2, 0, accum_steps=2)


# ---------------------------------------------------------------------------
# (d) the data-parallel train step

STEP_SIZE, STEP_BATCH = 32, 4
# the bf16 case runs at 64²: at 32² FlowNetC's conv6 sees a 1×1 input, where
# the CPU's bf16 convolution weight gradient at batch 4 is read from memory
# that was never written (a different garbage value, up to 1e34, in about
# half of the single-process steps; batch 2 and 64² are sound)
BF16_SIZE = 64
# each variant right after the configuration it must equal (``same_as``)
STEP_CONFIGS = {
    "fp64": dict(param_dtype=torch.float64),
    "fp64_fsdp": dict(param_dtype=torch.float64, fsdp=True, same_as="fp64"),
    "fp64_accum2": dict(param_dtype=torch.float64, accum_steps=2),
    "fp64_accum2_remat": dict(param_dtype=torch.float64, accum_steps=2, remat="full",
                              same_as="fp64_accum2"),
}
BF16_CONFIGS = {"bf16": dict(param_dtype=torch.float32, compute_dtype=torch.bfloat16)}


def _flownetc_weights(size):
    """The head around flownetc (BatchNorm on) with tpureg's numpy-drawn
    variables, as tpureg's variables and the port's state dict."""
    imgs, _ = pair_batch(3, STEP_BATCH, size)
    variables = numpy_variables(JaxOpticalFlowReg(conv_predictor="flownetc"), imgs, 21)
    with torch.device("meta"):
        model = OpticalFlowReg("flownetc")
    model.predictor.load_state_dict(state_dict_from_jax(*variables), strict=True,
                                    assign=True)
    return imgs, variables, model.state_dict()


def _split(sd, before):
    """(update = ``sd`` - ``before`` of the weights, running statistics)."""
    update = {k: v.double() - before[k].double() for k, v in sd.items()
              if not k.endswith(STATS)}
    return update, {k: v for k, v in sd.items() if k.endswith(STATS)}


def _single_step(sd, imgs, cfg):
    """One process's train step (and the eval step after it) from ``sd`` on
    the whole batch: (metrics, eval metrics, update, running statistics)."""
    with torch.device("meta"):
        model = OpticalFlowReg("flownetc")
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, assign=True)
    model = model.to(cfg["param_dtype"])
    state = create_train_state(model)
    x = torch.from_numpy(imgs).to(cfg["param_dtype"])
    metrics = make_train_step(state, compute_dtype=cfg.get("compute_dtype"),
                              accum_steps=cfg.get("accum_steps", 1))(x)
    _, evals = make_eval_step(model, compute_dtype=cfg.get("compute_dtype"))(x)
    return ({k: float(v) for k, v in metrics.items()},
            {k: float(v) for k, v in evals.items()}, *_split(model.state_dict(), sd))


def _tpureg_step(variables, imgs, before):
    """tpureg's fp64 train step on the global batch: its metrics, update and
    running statistics, in the port's names and layouts."""
    params, stats = variables
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        state = RegTrainState.create(
            apply_fn=JaxOpticalFlowReg(conv_predictor="flownetc").apply,
            params=p64, tx=optax.adam(1e-4, eps=1e-4), batch_stats=stats)
        state, m = jax_make_train_step(donate=False)(state,
                                                      jnp.asarray(imgs, jnp.float64))
        get = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
        sd = state_dict_from_jax(get(state.params), get(state.batch_stats))
    sd = {f"predictor.{k}": v for k, v in sd.items()}
    return ({k: float(m[k]) for k in TERMS},
            *_split(sd, {k: before[k] for k in sd}))


def update_distance(got, want):
    """Relative L2, over the model, of update ``got`` from update ``want``."""
    diff2 = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    ref2 = sum(float((want[k].double() ** 2).sum()) for k in want)
    return (diff2 / ref2) ** 0.5


def stats_error(got, want):
    """The largest difference of running statistics ``got`` from ``want``,
    relative to each tensor's largest value; step counts must be equal."""
    err = 0.0
    for k, w in want.items():
        if k.endswith(STATS[2]):
            assert int(got[k]) == int(w), k
            continue
        scale = max(float(w.double().abs().max()), 1e-30)
        err = max(err, float((got[k].double() - w.double()).abs().max()) / scale)
    return err


def _summary(ranks, one):
    """What the tests read of one configuration: the ranks' metrics, eval
    metrics, step counts, shares and differences from rank 0 (and from the
    configuration they must equal); one process's metrics and eval
    metrics; rank 0's update distance and statistics error from one
    process's."""
    out = {k: [r[k] for r in ranks] for k in ("metrics", "eval", "step", "shares",
                                                "from_rank0")}
    out["same_as"] = [r.get("same_as") for r in ranks]
    out["one"] = one[:2]
    out["update"] = update_distance(ranks[0]["update"], one[2])
    out["stats"] = stats_error(ranks[0]["stats"], one[3])
    return out


@pytest.fixture(scope="module")
def step_runs(refcache):  # noqa: F811
    """Per configuration, ``_summary`` of the two ranks against one process;
    tpureg's fp64 step against the data-parallel one; the bf16 yardstick.
    Once a session; one process's steps and tpureg's run while the ranks
    do."""
    def compute():
        out = {}
        for size, configs in ((STEP_SIZE, STEP_CONFIGS), (BF16_SIZE, BF16_CONFIGS)):
            imgs, variables, sd = _flownetc_weights(size)
            inputs = {"model": "flownetc", "state_dict": sd,
                      "imgs": torch.from_numpy(imgs), "configs": configs}
            with spawned("step", inputs) as collect:
                one = {}
                for cfg in configs.values():
                    # remat and FSDP compute the base step's numbers
                    key = (cfg["param_dtype"], cfg.get("compute_dtype"),
                           cfg.get("accum_steps", 1))
                    if key not in one:
                        one[key] = _single_step(sd, imgs, cfg)
                if size == BF16_SIZE:
                    # the yardstick: the same step on the batch with its
                    # halves swapped, a change of rounding only
                    swapped = _single_step(sd, imgs[[2, 3, 0, 1]], BF16_CONFIGS["bf16"])
                else:
                    reference = _tpureg_step(variables, imgs, sd)
                ranks = collect()
            for name, cfg in configs.items():
                key = (cfg["param_dtype"], cfg.get("compute_dtype"),
                       cfg.get("accum_steps", 1))
                out[name] = _summary([r[name] for r in ranks], one[key])
            if size == BF16_SIZE:
                out["bf16"]["spread"] = update_distance(swapped[2], one[key][2])
            else:
                dp = ranks[0]["fp64"]
                g, w = dp["update"], reference[1]
                far = sum(int(((g[k].double() - w[k]) .abs() > 1e-6).sum()) for k in w)
                out["tpureg"] = {"metrics": reference[0], "dp_metrics": dp["metrics"],
                                 "update": update_distance(g, w),
                                 "far": far / sum(v.numel() for v in w.values()),
                                 "stats": max(float((dp["stats"][k].double() - v.double()).norm()
                                                    / v.double().norm())
                                              for k, v in reference[2].items()
                                              if not k.endswith(STATS[2])),
                                 "before": {k: sd[k].numel() for k in sd
                                            if not k.endswith(STATS)}}
        return to_numpy(out)

    return refcache("parallel_step_runs", compute)


@pytest.mark.parametrize("name", list(STEP_CONFIGS))
def test_dp_step_matches_one_process(step_runs, name):
    """Two ranks of 2 rows against one process on the 4, in fp64: the same
    metrics and eval metrics on both ranks, within 1e-6 of one process's
    (the loss is fp32); the update within 1e-6 in relative L2 over the
    model (the fp32 Pearson's rounding, about 1e-7, reaches the gradient;
    measured 3e-8 and 7e-8); weights and running statistics equal on both
    ranks, the statistics within 1e-6 of one process's (fp32); one step
    taken."""
    run = step_runs[name]
    (m0, m1), (e0, e1) = run["metrics"], run["eval"]
    assert m0 == m1 and e0 == e1
    for k in TERMS:
        np.testing.assert_allclose(m0[k], run["one"][0][k], rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(e0[k], run["one"][1][k], rtol=1e-6, err_msg=k)
    assert run["step"] == [1, 1] and run["from_rank0"] == [0.0, 0.0]
    assert run["update"] <= 1e-6, run["update"]
    assert run["stats"] <= 1e-6, run["stats"]


@pytest.mark.parametrize("name", [n for n, c in STEP_CONFIGS.items() if "same_as" in c])
def test_dp_step_remat_and_fsdp_equal_dp_step(step_runs, name):
    """remat repeats the forward and its collectives in the backward, FSDP
    gathers, sums and slices: neither changes a number of the data-parallel
    step (one thread, the same collectives), so the weights, the statistics
    and Adam's moments are the base configuration's to the bit."""
    base = STEP_CONFIGS[name]["same_as"]
    assert step_runs[name]["metrics"] == step_runs[base]["metrics"]
    assert step_runs[name]["eval"] == step_runs[base]["eval"]
    assert step_runs[name]["same_as"] == [(0.0, 0.0), (0.0, 0.0)]


def test_fsdp_step_holds_half_of_each_sharded_tensor(step_runs):
    """Under FSDP each rank holds half of every parameter tpureg's rule
    shards (2^16 elements or more), and half of each of its two Adam
    moments, between steps; those carry most of the weights."""
    sizes = step_runs["tpureg"]["before"]
    for shares in step_runs["fp64_fsdp"]["shares"]:
        assert shares and set(shares) <= set(sizes)
        for k, (held, moments) in shares.items():
            assert held * 2 == sizes[k], k
            assert list(moments) == [held, held], k
        assert all(sizes[k] < 2**16 for k in set(sizes) - set(shares))
        assert sum(sizes[k] for k in shares) > 0.9 * sum(sizes.values())


def test_dp_step_matches_tpureg(step_runs):
    """The data-parallel fp64 step against tpureg's fp64 step on the global
    batch, by the rule of the zoo's flownets step
    (tests/test_torch_zoo.py): the loss terms within 1e-5, the update
    within 0.05 in relative L2 with at most 1% of the weights further than
    1e-6 from tpureg's, the running statistics within 1e-5 in relative
    L2."""
    ref = step_runs["tpureg"]
    for k in TERMS:
        np.testing.assert_allclose(ref["dp_metrics"][k], ref["metrics"][k], rtol=1e-5,
                                   err_msg=k)
    assert ref["update"] <= 0.05, ref["update"]
    assert ref["far"] <= 0.01, ref["far"]
    assert ref["stats"] <= 1e-5, ref["stats"]


def test_dp_bf16_step_matches_one_process(step_runs):
    """bf16 (weights and activations cast, BatchNorm and the loss in fp32)
    at 64²: the metrics equal on both ranks and within 1e-3 of one
    process's (bf16 keeps 8 bits; measured 4e-5), the running statistics
    within 1e-3 of their largest value; the update no further from one
    process's than twice the distance between one process's step and the
    same step with the batch's halves swapped (a change of rounding only:
    Adam's first update is about ±lr wherever the gradient is above its
    eps, so a gradient within rounding of zero may step the other way;
    measured 0.089 against 0.098)."""
    run = step_runs["bf16"]
    m0, m1 = run["metrics"]
    assert m0 == m1 and run["from_rank0"] == [0.0, 0.0]
    for k in TERMS:
        np.testing.assert_allclose(m0[k], run["one"][0][k], rtol=1e-3, err_msg=k)
    assert run["update"] <= 2 * run["spread"], (run["update"], run["spread"])
    assert run["stats"] <= 1e-3, run["stats"]


# ---------------------------------------------------------------------------
# (e) the training CLI's --fsdp

CLI_ARGS = ["--model", "flownets", "--synthetic", "2", "--image_size", "64",
            "--logdir", "unused"]


def _cli(argv):
    """The training CLI in this process, on the CPU, with no TensorBoard
    backend loaded: (state dict at the end, state, printed text, its steps'
    record as the worker's ``recording`` makes it)."""
    import io
    from contextlib import redirect_stdout

    import tpureg_torch.utils.tb as tb

    make, tb._make_writer = tb._make_writer, lambda logdir, flush_secs: None
    out = io.StringIO()
    try:
        with redirect_stdout(out), recording(cli_train) as calls:
            state = cli_train.main(CLI_ARGS + argv, device="cpu")
    finally:
        tb._make_writer = make
    return ({k: v.clone() for k, v in state.model.state_dict().items()}, state,
            out.getvalue(), calls)


def _weights_error(got, want, before):
    """Relative L2, over the model, of the change ``got`` - ``before`` from
    ``want`` - ``before``."""
    diff2 = ref2 = 0.0
    for k, w in want.items():
        if not k.endswith(STATS):
            diff2 += float(((got[k].double() - w.double()) ** 2).sum())
            ref2 += float(((w.double() - before[k].double()) ** 2).sum())
    return (diff2 / ref2) ** 0.5


def _equal(got, want):
    """Whether two (nested) dicts of tensors are equal to the bit."""
    if isinstance(want, dict):
        return set(got) == set(want) and all(_equal(got[k], want[k]) for k in want)
    return torch.is_tensor(got) and torch.equal(got, want)


def _checkpoint(workdir):
    """The training state file under ``workdir``: (weights, Adam's moments
    by parameter name)."""
    payload = torch.load(training_state_path(workdir, "FlowNetS"), weights_only=True)
    names = [n for n, _ in OpticalFlowReg("flownets").named_parameters()]
    moments = {names[i]: {k: v for k, v in s.items()}
               for i, s in payload["optimizer"]["state"].items()}
    return payload["model"], moments, payload["step"]


def _steps_against(ranks, one):
    """What each rank's CLI made its steps of and passed them, against one
    process's (``recording``'s records): for each of the train and eval
    steps, each rank's ``replicated`` and whether it was given the group;
    whether every batch it passed is its rows of one process's batch (the
    whole batch when replicated, else ``local_rows``); and the largest
    relative difference of the first train step's metrics, taken from the
    initial weights, from one process's."""
    out = {}
    for kind in ("train", "eval"):
        (want,) = one[kind]
        entries = [r[kind][0] for r in ranks if len(r[kind]) == 1]
        assert len(entries) == len(ranks), kind
        rows = []
        for rank, entry in enumerate(entries):
            n = want["batches"][0].shape[0]
            keep = (torch.arange(n) if entry["replicated"]
                    else local_rows(n, len(ranks), rank))
            rows.append(len(entry["batches"]) == len(want["batches"]) and all(
                torch.equal(got, full[keep])
                for got, full in zip(entry["batches"], want["batches"])))
        out[kind] = {"replicated": [e["replicated"] for e in entries],
                     "group": [e["group"] for e in entries], "rows": rows}
    first = one["train"][0]["metrics"][0]
    out["first_metrics"] = max(
        abs(r["train"][0]["metrics"][0][k] / first[k] - 1) for r in ranks for k in first)
    return out


@pytest.fixture(scope="module")
def cli_runs(refcache):  # noqa: F811
    """Two ranks of ``--fsdp`` (batch 4 sharded, batch 3 replicated, and a
    restore of a single-process checkpoint) beside single-process runs, and
    a single-process restore and resume of the two ranks' checkpoint; what
    the tests read of them. Once a session."""
    def compute():
        root = tempfile.mkdtemp(prefix="torch_parallel_cli_")
        try:
            work = {k: os.path.join(root, k) for k in ("one4", "fsdp4", "fsdp3")}
            one4, _, _, calls4 = _cli(["--batch_size", "4", "--epochs", "1", "--cp", "0",
                               "--workdir", work["one4"]])
            runs = {
                "fsdp4": ["--batch_size", "4", "--epochs", "1", "--cp", "0",
                          "--workdir", work["fsdp4"], "--fsdp"],
                "fsdp3": ["--batch_size", "3", "--epochs", "1", "--cp", "0",
                          "--workdir", work["fsdp3"], "--fsdp"],
                # the single-process run's checkpoint, restored under --fsdp
                # (its one epoch is done, so nothing trains)
                "fsdp_restore": ["--batch_size", "4", "--epochs", "1", "--cp", "1",
                                 "--workdir", work["one4"], "--fsdp"],
            }
            runs = {k: CLI_ARGS + v for k, v in runs.items()}
            with spawned("cli", {"runs": runs}) as collect:
                one3, _, _, calls3 = _cli(["--batch_size", "3", "--epochs", "1", "--cp", "0",
                                   "--workdir", os.path.join(root, "one3")])
                # the yardstick: one process on two threads, a change of
                # rounding only
                threads = torch.get_num_threads()
                torch.set_num_threads(2)
                try:
                    one4_2, _, _, _ = _cli(["--batch_size", "4", "--epochs", "1",
                                         "--cp", "0", "--workdir",
                                         os.path.join(root, "one4_2")])
                finally:
                    torch.set_num_threads(threads)
                ranks = collect()
            before = OpticalFlowReg("flownets",
                                    generator=torch.Generator().manual_seed(6)).state_dict()
            out = {"sizes": {k: v.numel() for k, v in one4.items()},
                   "spread": _weights_error(one4_2, one4, before)}
            for name in runs:
                out[name] = {k: [r[name][k] for r in ranks]
                             for k in ("step", "shares", "from_rank0", "written",
                                       "writers")}
            for name, want, calls in (("fsdp4", one4, calls4),
                                      ("fsdp3", one3, calls3)):
                out[name]["error"] = _weights_error(ranks[0][name]["state_dict"], want,
                                                    before)
                out[name]["steps"] = _steps_against(
                    [r[name]["calls"] for r in ranks], calls)
                out[name]["files"] = sorted(
                    os.path.relpath(os.path.join(d, f), work[name])
                    for d, _, fs in os.walk(work[name]) for f in fs)
            # a checkpoint written by one process, restored over two ranks
            sd, moments, _ = _checkpoint(work["one4"])
            got = ranks[0]["fsdp_restore"]
            out["fsdp_restore"]["equal"] = (_equal(got["state_dict"], sd)
                                            and _equal(got["moments"], moments))
            # the two ranks' checkpoint: what rank 0 held, whole
            sd, moments, step = _checkpoint(work["fsdp4"])
            got = ranks[0]["fsdp4"]
            out["fsdp4"]["file"] = (step, _equal(got["state_dict"], sd)
                                    and _equal(got["moments"], moments))
            # ... restored in one process, then resumed for a second epoch
            restored, state, _, _ = _cli(["--batch_size", "4", "--epochs", "1",
                                       "--cp", "1", "--workdir", work["fsdp4"]])
            names = {p: n for n, p in state.model.named_parameters()}
            out["one_restore"] = _equal(restored, sd) and _equal(
                {names[p]: dict(s) for p, s in state.optimizer.state.items()}, moments)
            _, state, text, _ = _cli(["--batch_size", "4", "--epochs", "2", "--cp", "1",
                                   "--workdir", work["fsdp4"]])
            out["one_resume"] = (state.step, text)
            return out
        finally:
            shutil.rmtree(root, ignore_errors=True)

    return refcache("parallel_cli_runs", compute)


def test_fsdp_cli_sharded_batch_gives_single_process_weights(cli_runs):
    """``--fsdp`` over two ranks with batch 4, split 2 and 2, against one
    process without it, after one epoch of two steps: both ranks end on the
    same weights, at step 2, and their change of the weights is no further
    from one process's than twice the distance between one process's run
    on one thread and on two. (fp32 at a random initialisation: a change of
    rounding alone moves the second Adam step's weights by tenths in
    relative L2, measured 0.28 between one and four threads, 0.21 for the
    two ranks; the fp64 step is held tightly in (d).)"""
    run = cli_runs["fsdp4"]
    assert run["step"] == [2, 2] and run["from_rank0"] == [0.0, 0.0]
    assert 0 < cli_runs["spread"]
    assert run["error"] <= 2 * cli_runs["spread"], (run["error"], cli_runs["spread"])


def test_fsdp_cli_replicated_batch_gives_single_process_weights(cli_runs):
    """Batch 3 does not split over two ranks: both hold it whole, compute
    what one process computes and average equal gradients, so the weights
    after two steps are one process's to the bit."""
    run = cli_runs["fsdp3"]
    assert run["step"] == [2, 2] and run["from_rank0"] == [0.0, 0.0]
    assert run["error"] == 0.0


@pytest.mark.parametrize("name,replicated,first_metrics", [
    ("fsdp4", False, 1e-6), ("fsdp3", True, 0.0)])
def test_fsdp_cli_steps_take_the_global_batch(cli_runs, name, replicated,
                                              first_metrics):
    """The CLI's own choice of rows under ``--fsdp``, which the weights,
    after Adam's sign-like first steps, cannot show. Batch 4 splits 2 and 2:
    each rank passes its train, validation and test steps its rows of every
    batch one process draws (``local_rows``; rank 0 rows 0-1, rank 1 rows
    2-3), with the gradients summed (``replicated=False``). Batch 3 does not
    split: each rank passes the whole batch, the gradients averaged. Either
    way the first train step, taken from the initial weights, reports one
    process's metrics: to fp32 rounding (1e-6 relative) where the ranks'
    sums are added in another order, to the bit where each rank computed
    the whole batch."""
    steps = cli_runs[name]["steps"]
    for kind in ("train", "eval"):
        assert steps[kind]["replicated"] == [replicated, replicated], kind
        assert steps[kind]["group"] == [True, True], kind
        assert steps[kind]["rows"] == [True, True], kind
    assert steps["first_metrics"] <= first_metrics, steps["first_metrics"]


@pytest.mark.parametrize("name", ["fsdp4", "fsdp3"])
def test_fsdp_cli_shards_and_writes_on_rank_0(cli_runs, name):
    """Each rank holds half of every sharded parameter and of its two
    moments; rank 0 alone writes the training state and the best weights
    and makes the TensorBoard writer: one file of each tier."""
    run, sizes = cli_runs[name], cli_runs["sizes"]
    for shares in run["shares"]:
        assert shares
        for k, (held, moments) in shares.items():
            assert held * 2 == sizes[k] and list(moments) == [held, held], k
    written, writers = run["written"], run["writers"]
    assert len(written[0]) == 2 and written[1] == []
    assert len(writers[0]) == 1 and writers[1] == []
    assert run["files"] == [
        os.path.join("Checkpoints", "Unsupervised", "FlowNetS", "training_state.pt"),
        os.path.join("model_weight", "Unsupervised", "FlowNetS", "best_weight.pt")]


def test_fsdp_checkpoint_resumes_in_one_process(cli_runs):
    """The training state written under ``--fsdp`` is the single-process
    format: the full weights and moments rank 0 held, at step 2; one
    process restores them to the bit and resumes, skipping the finished
    epoch."""
    assert cli_runs["fsdp4"]["file"] == (2, True)
    assert cli_runs["one_restore"]
    step, text = cli_runs["one_resume"]
    assert "loading checkpoint state" in text
    assert "EPOCH 1/2" not in text and "EPOCH 2/2" in text and step == 4


def test_single_process_checkpoint_restores_under_fsdp(cli_runs):
    """A training state written by one process restores over two ranks:
    sharded on load, gathered back it equals the file to the bit, at the
    file's step."""
    run = cli_runs["fsdp_restore"]
    assert run["step"] == [2, 2] and run["equal"]
    assert run["written"] == [[], []]
