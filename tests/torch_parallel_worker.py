"""One rank of the two-process gloo runs of tests/test_torch_parallel.py (not
a test module: pytest collects ``test_*.py`` only).

    RANK=r WORLD_SIZE=w MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python torch_parallel_worker.py CASE DIR

is one rank of a gloo group that ``torchrun``'s environment describes: it
joins through ``parallel.init_from_env`` on the CPU (the ``cli`` case
through the training CLI's own torchrun branch), reads its inputs from
``DIR/inputs.pt`` (written by the test), runs CASE through the port and
writes what it found to ``DIR/rank<RANK>.pt``. Torch runs on one thread.
Nothing here imports JAX or tpureg.

Cases:
- ``bn_loss``: ``BatchNorm2d`` in train mode over the group (its
  ``process_group``) and ``OFEloss(group=)`` on the rank's rows of the
  global batch, in fp64: outputs, input gradients, weight gradients, the
  running statistics;
- ``step``: one data-parallel train step of the registration head for each
  configuration in the inputs (dtype, ``accum_steps``, ``remat``, FSDP)
  from the same weights on the rank's rows (``parallel.local_rows``), and
  one data-parallel eval step (``step``'s docstring says what it reports);
- ``cli``: the training CLI with ``--fsdp`` for each argument list in the
  inputs: the step count, the share of each sharded parameter and moment,
  the largest difference of the weights at the end (gathered) from rank
  0's, rank 0's weights and Adam's moments, the files and writers this
  rank made, and what the CLI made its steps of and passed them
  (``recording``).
"""

import contextlib
import os
import sys

import torch
import torch.distributed as dist


def bn_loss(inputs, rank, world):
    from tpureg_torch.losses import OFEloss
    from tpureg_torch.nn.layers import batch_norm
    from tpureg_torch.parallel import local_rows

    group = dist.group.WORLD
    rows = local_rows(inputs["x"].shape[0], world, rank)
    bn = batch_norm(inputs["x"].shape[1]).double()
    bn.load_state_dict(inputs["bn"])
    bn.process_group = group
    x = inputs["x"][rows].clone().requires_grad_(True)
    y = bn(x)
    (y * inputs["cot"][rows]).sum().backward()
    out = {"rows": rows, "y": y.detach(), "dx": x.grad,
           "dweight": bn.weight.grad, "dbias": bn.bias.grad,
           "running_mean": bn.running_mean, "running_var": bn.running_var}

    flows = [f[rows].clone().requires_grad_(True) for f in inputs["flows"]]
    warped = [w[rows].clone().requires_grad_(True) for w in inputs["warped"]]
    fixed = inputs["fixed"][rows].clone().requires_grad_(True)
    terms = OFEloss(flows, warped, fixed, group=group)
    terms[3].backward()
    out.update(terms=torch.stack([t.detach() for t in terms]),
               dflows=[f.grad for f in flows], dwarped=[w.grad for w in warped],
               dfixed=fixed.grad)
    return out


def _state_after(state):
    """The model's state dict (full tensors) and Adam's moments by name."""
    names = {p: n for n, p in state.model.named_parameters()}
    gather = (state.shards.gathered(state.optimizer) if state.shards is not None
              else contextlib.nullcontext())
    with gather:
        sd = {k: v.clone() for k, v in state.model.state_dict().items()}
        moments = {names[p]: {k: v.clone() for k, v in s.items() if torch.is_tensor(v)}
                   for p, s in state.optimizer.state.items()}
    return sd, moments


def _shares(state):
    """{name: (parameter elements, [moment elements])} of each sharded
    parameter, as this rank holds them between steps."""
    if state.shards is None:
        return {}
    names = {p: n for n, p in state.model.named_parameters()}
    out = {}
    for p in state.shards.dims:
        moments = [v.numel() for v in state.optimizer.state.get(p, {}).values()
                   if torch.is_tensor(v) and v.dim()]
        out[names[p]] = (p.numel(), moments)
    return out


def _max_diff(a, b):
    """The largest absolute difference between two dicts of tensors."""
    return max(float((a[k].double() - b[k].double()).abs().max()) if a[k].numel()
               else 0.0 for k in b)


def _from_rank0(sd, group):
    """The largest difference of this rank's tensors from rank 0's."""
    diff = 0.0
    for v in sd.values():
        v0 = v.clone()
        dist.broadcast(v0, 0, group=group)
        diff = max(diff, float((v.double() - v0.double()).abs().max()) if v.numel() else 0.0)
    return diff


def step(inputs, rank, world):
    """For each configuration: metrics and eval metrics; the step count;
    the shares held under FSDP; the largest difference of this rank's
    weights and statistics from rank 0's; rank 0's update (after - before,
    fp32) and running statistics; with ``same_as``, the largest differences
    of the weights and of Adam's moments from that configuration's."""
    from tpureg_torch.parallel import local_rows, shard_train_state
    from tpureg_torch.reg import OpticalFlowReg
    from tpureg_torch.train import create_train_state, make_eval_step, make_train_step

    group = dist.group.WORLD
    imgs, before = inputs["imgs"], inputs["state_dict"]
    results, kept = {}, {}
    for name, cfg in inputs["configs"].items():
        with torch.device("meta"):
            model = OpticalFlowReg(inputs["model"])
        model.load_state_dict({k: v.clone() for k, v in before.items()}, assign=True)
        model = model.to(cfg["param_dtype"])
        state = create_train_state(model, learning_rate=cfg.get("lr", 1e-4))
        if cfg.get("fsdp"):
            shard_train_state(state, group)
        accum = cfg.get("accum_steps", 1)
        train = make_train_step(state, compute_dtype=cfg.get("compute_dtype"),
                                accum_steps=accum, remat=cfg.get("remat"),
                                group=group)
        rows = local_rows(imgs.shape[0], world, rank, accum)
        metrics = train(imgs[rows].to(cfg["param_dtype"]))
        shares = _shares(state)
        sd, moments = _state_after(state)
        evaluate = make_eval_step(model, compute_dtype=cfg.get("compute_dtype"),
                                  group=group, shards=state.shards)
        eval_rows = local_rows(imgs.shape[0], world, rank)
        _, eval_metrics = evaluate(imgs[eval_rows].to(cfg["param_dtype"]))
        out = {"metrics": {k: float(v) for k, v in metrics.items()},
               "eval": {k: float(v) for k, v in eval_metrics.items()},
               "step": state.step, "shares": shares,
               "from_rank0": _from_rank0(sd, group)}
        if rank == 0:
            out["update"] = {k: (v.double() - before[k].double()).float()
                             for k, v in sd.items() if v.is_floating_point()
                             and not k.endswith(STATS)}
            out["stats"] = {k: v for k, v in sd.items() if k.endswith(STATS)}
        if "same_as" in cfg:
            base_sd, base_moments = kept.pop(cfg["same_as"])
            out["same_as"] = (_max_diff(sd, base_sd),
                              max(_max_diff(moments[p], base_moments[p])
                                  for p in base_moments))
        if name in {c.get("same_as") for c in inputs["configs"].values()}:
            kept = {name: (sd, moments)}
        del sd, moments
        results[name] = out
    return results


STATS = ("running_mean", "running_var", "num_batches_tracked")


@contextlib.contextmanager
def recording(cli_train):
    """Record the training CLI's steps for the duration: yields
    ``{"train": [...], "eval": [...]}``, an entry for each step function
    the CLI makes (``replicated``, whether a ``group`` was given, and, for
    each call, the batch passed and the metrics returned)."""
    calls = {"train": [], "eval": []}
    makers = {"train": cli_train.make_train_step, "eval": cli_train.make_eval_step}

    def recorded(kind):
        def make(*args, **kwargs):
            fn = makers[kind](*args, **kwargs)
            entry = {"replicated": kwargs.get("replicated"),
                     "group": kwargs.get("group") is not None,
                     "batches": [], "metrics": []}
            calls[kind].append(entry)

            def step(imgs, *rest):
                out = fn(imgs, *rest)
                metrics = out if kind == "train" else out[1]
                entry["batches"].append(imgs.clone())
                entry["metrics"].append({k: float(v) for k, v in metrics.items()})
                return out
            return step
        return make

    cli_train.make_train_step = recorded("train")
    cli_train.make_eval_step = recorded("eval")
    try:
        yield calls
    finally:
        cli_train.make_train_step = makers["train"]
        cli_train.make_eval_step = makers["eval"]


def cli(inputs, rank, world):
    import tpureg_torch.train.checkpoint as checkpoint
    import tpureg_torch.utils.tb as tb
    from tpureg_torch.cli import train as cli_train

    written, writers = [], []
    save = checkpoint._save

    def record(path, payload):
        written.append(path)
        save(path, payload)

    def make_writer(logdir, flush_secs):
        # no TensorBoard backend is loaded (TensorFlow takes 10-17 s here);
        # only the writer's creation is recorded
        writers.append(logdir)
        return None

    checkpoint._save = record
    tb._make_writer = make_writer
    results = {}
    for name, argv in inputs["runs"].items():
        del written[:], writers[:]
        # the first run joins the group through the CLI's torchrun branch
        with recording(cli_train) as calls:
            state = cli_train.main(argv, device="cpu")
        sd, moments = _state_after(state)
        results[name] = {"step": state.step, "shares": _shares(state),
                         "from_rank0": _from_rank0(sd, dist.group.WORLD),
                         "state_dict": sd if rank == 0 else None,
                         "moments": moments if rank == 0 else None,
                         "written": list(written), "writers": list(writers),
                         "calls": calls}
        del state, sd, moments
    return results


CASES = {"bn_loss": bn_loss, "step": step, "cli": cli}


def main():
    from tpureg_torch.parallel import init_from_env

    case, folder = sys.argv[1:3]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(1)
    if case != "cli":
        init_from_env("cpu")
    try:
        inputs = torch.load(f"{folder}/inputs.pt", weights_only=False)
        out = CASES[case](inputs, rank, world)
        torch.save(out, f"{folder}/rank{rank}.pt")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
