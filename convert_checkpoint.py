"""Convert tpureg's orbax checkpoints into the PyTorch port's ``.pt`` files.

    python convert_checkpoint.py --model flownets --workdir runs/tpu --out runs/gpu

Reads what tpureg's training CLI writes under ``--workdir``
(tpureg/train/checkpoint.py): the best weights,
``model_weight/Unsupervised/<Predictor>/best_weight``, and the training
state, ``Checkpoints/Unsupervised/<Predictor>/training_state`` (weights,
BatchNorm statistics, Adam's moments and count, the step, the epoch and
the best loss), whichever exist. Writes the port's files of the same
layout under ``--out`` (tpureg_torch/train/checkpoint.py):
``best_weight.pt``, which the port's inference and export CLIs load, and
``training_state.pt``, from which the port's training CLI resumes with
``--cp 1``. Weights cross through ``tpureg_torch.compat.from_jax``
(``state_dict_from_jax``; ``state_dict_from_jax_raft`` for raft and
raft-reg) and Adam's moments through ``load_adam_state_from_jax``.

This script runs where JAX and orbax are installed: it imports tpureg. The
port and ``chip_smoke.py`` never import it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

__all__ = ["convert", "main"]


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _adam_state(opt_state):
    """optax's ScaleByAdamState (``count``, ``mu``, ``nu``) in an opt_state
    restored without a target (lists and dicts)."""
    if isinstance(opt_state, dict):
        if {"count", "mu", "nu"} <= set(opt_state):
            return opt_state
        opt_state = list(opt_state.values())
    for part in opt_state if isinstance(opt_state, (list, tuple)) else ():
        found = _adam_state(part)
        if found is not None:
            return found
    return None


def convert(model_name: str, workdir: str, out: str) -> list:
    """Convert the tpureg checkpoints of ``model_name`` under ``workdir`` into
    the port's under ``out``; returns the paths written."""
    from tpureg.models import build_predictor as jax_build_predictor
    from tpureg.train.checkpoint import (
        _restore,
        best_weight_dir,
        training_state_dir,
    )
    from tpureg_torch.compat import (
        load_adam_state_from_jax,
        state_dict_from_jax,
        state_dict_from_jax_raft,
    )
    from tpureg_torch.models import RAFT
    from tpureg_torch.reg import OpticalFlowReg
    from tpureg_torch.train import (
        create_train_state,
        save_best_weights,
        save_training_state,
    )

    jax_name = type(jax_build_predictor(model_name)).__name__
    model = OpticalFlowReg(conv_predictor=model_name)
    port_name = type(model.predictor).__name__
    raft = isinstance(model.predictor, RAFT)

    def load_weights(tree):
        params = _numpy_tree(tree["params"])
        if raft:
            sd = state_dict_from_jax_raft(params)
        else:
            sd = state_dict_from_jax(params, _numpy_tree(tree.get("batch_stats") or {}))
        model.predictor.load_state_dict(sd, strict=True)

    written = []
    path = best_weight_dir(workdir, jax_name)
    if os.path.exists(path):
        tree = _restore(path, None)
        load_weights(tree)
        written.append(save_best_weights(
            out, port_name, model, {k: float(v) for k, v in
                                    (tree.get("metrics") or {}).items()}))
    path = training_state_dir(workdir, jax_name)
    if os.path.exists(path):
        tree = _restore(path, None)
        load_weights(tree)
        state = create_train_state(model)
        adam = _adam_state(tree["opt_state"])
        if adam is None:
            raise ValueError(f"{path}: no Adam state (count, mu, nu) in opt_state")
        load_adam_state_from_jax(state.optimizer, model, np.asarray(adam["count"]),
                                 _numpy_tree(adam["mu"]), _numpy_tree(adam["nu"]),
                                 raft=raft)
        state.step = int(np.asarray(tree["step"]))
        written.append(save_training_state(
            out, port_name, state, int(np.asarray(tree["epoch"])),
            float(np.asarray(tree["best_loss"]))))
    if not written:
        raise FileNotFoundError(f"no tpureg checkpoint of {jax_name} under "
                                f"{os.path.abspath(workdir)}")
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="tpureg orbax checkpoints -> "
                                            "tpureg_torch .pt files")
    p.add_argument("--model", default="flownets")
    p.add_argument("--workdir", required=True,
                   help="tpureg training workdir (model_weight/, Checkpoints/)")
    p.add_argument("--out", required=True, help="the port's workdir to write")
    args = p.parse_args(argv)
    for path in convert(args.model, args.workdir, args.out):
        print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
