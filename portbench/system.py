"""The system under test, ``tpureg_torch``, as the benchmark drives it: the
registration head built from the registry on the meta device and given
the benchmark's weights, and the CLI's own train and eval steps. Nothing
else of the benchmark imports the program."""

from __future__ import annotations

from functools import partial

import torch


# the precisions the benchmark runs the program in
PRECISIONS = ("fp32",)


def check_precision(config) -> None:
    """Refuse a configuration whose precision the benchmark does not run:
    the program's fp32 steps set TF32 off themselves."""
    if config["precision"] not in PRECISIONS:
        raise ValueError(f"precision {config['precision']!r} of {config['name']}: "
                         f"the benchmark runs the program in {PRECISIONS} only")


def build_head(config, state_dict):
    """``OpticalFlowReg(config["model"])`` holding ``state_dict`` (the
    predictor's keys) on the state dict's device."""
    from tpureg_torch.reg.head import OpticalFlowReg

    check_precision(config)
    with torch.device("meta"):
        head = OpticalFlowReg(config["model"], use_bn=config["use_bn"],
                              num_seg_labels=config["labels"])
    head.predictor.load_state_dict(state_dict, strict=True, assign=True)
    left = [n for n, t in [*head.named_parameters(), *head.named_buffers()]
            if t.is_meta]
    if left:
        raise RuntimeError(f"the weights left {left[:3]} on the meta device")
    return head


def train_step(config, traffic, head):
    """(state, step): tpureg_torch's train state around ``head`` and the
    training CLI's step on ``(seed, flat_img, idx)`` specs, the elastic
    synthesis inside it."""
    from tpureg_torch.data.pipeline import synth_image_batch
    from tpureg_torch.train import create_train_state, default_loss_kwargs, make_train_step

    state = create_train_state(head, learning_rate=traffic["learning_rate"],
                               adam_eps=traffic["adam_eps"])
    synth = partial(synth_image_batch, size=traffic["image_size"],
                    magnitude=tuple(traffic["magnitude"]))
    step = make_train_step(state, loss_kwargs=default_loss_kwargs(config["model"]),
                           synth=synth)
    return state, step


def eval_step(config, head):
    """The inference CLI's eval step: ``step(imgs, segs) -> (outputs, metrics)``."""
    from tpureg_torch.train import default_loss_kwargs, make_eval_step

    return make_eval_step(head, loss_kwargs=default_loss_kwargs(config["model"]))
