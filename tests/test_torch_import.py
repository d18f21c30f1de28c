"""The port's torch checkpoint import (``tpureg_torch/compat/torch_import.py``)
and the training CLI's ``--pretrained``/``--surgery`` against tpureg's
import on the CPU.

tpureg's ``export_to_torch_checkpoint`` writes a file in the reference's key
names from one numpy-filled parameter tree; tpureg's
``import_torch_state_dict`` and the port's then load it into the same
starting weights (another numpy-filled tree, bridged into the port by
``state_dict_from_jax``). The loaded weights must be equal bit for bit (the
import copies, both sides in fp32), and the reports equal key for key
(``loaded``, ``missing``) and in count (``shape_mismatch``, whose messages
give each package's own layout). Weights come from ``jax.eval_shape`` and
numpy, not from an XLA init. The files (up to 150 MB) are deleted when
each test ends (``work_path``).
"""

import os

import numpy as np
import pytest
import torch

from test_torch_cli import one_torch_thread, tb_records, work_path  # noqa: F401 (fixtures)
from test_torch_zoo import numpy_variables, port_head
from tpureg.compat.torch_export import export_to_torch_checkpoint
from tpureg.compat.torch_import import import_torch_state_dict as jax_import
from tpureg.compat.torch_import import load_torch_checkpoint as jax_load
from tpureg.reg import OpticalFlowReg as JaxOpticalFlowReg
from tpureg_torch.compat import (
    collapse_rgb_input,
    collapse_rgb_pair_input,
    import_torch_state_dict,
    load_torch_checkpoint,
    state_dict_from_jax,
)

SIZE = 64
STEMS = ("conv1.0.weight", "conv1a.0.weight")


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def variables(name, seed):
    return numpy_variables(JaxOpticalFlowReg(conv_predictor=name),
                           np.zeros((1, SIZE, SIZE, 2), np.float32), seed)


def write_checkpoint(path, name, seed, edit=None):
    """A torch checkpoint of ``name``'s predictor, written by tpureg's
    exporter from a numpy-filled tree; ``edit(sd)`` changes its state dict
    before it is saved again."""
    params, stats = variables(name, seed)
    keys = port_head(name, (params, stats)).predictor.state_dict().keys()
    report = export_to_torch_checkpoint(params["predictor"], keys, str(path),
                                        batch_stats=stats.get("predictor"))
    assert not report["missing"]
    if edit is not None:
        sd = torch.load(path, weights_only=False)["state_dict"]
        torch.save({"state_dict": edit(sd)}, path)
    return str(path)


def import_both(path, name, surgery=None):
    """(tpureg's report, the port's report, tpureg's imported weights as the
    port's state dict, the port's state dict after its import), both from
    the same starting weights."""
    params, stats = variables(name, 11)
    jp, js, jreport = jax_import(jax_load(path), params, stats, surgery=surgery,
                                 prefix=("predictor",))
    model = port_head(name, (params, stats))
    report = import_torch_state_dict(load_torch_checkpoint(path), model,
                                     surgery=surgery, prefix="predictor.")
    return jreport, report, state_dict_from_jax(jp, js), model.predictor.state_dict()


def assert_same_import(jreport, report, want, got):
    assert report["loaded"] == jreport["loaded"]
    assert report["missing"] == jreport["missing"]
    assert len(report["shape_mismatch"]) == len(jreport["shape_mismatch"])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ["flownets", "pwc-reg"])
def test_whole_checkpoint_loads_as_tpureg_loads_it(work_path, name):  # noqa: F811
    path = write_checkpoint(work_path / "w.pt", name, 5)
    jreport, report, want, got = import_both(path, name)
    assert_same_import(jreport, report, want, got)
    assert not report["missing"] and not report["shape_mismatch"]
    # every tensor but the update counts, which tpureg's tree does not hold
    assert len(report["loaded"]) == sum(not k.endswith("num_batches_tracked")
                                        for k in got)
    sd = load_torch_checkpoint(path)
    for k in report["loaded"]:
        assert torch.equal(got[k], sd[k]), k


@pytest.mark.parametrize("rekey", ["as_is", "under_flownetc"])
def test_partial_checkpoint_into_flownet2(work_path, rekey):  # noqa: F811
    """FlowNetC's keys into FlowNet2: as written, none names a tensor of
    FlowNet2 (its FlowNetC sits under ``flownetc.``); re-keyed under
    ``flownetc.``, they load where the shapes agree, and one tensor of a
    wrong shape is reported, not loaded."""
    def edit(sd):
        if rekey == "as_is":
            return sd
        sd = {f"flownetc.{k}": v for k, v in sd.items()}
        sd["flownetc.conv_redir.0.weight"] = torch.zeros(32, 256, 3, 3)
        return sd

    path = write_checkpoint(work_path / "c.pt", "flownetc", 6, edit)
    jreport, report, want, got = import_both(path, "flownet2")
    assert_same_import(jreport, report, want, got)
    if rekey == "as_is":
        assert not report["loaded"] and report["missing"]
    else:
        assert len(report["loaded"]) > 50 and not report["missing"]
        assert len(report["shape_mismatch"]) == 1


@pytest.mark.parametrize("stem_channels", [3, 6])
@pytest.mark.parametrize("op", ["rgb", "rgb_pair"])
@pytest.mark.parametrize("name", ["flownets", "pwc-reg"])
def test_surgery_matches_tpureg(work_path, name, op, stem_channels):  # noqa: F811
    """Each surgery on a stem of 3 and of 6 input channels, into FlowNetS's
    2-channel stem and PWC's 1-channel one; the surgery is asked for on
    every key the CLI asks it for, which in PWC also takes ``dc_conv1``
    (its suffix is a stem's), whose collapsed weight then does not fit."""
    rng = np.random.default_rng(stem_channels)
    stem = "conv1.0.weight" if name == "flownets" else "conv1a.0.weight"

    def widen(sd):
        o, _, kh, kw = sd[stem].shape
        sd[stem] = torch.from_numpy(
            rng.standard_normal((o, stem_channels, kh, kw), np.float32))
        return sd

    path = write_checkpoint(work_path / "s.pt", name, 7, widen)
    surgery = {k: op for k in load_torch_checkpoint(path) if k.endswith(STEMS)}
    assert stem in surgery
    jreport, report, want, got = import_both(path, name, surgery)
    assert_same_import(jreport, report, want, got)
    target = 2 if name == "flownets" else 1
    out = 1 if op == "rgb" else 2
    assert (stem in report["loaded"]) == (out == target)


def test_collapses_sum_each_images_rgb():
    w = torch.arange(2 * 6 * 1 * 1, dtype=torch.float32).reshape(2, 6, 1, 1)
    assert collapse_rgb_input(w[:, :3]).flatten().tolist() == [3.0, 21.0]
    assert collapse_rgb_pair_input(w).flatten().tolist() == [3.0, 12.0, 21.0, 30.0]


def test_load_unwraps_the_reference_layouts(tmp_path):
    sd = {"conv1.0.weight": torch.ones(2, 1, 3, 3)}
    for i, obj in enumerate((sd, {"state_dict": sd}, {"model_state_dict": sd},
                             {"state_dict": {"model_state_dict": sd}})):
        torch.save(obj, tmp_path / f"{i}.pt")
        got = load_torch_checkpoint(str(tmp_path / f"{i}.pt"))
        assert list(got) == ["conv1.0.weight"] and torch.equal(got["conv1.0.weight"],
                                                               sd["conv1.0.weight"])


def test_train_cli_imports_a_widened_stem(work_path, capsys, tb_records):  # noqa: F811
    """``--pretrained`` with ``--surgery rgb_pair``: FlowNetS's own weights
    with its stem widened to a 6-channel pair, written by the port; at
    learning rate 0 the trained parameters are the collapsed file's."""
    from tpureg_torch.cli.train import main
    from tpureg_torch.reg import OpticalFlowReg

    sd = OpticalFlowReg("flownets", generator=torch.Generator().manual_seed(9)
                        ).predictor.state_dict()
    w = sd["conv1.0.weight"]
    wide = torch.cat([w[:, :1] / 3] * 3 + [w[:, 1:] / 3] * 3, dim=1)
    sd["conv1.0.weight"] = wide
    path = str(work_path / "wide.pt")
    torch.save({"state_dict": sd}, path)

    state = main(["--model", "flownets", "--synthetic", "1", "--image_size", "64",
                  "--batch_size", "2", "--epochs", "1", "--cp", "0", "--lrIni", "0",
                  "--pretrained", path, "--surgery", "rgb_pair",
                  "--workdir", str(work_path), "--logdir", str(work_path / "log")],
                 device="cpu")
    out = capsys.readouterr().out
    n = sum(not k.endswith("num_batches_tracked") for k in sd)
    assert f"imported {n} tensors (0 unmatched, 0 shape-mismatched)" in out
    got = dict(state.model.predictor.named_parameters())
    assert torch.allclose(got["conv1.0.weight"], collapse_rgb_pair_input(wide))
    assert torch.allclose(got["conv1.0.weight"], w, atol=1e-6)
    for k, p in got.items():
        if k != "conv1.0.weight":
            assert torch.equal(p, sd[k]), k
    assert os.path.isfile(path)
