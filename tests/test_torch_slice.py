"""The FlowNet2 registration-inference slice of tpureg_torch, whole, on the
CPU: the eval step against tpureg's, the inference CLI, and the rule that
the port imports neither JAX nor tpureg.
"""

import ast
import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_refcache import refcache  # noqa: F401 (a fixture)
from test_torch_cli import eval_tags, tb_records, work_path, one_torch_thread  # noqa: F401 (fixtures)
from tpureg.reg import OpticalFlowReg as JaxOpticalFlowReg
from tpureg.train import create_train_state
from tpureg.train import make_eval_step as jax_make_eval_step
from tpureg_torch.compat import state_dict_from_jax
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.train import make_eval_step, save_best_weights


pytestmark = pytest.mark.usefixtures("one_torch_thread")


ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZE = 64


def _random_stats(stats, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "mean":
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, stats)


def _pair_batch(seed, b, size):
    """Smooth fixed/moving images in [0, 1] and 4-label segmentations."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    imgs = np.empty((b, size, size, 2), np.float32)
    for i in range(b):
        for ch in range(2):
            cx, cy, r = rng.uniform(0.3, 0.7, 3)
            imgs[i, ..., ch] = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                                      / (0.1 + 0.1 * r))
    segs = np.floor(imgs * 3.999).astype(np.float32)
    return imgs, segs


@pytest.fixture(scope="module")
def eval_pair(refcache):  # noqa: F811
    """tpureg's and the port's eval step on one batch, same weights (once a
    session)."""
    return refcache("flownet2_eval_pair", _eval_pair)


def _eval_pair():
    imgs, segs = _pair_batch(0, 2, SIZE)
    model = JaxOpticalFlowReg(conv_predictor="flownet2")
    state = create_train_state(model, jax.random.key(0), jnp.asarray(imgs))
    params = jax.tree.map(np.asarray, jax.device_get(state.params))
    stats = _random_stats(jax.tree.map(np.asarray,
                                       jax.device_get(state.batch_stats)), 1)
    state = state.replace(batch_stats=jax.tree.map(jnp.asarray, stats))
    want = jax_make_eval_step()(state, jnp.asarray(imgs), jnp.asarray(segs))

    port = OpticalFlowReg("flownet2")
    port.predictor.load_state_dict(state_dict_from_jax(params, stats),
                                   strict=True)
    got = make_eval_step(port)(torch.from_numpy(imgs), torch.from_numpy(segs))
    with torch.inference_mode():
        fwd = port(torch.from_numpy(imgs), torch.from_numpy(segs))
    return got, want, fwd


def test_eval_step_flows_and_images_match_tpureg(eval_pair):
    (flows, warped, _, grid), _ = eval_pair[0]
    (jflows, jwarped, _, jgrid), _ = eval_pair[1]
    assert len(flows) == len(jflows) == 2
    assert flows[0] is flows[1]  # the fused flow, returned twice
    # The cascade carries fp32 accumulation-order noise (XLA:CPU vs MKL
    # convolutions) through five subnets and four warps. Measured on this
    # input: flows 1.6e-5 abs at a scale of 17 px, warped image 3.5e-6,
    # warped grid 1.5e-5. The bounds below sit 6-15x above that; a wrong
    # layer or warp convention gives errors of order the values themselves.
    for f, jf in zip(flows, jflows):
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=2e-4,
                                   rtol=1e-4)
    for w, jw in zip(warped, jwarped):
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=5e-5,
                                   rtol=0)
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), atol=1e-4,
                               rtol=0)


def test_forward_keeps_tpureg_layout(eval_pair):
    """OpticalFlowReg.forward takes and gives channels-last tensors, the
    eval step's outputs, the fused flow still one object."""
    (flows, warped, segs, grid), _ = eval_pair[0]
    fflows, fwarped, fsegs, fgrid = eval_pair[2]
    assert fflows[0].shape == (2, SIZE, SIZE, 2) and fflows[0] is fflows[1]
    for a, b in zip((*flows, *warped, segs, grid),
                    (*fflows, *fwarped, fsegs, fgrid)):
        assert torch.equal(a, b)


def test_eval_step_segs_match_tpureg(eval_pair):
    (_, _, segs, _), _ = eval_pair[0]
    (_, _, jsegs, _), _ = eval_pair[1]
    segs, jsegs = segs.numpy(), np.asarray(jsegs)
    assert segs.shape == jsegs.shape == (2, SIZE, SIZE, 1)
    assert set(np.unique(segs)) <= {0.0, 1.0, 2.0, 3.0}
    # a warped label within float noise of a .5 rounding boundary may round
    # the other way: allow 0.1% of the 8192 pixels (8) to flip, by one label
    diff = np.abs(segs - jsegs)
    assert diff.max() <= 1.0
    assert np.count_nonzero(diff) <= 8


def test_eval_step_losses_match_tpureg(eval_pair):
    _, metrics = eval_pair[0]
    _, jmetrics = eval_pair[1]
    for k in ("loss", "photo_loss", "corr_loss", "smooth_loss"):
        assert metrics[k].dtype == torch.float32
        # fp32 sums over every pixel of every scale, in another order
        # (measured: 2e-7 to 8e-7 relative)
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the inference CLI

def write_analyze(path_base, vol, datatype=4):
    """Write a minimal little-endian Analyze 7.5 pair (.hdr/.img)."""
    np_dtype = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32}[datatype]
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = (len(vol.shape),) + vol.shape + (1,) * (7 - len(vol.shape))
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, datatype)
    struct.pack_into("<h", hdr, 72, np_dtype().itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 0, 1, 1, 1, 1, 0, 0, 0)
    with open(path_base + ".hdr", "wb") as f:
        f.write(hdr)
    vol.astype(np_dtype).ravel(order="F").tofile(path_base + ".img")


def _phantom(rng, shape=(40, 48, 142)):
    """An ellipsoid 'head' with 3 nested tissue labels, long in z so that
    every slice of the pipeline's crop holds all three."""
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n) for n in shape),
                          indexing="ij")
    c = rng.uniform(-0.1, 0.1, 2)
    r = np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z / 2.5) ** 2)
    seg = np.select([r < 0.3, r < 0.55, r < 0.8], [3, 2, 1], 0)
    img = seg * 200 + rng.normal(0, 10, shape)
    return img.astype(np.int16), seg.astype(np.int16)


def test_inference_cli_runs_on_cpu(work_path, capsys, tb_records):  # noqa: F811
    from tpureg_torch.cli.inference import main

    rng = np.random.default_rng(0)
    dirs = {}
    for name in ("fiximg", "fixseg", "movimg", "movseg"):
        dirs[name] = work_path / name
        dirs[name].mkdir()
    for kind, n in (("fix", 1), ("mov", 2)):
        for i in range(n):
            img, seg = _phantom(rng)
            write_analyze(str(dirs[f"{kind}img"] / f"{kind}{i}_mpr"), img)
            write_analyze(str(dirs[f"{kind}seg"] / f"{kind}{i}_seg"), seg)
    model = OpticalFlowReg("flownet2",
                           generator=torch.Generator().manual_seed(0))
    save_best_weights(str(work_path), "FlowNet2", model, {"loss": 1.0})

    results = main([
        "--mode", "real", "--model", "flownet2", "--batch_size", "1",
        "--fiximg_dir", str(dirs["fiximg"]), "--fixseg_dir", str(dirs["fixseg"]),
        "--movimg_dir", str(dirs["movimg"]), "--movseg_dir", str(dirs["movseg"]),
        "--workdir", str(work_path), "--logdir", str(work_path / "log"),
        "--max_samples", "2",
    ], device="cpu")
    out = capsys.readouterr().out
    assert "[EVAL batch 001/160]" in out and "===> EVAL summary" in out
    for key in ("loss", "photo_loss", "corr_loss", "smooth_loss", "dice",
                "mse", "psnr", "hausdorff", "ssim_img", "ssim_seg", "mi",
                "corr", "mag", "neg_jac", "log_jac_std"):
        assert key in results and np.isfinite(results[key]), key
    (w,) = tb_records
    assert w.closed and w.tags() == eval_tags() and w.logdir == str(work_path / "log")


def test_entry_points_refuse_a_missing_card(monkeypatch):
    from tpureg_torch.cli.inference import main
    from tpureg_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--mode", "real"])
    assert resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# the port imports neither JAX nor tpureg

# the root scripts that run on the card
ROOT_SCRIPTS = ("chip_smoke.py", "ab_warp2d.py", "ab_warp2d_dpos.py", "ab_warp3d_dvol.py",
                "ab_correlation.py", "torch_quality_real.py", "torch_quality3d.py",
                "torch_quality_phantom.py")
# the one exception: the converter of tpureg's checkpoints runs where JAX is
# and imports tpureg (tests/test_torch_convert.py); nothing of the port and
# no script above imports it
JAX_SIDE_SCRIPTS = ("convert_checkpoint.py",)


def _port_sources():
    files = sorted((ROOT / "tpureg_torch").rglob("*.py"))
    return files + [ROOT / name for name in ROOT_SCRIPTS]


def test_port_imports_load_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (ROOT / "tpureg_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import runpy\n"
        f"for f in {ROOT_SCRIPTS!r}: runpy.run_path(f, run_name=f[:-3])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tpureg'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_has_no_jax_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative, inside the port
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax",
                               "tpureg"), f"{path}: imports {name}"


def test_no_jax_checks_cover_the_parallel_package():
    """The checks above import and parse every module of
    ``tpureg_torch/parallel/`` (process groups, tpureg's sharding rules,
    FSDP); the rank program of the CPU tests' gloo runs, which imports the
    port in processes of its own, imports no JAX either."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {"tpureg_torch/parallel/__init__.py", "tpureg_torch/parallel/mesh.py",
            "tpureg_torch/parallel/fsdp.py"} <= names
    test_port_source_has_no_jax_import(ROOT / "tests" / "torch_parallel_worker.py")


def test_every_root_script_of_the_port_is_named():
    """A root script that uses the port is a card-side script (no JAX) or
    the converter, and no card-side script names the converter."""
    uses_port = sorted(p.name for p in ROOT.glob("*.py")
                       if "tpureg_torch" in p.read_text())
    assert uses_port == sorted(ROOT_SCRIPTS + JAX_SIDE_SCRIPTS)
    for path in _port_sources():
        assert "convert_checkpoint" not in path.read_text(), path
