"""The port's classical comparator against tpureg's (``tpureg.classical``):
the Gaussian blurs, local NCC, scaling and squaring, the warps, the level
loss's gradient, one Adam-plus-blur iteration, whole coarse-to-fine
registrations in 2-D and 3-D, and the comparator CLI, on the same numpy
inputs, on the CPU. Layouts: tpureg NHWC / NDHWC, the port NCHW / NCDHW.

Tolerances. The pieces are fp32 computations of the same formulas in the
same order except for the matrix products' sums, so they agree to a few
fp32 roundings. Adam with eps 1e-8 moves every pixel by about lr · g / |g|
whatever |g| is, so a rounding in a small gradient becomes a change of up
to lr before the blur; a whole registration is therefore held with a
tolerance about ten times what was measured on the CPU (2-D (3, 2, 0) at
32²: flow 1.9e-3 px of 5.8 px, warped image 4.3e-4; 3-D (3, 0) at
16 x 32 x 32: flow 5.3e-5 px of 3.7 px, warped 2.5e-5; the tolerances,
2e-2 and 5e-3 in 2-D, 4e-2 and 1e-2 in 3-D, also cover the masked 3-D
(2, 2) run, 3.9e-3 and 8.9e-4), and the local NCC it reaches must agree
to 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpureg.utils.tb as jax_tb
from test_torch_cli import RecordingWriter, tb_records, one_torch_thread  # noqa: F401 (fixtures)
from test_torch_elastic import write_analyze
from tpureg.classical import syn as jsyn
from tpureg.classical import syn3d as jsyn3d
from tpureg.ops.elastic import rand_elastic_2d
from tpureg.ops.warp import warp3d as jwarp3d
from tpureg_torch.classical import syn as tsyn
from tpureg_torch.classical import syn3d as tsyn3d


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _torch(x):
    """Channels-last numpy → channels-first torch."""
    return torch.from_numpy(np.array(np.moveaxis(x, -1, 1)))


def _numpy(t):
    """Channels-first torch → channels-last numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _jax_or_none(x):
    return None if x is None else jnp.asarray(x)


def _torch_or_none(x):
    return None if x is None else _torch(x)


def _phantoms(size, b, seed):
    """[b, size, size, 1] nested blobs (three intensities), each centre
    jittered by a few pixels."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    out = []
    for _ in range(b):
        cy, cx = size / 2 + rng.uniform(-2, 2, 2)
        r = np.sqrt((ys - cy) ** 2 + (xs - cx) ** 2)
        out.append((r < size * 0.42) * 0.3 + (r < size * 0.3) * 0.3
                   + (np.sqrt((ys - cy * 0.8) ** 2 + (xs - cx) ** 2)
                      < size * 0.12) * 0.4)
    return np.stack(out)[..., None].astype(np.float32)


def _smooth(shape, amp, seed, factor=4):
    """A smooth random field: N(0, amp²) on a grid ``factor`` times coarser
    in every spatial axis of channels-last ``shape``, repeated up and then
    box-averaged over ``factor`` along each axis."""
    rng = np.random.default_rng(seed)
    spatial = shape[1:-1]
    x = rng.standard_normal((shape[0], *(n // factor for n in spatial),
                             shape[-1])) * amp
    for ax in range(1, 1 + len(spatial)):
        x = np.repeat(x, factor, axis=ax)
        k = np.ones(factor) / factor
        x = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), ax, x)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def pair2d():
    """fixed, moving [2, 32, 32, 1] and the mask fixed > 0."""
    fixed = _phantoms(32, 2, seed=0)
    moving = _phantoms(32, 2, seed=1)
    return fixed, moving, (fixed > 0).astype(np.float32)


@pytest.fixture(scope="module")
def pair3d():
    """fixed [1, 16, 32, 32, 1], moving = fixed warped by a smooth field of
    about 1.5 voxels (by tpureg's warp3d), and a mask."""
    fixed = np.clip(_smooth((1, 16, 32, 32, 1), 1.0, seed=2) * 0.5 + 0.5,
                    0, 1).astype(np.float32)
    u = _smooth((1, 16, 32, 32, 3), 1.5, seed=3)
    moving = np.asarray(jwarp3d(jnp.asarray(fixed), jnp.asarray(u)))
    return fixed, moving, (fixed > 0.5).astype(np.float32)


# ---------------------------------------------------------------------------
# the pieces

@pytest.mark.parametrize("sigma", [1.5, 4.0])
def test_gaussian_blur_matches_tpureg(sigma):
    x = np.random.default_rng(4).random((2, 24, 40, 2)).astype(np.float32)
    want = np.asarray(jsyn.gaussian_blur(jnp.asarray(x), sigma))
    got = _numpy(tsyn.gaussian_blur(_torch(x), sigma))
    # fp32 products of the same matrices, summed in another order
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("sigma", [1.5, 4.0])
def test_gaussian_blur3d_matches_tpureg(sigma):
    x = np.random.default_rng(5).random((1, 12, 16, 20, 3)).astype(np.float32)
    want = np.asarray(jsyn3d.gaussian_blur3d(jnp.asarray(x), sigma))
    got = _numpy(tsyn3d.gaussian_blur3d(_torch(x), sigma))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["no mask", "mask"])
def test_local_ncc_matches_tpureg(pair2d, masked):
    fixed, moving, mask = pair2d
    mask = mask if masked else None
    want = float(jsyn.local_ncc(jnp.asarray(fixed), jnp.asarray(moving),
                                _jax_or_none(mask)))
    got = float(tsyn.local_ncc(_torch(fixed), _torch(moving), _torch_or_none(mask)))
    # a mean of fp32 ratios of blurred moments (measured 4e-7)
    assert abs(got - want) <= 1e-5, (got, want)


@pytest.mark.parametrize("masked", [False, True], ids=["no mask", "mask"])
def test_local_ncc3d_matches_tpureg(pair3d, masked):
    fixed, moving, mask = pair3d
    mask = mask if masked else None
    want = float(jsyn3d.local_ncc3d(jnp.asarray(fixed), jnp.asarray(moving),
                                    _jax_or_none(mask)))
    got = float(tsyn3d.local_ncc3d(_torch(fixed), _torch(moving),
                                   _torch_or_none(mask)))
    assert 0.1 < want < 0.99
    assert abs(got - want) <= 1e-5, (got, want)


def test_exp_velocity_matches_tpureg():
    v = _smooth((2, 32, 32, 2), 8.0, seed=6)
    want = np.asarray(jsyn.exp_velocity(jnp.asarray(v)))
    got = _numpy(tsyn.exp_velocity(_torch(v)))
    assert np.abs(want).max() > 1.0
    # six compositions through the same 4-tap gather (measured exact)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_apply_flow_matches_tpureg(pair2d, mode):
    fixed = pair2d[0]
    img = (np.random.default_rng(7).integers(0, 4, fixed.shape).astype(np.float32)
           if mode == "nearest" else fixed)
    flow = _smooth((2, 32, 32, 2), 6.0, seed=8)
    want = np.asarray(jsyn.apply_flow(jnp.asarray(img), jnp.asarray(flow), mode))
    got = _numpy(tsyn.apply_flow(_torch(img), _torch(flow), mode))
    if mode == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["no mask", "mask"])
def test_level_loss_gradient_matches_jax_grad(pair2d, masked):
    """The gradient _optimize_level descends: −local NCC of the moving image
    warped by exp(v), with respect to v."""
    fixed, moving, mask = pair2d
    mask = mask if masked else None
    v = _smooth((2, 32, 32, 2), 3.0, seed=9)

    def jloss(vv):
        warped = jsyn.apply_flow(jnp.asarray(moving), jsyn.exp_velocity(vv))
        return -jsyn.local_ncc(jnp.asarray(fixed), warped, _jax_or_none(mask), 4.0)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(v)))
    vt = _torch(v).requires_grad_()
    loss = -tsyn.local_ncc(_torch(fixed),
                           tsyn.apply_flow(_torch(moving), tsyn.exp_velocity(vt)),
                           _torch_or_none(mask), 4.0)
    (got,) = torch.autograd.grad(loss, vt)
    # the same chain through the gather and the products (measured 3.4e-9
    # of max |g| 3.2e-3)
    np.testing.assert_allclose(_numpy(got), want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


def test_adam_descent_equals_optax_adam():
    """The port's Adam on one tensor against optax.adam(lr) with its
    defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias-corrected), with
    a smoothing applied after every update and the moments left alone."""
    rng = np.random.default_rng(10)
    target = rng.standard_normal((1, 2, 8, 8)).astype(np.float32)
    scale = np.linspace(0.5, 3.0, 128).reshape(target.shape).astype(np.float32)
    v0 = np.zeros_like(target)

    def jloss(v):
        return jnp.sum(jnp.asarray(scale) * (v - jnp.asarray(target)) ** 2)

    opt = optax.adam(0.3)
    v, state = jnp.asarray(v0), opt.init(jnp.asarray(v0))
    want_losses = []
    for _ in range(4):
        loss, g = jax.value_and_grad(jloss)(v)
        updates, state = opt.update(g, state)
        v = optax.apply_updates(v, updates) * 0.9
        want_losses.append(float(loss))
    got, losses = tsyn.adam_descent(
        torch.from_numpy(v0),
        lambda x: torch.sum(torch.from_numpy(scale)
                            * (x - torch.from_numpy(target)) ** 2),
        lambda x: x * 0.9, 4, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(v), atol=1e-6, rtol=0)
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-6)


def test_one_iteration_matches_optimize_level(pair2d):
    """One Adam step and blur of a level against tpureg's _optimize_level
    with iterations=1, from a smooth velocity, masked."""
    fixed, moving, mask = pair2d
    v0 = _smooth((2, 32, 32, 2), 1.0, seed=11)
    want, wloss = jsyn._optimize_level(
        jnp.asarray(fixed), jnp.asarray(moving), jnp.asarray(mask),
        jnp.asarray(v0), 1, 1.5, 4.0, 2.0, 6)
    got, loss = tsyn._optimize_level(_torch(fixed), _torch(moving), _torch(mask),
                                     _torch(v0), 1, 1.5, 4.0, 2.0, 6)
    assert abs(float(loss[0]) - float(wloss[0])) <= 1e-5
    # Adam moves each pixel by about lr = 2 px whatever |g| is, so a
    # gradient within rounding of zero may step either way; after the blur
    # that shows as up to 6.6e-3 px at a few pixels (measured; median
    # 6.2e-6, mean 1.7e-4): at most 2.5% of a step anywhere, 1e-3 px on
    # average
    diff = np.abs(_numpy(got) - np.asarray(want))
    assert diff.max() <= 5e-2 and diff.mean() <= 1e-3, (diff.max(), diff.mean())


# ---------------------------------------------------------------------------
# whole registrations

def test_register_syn_matches_tpureg(pair2d):
    """(3, 2, 0) at 32²: 3 iterations at 8², the velocity upsampled and
    doubled, 2 at 16², upsampled again; masked as the CLI masks."""
    fixed, moving, mask = pair2d
    wflow, wwarped = jsyn.register_syn(jnp.asarray(fixed), jnp.asarray(moving),
                                       jnp.asarray(mask), (3, 2, 0))
    flow, warped = tsyn.register_syn(_torch(fixed), _torch(moving), _torch(mask),
                                     (3, 2, 0))
    assert flow.shape == (2, 2, 32, 32) and warped.shape == (2, 1, 32, 32)
    assert flow.grad_fn is None and not flow.requires_grad
    wflow = np.asarray(wflow)
    assert np.abs(wflow).max() > 2.0
    np.testing.assert_allclose(_numpy(flow), wflow, atol=2e-2, rtol=0)
    np.testing.assert_allclose(_numpy(warped), np.asarray(wwarped), atol=5e-3, rtol=0)
    before = float(tsyn.local_ncc(_torch(fixed), _torch(moving)))
    after = float(tsyn.local_ncc(_torch(fixed), warped))
    want_after = float(jsyn.local_ncc(jnp.asarray(fixed), wwarped))
    assert after > before + 0.05, (before, after)
    assert abs(after - want_after) <= 1e-4, (after, want_after)


def test_register_syn3d_matches_tpureg(pair3d):
    """(3, 0) at 16 x 32 x 32: 3 iterations at half resolution, then the
    velocity upsampled and doubled (the scale of dimension D) and
    exponentiated at full resolution; masked."""
    fixed, moving, mask = pair3d
    wflow, wwarped = jsyn3d.register_syn3d(jnp.asarray(fixed), jnp.asarray(moving),
                                           jnp.asarray(mask), (3, 0))
    flow, warped = tsyn3d.register_syn3d(_torch(fixed), _torch(moving),
                                         _torch(mask), (3, 0))
    assert flow.shape == (1, 3, 16, 32, 32) and flow.grad_fn is None
    wflow = np.asarray(wflow)
    assert np.abs(wflow).max() > 1.0
    np.testing.assert_allclose(_numpy(flow), wflow, atol=4e-2, rtol=0)
    np.testing.assert_allclose(_numpy(warped), np.asarray(wwarped), atol=1e-2, rtol=0)
    before = float(tsyn3d.local_ncc3d(_torch(fixed), _torch(moving)))
    after = float(tsyn3d.local_ncc3d(_torch(fixed), warped))
    want_after = float(jsyn3d.local_ncc3d(jnp.asarray(fixed), wwarped))
    assert after > before + 0.05, (before, after)
    assert abs(after - want_after) <= 1e-4, (after, want_after)


def test_register_recovers_elastic_deformation():
    """tests/test_classical.py's behaviour test, on the port: the same
    phantom and elastic moving image, the same thresholds."""
    size = 64
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    cy = cx = size / 2
    r = np.sqrt((ys - cy) ** 2 + (xs - cx) ** 2)
    img = ((r < size * 0.42) * 0.3 + (r < size * 0.3) * 0.3
           + (np.sqrt((ys - cy * 0.8) ** 2 + (xs - cx) ** 2) < size * 0.12) * 0.4)
    fixed_np = img[None, ..., None].astype(np.float32)
    moving_np, _ = rand_elastic_2d(jax.random.key(3), jnp.asarray(fixed_np),
                                   magnitude_range=(0.8, 0.8), spacing=(16, 16))
    fixed, moving = _torch(fixed_np), _torch(np.asarray(moving_np))
    before = float(tsyn.local_ncc(fixed, moving, sigma=4.0))
    _, warped = tsyn.register_syn(fixed, moving, reg_iterations=(50, 50, 50))
    after = float(tsyn.local_ncc(fixed, warped, sigma=4.0))
    assert after > before + 0.05, (before, after)
    mse_before = float(((fixed - moving) ** 2).mean())
    mse_after = float(((fixed - warped) ** 2).mean())
    assert mse_after < mse_before * 0.2


# ---------------------------------------------------------------------------
# the comparator CLI

@pytest.fixture(scope="module")
def pair_dirs(tmp_path_factory):
    """fiximg/fixseg (1 volume) and movimg/movseg (2 volumes): small
    ellipsoid heads with 3 labels, centres jittered, as Analyze files."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(5)
    shape = (24, 30, 142)
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n) for n in shape), indexing="ij")
    dirs = {}
    for kind, n in (("fix", 1), ("mov", 2)):
        for part in ("img", "seg"):
            dirs[kind + part] = str(root / (kind + part))
            os.mkdir(dirs[kind + part])
        for i in range(n):
            r = np.sqrt((x - rng.uniform(-.15, .15)) ** 2
                        + (y - rng.uniform(-.15, .15)) ** 2 + (z / 2.5) ** 2)
            seg = np.select([r < 0.35, r < 0.6, r < 0.85], [3, 2, 1], 0)
            write_analyze(os.path.join(dirs[kind + "img"], f"{kind}{i}_mpr"),
                          seg * 200 + rng.normal(0, 10, shape))
            write_analyze(os.path.join(dirs[kind + "seg"], f"{kind}{i}_seg"), seg)
    return dirs


def _real_args(dirs, tmp_path):
    return ["--mode", "real", "--max_samples", "2",
            "--logdir", str(tmp_path / "log"),
            *(a for d in ("fiximg", "fixseg", "movimg", "movseg")
              for a in (f"--{d}_dir", dirs[d]))]


METRICS = ("dice", "mse", "psnr", "hausdorff", "ssim_img", "ssim_seg", "mi", "corr")


# the comparator CLI's TensorBoard tags, a batch: each metric's average and
# latest value (tpureg/cli/inference_ants.py:142-143)
ANTS_TAGS = [("scalar", f"{m}_{s}") for m in METRICS for s in ("avg", "single")]


def test_comparator_cli_synthetic_mode_runs_on_cpu(pair_dirs, capsys, tb_records,  # noqa: F811
                                                   tmp_path):
    from tpureg_torch.cli.inference_ants import main

    results = main(["--mode", "synthetic", "--img_dir", pair_dirs["movimg"],
                    "--seg_dir", pair_dirs["movseg"], "--max_samples", "2",
                    "--logdir", str(tmp_path / "log")], device="cpu")
    out = capsys.readouterr().out
    assert "classical backend: torch" in out
    assert "[CLASSICAL 001/160]" in out and "===> CLASSICAL summary" in out
    assert set(results) == set(METRICS)
    assert all(np.isfinite(v) for v in results.values())
    assert 0.5 < results["dice"] <= 1.0
    (w,) = tb_records
    assert w.closed and w.tags() == ANTS_TAGS
    assert {step for *_, step, _ in w.calls} == {1, 2}


def test_comparator_cli_real_mode_matches_tpureg(pair_dirs, tmp_path, monkeypatch,
                                                 tb_records):  # noqa: F811
    """The same fixture pairs through both CLIs: no randomness in this mode,
    so every metric agrees up to the registration's rounding (mean Dice
    measured 1.5e-5 apart over 3 pairs), and each writes the same
    TensorBoard calls."""
    from tpureg.cli.inference_ants import main as jmain
    from tpureg_torch.cli.inference_ants import main

    jax_writers = []
    monkeypatch.setattr(jax_tb, "_make_writer", lambda logdir, flush_secs:
                        jax_writers.append(RecordingWriter(logdir)) or jax_writers[-1])
    args = _real_args(pair_dirs, tmp_path)
    got = main(args, device="cpu")
    want = jmain(args + ["--backend", "jax"])
    (w,), (jw,) = tb_records, jax_writers
    assert w.tags() == ANTS_TAGS and w.calls == jw.calls
    assert set(got) == set(want) == set(METRICS)
    assert abs(got["dice"] - want["dice"]) <= 1e-3, (got["dice"], want["dice"])
    for k in METRICS:
        assert got[k] == pytest.approx(want[k], rel=1e-2, abs=1e-3), k


def test_comparator_cli_refuses_a_missing_card(monkeypatch, pair_dirs, tmp_path):
    from tpureg_torch.cli.inference_ants import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_real_args(pair_dirs, tmp_path))
