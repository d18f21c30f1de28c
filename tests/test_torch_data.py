"""tpureg_torch's data, metric and meter copies against tpureg's on the CPU."""

import struct

import numpy as np
import pytest
import torch

import tpureg.metrics as jax_metrics
from tpureg.data import AnalyzeHeader as JaxAnalyzeHeader
from tpureg.data import read_analyze as jax_read_analyze
from tpureg.data import real_pairs_dataset as jax_real_pairs_dataset
from tpureg.utils import AverageMeter as JaxAverageMeter
import tpureg_torch.metrics as port_metrics
from tpureg_torch.data import AnalyzeHeader, read_analyze, real_pairs_dataset
from tpureg_torch.utils import AverageMeter


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


@pytest.mark.parametrize("datatype", [2, 4, 8, 16])
def test_analyze_reader_matches_tpureg(tmp_path, datatype):
    vol = (np.random.default_rng(0).random((9, 7, 5)) * 100).astype(np.float32)
    write_analyze(str(tmp_path / "v"), vol, datatype)
    got = read_analyze(str(tmp_path / "v.img"))
    want = jax_read_analyze(str(tmp_path / "v.img"), use_native=False)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert AnalyzeHeader(str(tmp_path / "v.hdr")).shape == \
        JaxAnalyzeHeader(str(tmp_path / "v.hdr")).shape


def test_real_pairs_match_tpureg(tmp_path):
    """Resize, rot90 and joint min-max of real pairs, batch for batch."""
    rng = np.random.default_rng(1)
    dirs = {}
    for name in ("fiximg", "fixseg", "movimg", "movseg"):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
    shape = (30, 37, 141)  # smaller than the crop window in x and y
    write_analyze(str(dirs["fiximg"] / "f_mpr"), rng.random(shape) * 900)
    write_analyze(str(dirs["fixseg"] / "f_seg"), rng.integers(0, 4, shape))
    for i in range(2):
        write_analyze(str(dirs["movimg"] / f"m{i}_mpr"), rng.random(shape) * 900)
        write_analyze(str(dirs["movseg"] / f"m{i}_seg"), rng.integers(0, 4, shape))
    args = [str(dirs[k]) for k in ("fiximg", "fixseg", "movimg", "movseg")]
    ds, n = real_pairs_dataset(*args, 4, device="cpu")
    jds, jn = jax_real_pairs_dataset(*args, 4)
    assert n == jn == 160
    count = 0
    for got, want in zip(ds, jds):
        assert got["image_c"].shape == (4, 256, 256, 2)
        # tpureg resizes by fp32 matmul, the port by F.interpolate
        np.testing.assert_allclose(got["image_c"].numpy(),
                                   np.asarray(want["image_c"]), atol=2e-6)
        np.testing.assert_array_equal(got["seg_c"].numpy(),
                                      np.asarray(want["seg_c"]))
        count += 1
        if count == 3:
            break
    assert count == 3


def _pair(seed, size=40):
    rng = np.random.default_rng(seed)
    a = rng.random((size, size)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["MSE", "PSNR", "MI", "CORR", "ssim"])
def test_image_metrics_match_tpureg(name):
    a, b = _pair(2)
    assert getattr(port_metrics, name)(a, b) == getattr(jax_metrics, name)(a, b)


@pytest.mark.parametrize("name", ["dice_average", "dist_hausdorff"])
def test_seg_metrics_match_tpureg(name):
    rng = np.random.default_rng(3)
    a = np.zeros((40, 40), np.float32)
    a[5:30, 8:35] = 1
    a[10:20, 12:25] = 2
    a[12:16, 15:20] = 3
    b = np.roll(a, (1, 2), axis=(0, 1))
    b[rng.random(b.shape) < 0.02] = 0
    assert getattr(port_metrics, name)(a, b) == getattr(jax_metrics, name)(a, b)


def test_jacobian_and_magnitude_match_tpureg():
    flow = np.random.default_rng(4).normal(0, 0.3, (1, 32, 32, 2)).astype(np.float32)
    assert port_metrics.neg_jacobian_fraction(flow[0]) == \
        jax_metrics.neg_jacobian_fraction(flow[0])
    assert port_metrics.log_jacobian_std(flow[0]) == \
        jax_metrics.log_jacobian_std(flow[0])
    assert port_metrics.flow_mag_sum(flow) == pytest.approx(
        jax_metrics.flow_mag(flow)[0], rel=1e-6)


def test_average_meter_matches_tpureg():
    a, b = AverageMeter(), JaxAverageMeter()
    for v in (1.0, 2.5, torch.tensor(4.0)):
        a.update(v)
        b.update(float(v))
    assert (a.val, a.avg, a.sum, a.count, a.data) == \
        (b.val, b.avg, b.sum, b.count, b.data)
