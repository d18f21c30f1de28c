"""The training slice's data path in tpureg_torch against tpureg's on the CPU:
the cubic control-grid upsample, the elastic synthesis, the volume split and
the slice datasets.

``jax.random`` and ``torch.Generator`` give different numbers from one seed,
so the comparisons inject the same displacement fields (or control-grid
offsets and magnitudes) on both sides; tpureg's datasets then run with
``jax.disable_jit()`` so that the injected function is the one they call.
"""

import itertools
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpureg.ops.elastic as jax_elastic
from tpureg.data import split_volumes as jax_split_volumes
from tpureg.data import volume2slices_datasets as jax_volume2slices
from tpureg.data.pipeline import SliceDataset as JaxSliceDataset
from tpureg.data.pipeline import VolumeSliceSource as JaxVolumeSliceSource
import tpureg_torch.ops.elastic as port_elastic
from tpureg_torch.data import (
    SliceDataset,
    VolumeSliceSource,
    eval_random_dataset,
    list_pairs,
    split_volumes,
    synth_image_batch,
    volume2slices_datasets,
)
from tpureg_torch.ops.resize import cubic_resize

CPU = torch.device("cpu")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# the cubic upsample and the elastic field

@pytest.mark.parametrize("src,dst", [((19, 19), (256, 256)), ((7, 11), (40, 90))],
                         ids=["control-grid", "non-square"])
def test_cubic_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(0).standard_normal((2, *src, 2)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 2), "cubic"))
    got = _nhwc(cubic_resize(_nchw(x), dst))
    # two fp32 products of weights computed in float64 (JAX: fp32) ≤ 1e-5
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # PyTorch's own bicubic is another interpolant (a = -0.75, clamped edges)
    bicubic = torch.nn.functional.interpolate(_nchw(x), dst, mode="bicubic")
    assert np.abs(_nhwc(bicubic) - want).max() > 1e-2


def test_cubic_resize_refuses_to_downsample():
    with pytest.raises(ValueError):
        cubic_resize(torch.zeros(1, 1, 8, 8), (4, 8))


def test_elastic_displacement_matches_tpureg_with_injected_draws():
    """magnitude ~ U(range) per sample times N(0, 1) control-grid offsets,
    upsampled by JAX's cubic: the same draws give tpureg's field."""
    rng = np.random.default_rng(1)
    b, h, w = 2, 64, 48
    gh, gw = h // 16 + 3, w // 16 + 3
    mags = rng.uniform(0.0, 0.5, b).astype(np.float32)
    offs = rng.standard_normal((b, gh, gw, 2)).astype(np.float32)
    got = port_elastic.elastic_displacement_2d(
        b, (h, w), magnitudes=torch.from_numpy(mags), offsets=_nchw(offs))
    assert got.shape == (b, 2, h, w)
    want = jax.image.resize(jnp.asarray(offs * mags[:, None, None, None]),
                            (b, h, w, 2), "cubic")
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


def test_elastic_draws_follow_the_generator():
    g = lambda s: torch.Generator().manual_seed(s)
    a = port_elastic.elastic_displacement_2d(3, (32, 32), generator=g(0))
    b = port_elastic.elastic_displacement_2d(3, (32, 32), generator=g(0))
    c = port_elastic.elastic_displacement_2d(3, (32, 32), generator=g(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0 < float(a.abs().max()) < 5.0


def _disp(seed, b, h, w, scale=3.0):
    rng = np.random.default_rng(seed)
    coarse = rng.standard_normal((b, h // 16 + 3, w // 16 + 3, 2)) * scale
    return np.asarray(jax.image.resize(jnp.asarray(coarse, jnp.float32),
                                       (b, h, w, 2), "cubic"))


def test_rand_elastic_matches_tpureg_on_one_field(monkeypatch):
    """Bilinear image warp and nearest label warp of one injected field."""
    rng = np.random.default_rng(2)
    b, h, w = 2, 48, 64
    img = rng.random((b, h, w, 1)).astype(np.float32)
    seg = rng.integers(0, 4, (b, h, w, 1)).astype(np.float32)
    disp = _disp(3, b, h, w)
    monkeypatch.setattr(jax_elastic, "elastic_displacement_2d",
                        lambda *a, **k: jnp.asarray(disp))
    monkeypatch.setattr(port_elastic, "elastic_displacement_2d",
                        lambda *a, **k: _nchw(disp))
    want_img, want_seg = jax_elastic.rand_elastic_2d(
        jax.random.key(0), jnp.asarray(img), jnp.asarray(seg))
    got_img, got_seg = port_elastic.rand_elastic_2d(_nchw(img), _nchw(seg))
    # the same fp32 positions, gathered and weighted in the same order
    np.testing.assert_allclose(_nhwc(got_img), np.asarray(want_img), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(_nhwc(got_seg), np.asarray(want_seg))


# ---------------------------------------------------------------------------
# splits and datasets

def write_analyze(path_base, vol):
    """A little-endian int16 Analyze 7.5 pair (.hdr/.img)."""
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = (len(vol.shape),) + vol.shape + (1,) * (7 - len(vol.shape))
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, 4)
    struct.pack_into("<h", hdr, 72, 16)
    struct.pack_into("<8f", hdr, 76, 0, 1, 1, 1, 1, 0, 0, 0)
    with open(path_base + ".hdr", "wb") as f:
        f.write(hdr)
    vol.astype(np.int16).ravel(order="F").tofile(path_base + ".img")


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Five small phantom volumes (crop window 60..140 in z) with labels."""
    root = tmp_path_factory.mktemp("oasis")
    rng = np.random.default_rng(4)
    for d in ("img", "seg"):
        (root / d).mkdir()
    shape = (24, 30, 142)
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n) for n in shape), indexing="ij")
    for i in range(5):
        r = np.sqrt((x - rng.uniform(-.1, .1)) ** 2 + y ** 2 + (z / 2.5) ** 2)
        seg = np.select([r < 0.35, r < 0.6, r < 0.85], [3, 2, 1], 0)
        write_analyze(str(root / "img" / f"s{i}_mpr"),
                      seg * 200 + rng.normal(0, 10, shape))
        write_analyze(str(root / "seg" / f"s{i}_seg"), seg)
    return str(root / "img"), str(root / "seg")


@pytest.mark.parametrize("n,limit", [(10, 10), (7, None), (23, 10)])
def test_split_volumes_matches_tpureg(n, limit):
    items = [f"vol{i}" for i in range(n)]
    assert split_volumes(items, seed=6, limit=limit) == \
        jax_split_volumes(items, seed=6, limit=limit)


def test_volume2slices_splits_match_tpureg(volumes):
    got = volume2slices_datasets(*volumes, 4, CPU, val_frac=0.2, test_frac=0.2)
    want = jax_volume2slices(*volumes, 4, val_frac=0.2, test_frac=0.2)
    for g, w in zip(got[:3], want[:3]):
        assert g.source.items == w.source.items
    assert got[3:] == want[3:] == (3 * 80, 80)
    assert got[0].magnitude == (0.0, 0.5) and got[0].source.device == CPU


def test_slice_dataset_matches_tpureg_with_injected_fields(volumes, monkeypatch):
    """Unshuffled batches, with segmentations: gather, resize, rot90, elastic
    warp (injected field), min-max scaling, batch for batch."""
    items = list_pairs(*volumes)[:2]
    size, bs = 64, 4
    disps = [_disp(10 + i, bs, size, size) for i in range(2)]
    calls = {"jax": 0, "port": 0}

    def inject(side, convert):
        def fake(*args, **kwargs):
            calls[side] += 1
            return convert(disps[calls[side] - 1])
        return fake

    monkeypatch.setattr(jax_elastic, "elastic_displacement_2d",
                        inject("jax", jnp.asarray))
    monkeypatch.setattr(port_elastic, "elastic_displacement_2d",
                        inject("port", _nchw))
    port = SliceDataset(VolumeSliceSource(items, CPU), bs, (8,), size=size)
    jds = JaxSliceDataset(JaxVolumeSliceSource(items), bs, jax.random.key(8),
                          size=size)
    with jax.disable_jit():
        pairs = list(itertools.islice(zip(iter(port), iter(jds)), 2))
    for got, want in pairs:
        assert got["image_c"].shape == got["seg_c"].shape == (bs, size, size, 2)
        # tpureg resizes by fp32 matmul, the port by F.interpolate
        np.testing.assert_allclose(got["image_c"].numpy(),
                                   np.asarray(want["image_c"]), atol=2e-6)
        np.testing.assert_array_equal(got["seg_c"].numpy(),
                                      np.asarray(want["seg_c"]))


def test_shuffled_epoch_is_a_permutation(volumes):
    """The port draws its own permutation (torch, not jax.random): each epoch
    serves every slice once, in another order than the last."""
    src = VolumeSliceSource(list_pairs(*volumes)[:2], CPU, with_seg=False)
    ds = SliceDataset(src, 16, (6, 0), size=32, shuffle=True)
    orders = []
    for epoch in (1, 2):
        ds.set_epoch(epoch)
        idx = torch.cat([i for _, _, i in ds.batch_specs()]).numpy()
        assert sorted(idx.tolist()) == list(range(len(src)))
        orders.append(idx)
    assert not np.array_equal(orders[0], orders[1])
    assert not np.array_equal(orders[0], np.arange(len(src)))


def test_batch_specs_synthesise_the_iterators_batches(volumes):
    src = VolumeSliceSource(list_pairs(*volumes)[:1], CPU, with_seg=False)
    ds = SliceDataset(src, 8, (6, 0), size=32, shuffle=True, epoch=3)
    assert ds.supports_fused_step
    for spec, batch in itertools.islice(zip(ds.batch_specs(), iter(ds)), 3):
        got = synth_image_batch(*spec, size=32, magnitude=ds.magnitude)
        assert torch.equal(got, batch["image_c"])
    ds.set_epoch(4)
    assert not torch.equal(next(iter(ds))["image_c"], batch["image_c"])


def test_eval_random_dataset(volumes):
    ds, n = eval_random_dataset(*volumes, 2, CPU)
    assert n == 5 * 80 and ds.magnitude == (0.5, 1.0)
    batch = next(iter(ds))
    assert batch["image_c"].shape == batch["seg_c"].shape == (2, 256, 256, 2)
    assert float(batch["image_c"].min()) == 0.0
    assert set(torch.unique(batch["seg_c"]).tolist()) <= {0.0, 1.0, 2.0, 3.0}
