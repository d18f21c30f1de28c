"""OASIS-1 volume→slice data, the counterpart of ``tpureg/data/pipeline.py``
(reference dataset.py:30-97, 169-275).

Host side: Analyze decode → (Z, X, Y) transpose → crop of the axial window
Z∈[60,140), X<176, Y<208 → float32 slice stacks, pushed to the device once
per volume (the CacheDataset role). Device side (one pass per batch): a
gather of the batch's slices, resize to 256² (bilinear for images, nearest
for labels), ``rot90``, the elastic moving-image synthesis
(``ops/elastic.py``) or the real moving subject, fixed/moving concat and a
joint per-sample min-max scaling of the images.

Dataset constructors:

- ``volume2slices_datasets``: the train/val/test split (fractions and the
  seed-6 permutation of dataset.py:36-49) feeding the training loop;
- ``eval_random_dataset``: elastic pairs of evaluation strength, magnitude
  (0.5, 1) (dataset.py:169-219);
- ``real_pairs_dataset``: distinct fixed and moving subjects, no
  augmentation (dataset.py:222-275);
- ``volume_dataset``: whole-volume 3-D pairs for the volumetric stages, each
  moving volume a random rigid transform of its fixed one (dataset.py:100-167,
  tpureg's pipeline.py:486-557).

Batches are dicts ``{"image_c": [B,256,256,2], "seg_c": [B,256,256,2]}``
on the device the caller names, in tpureg's channels-last layout.

Randomness: where tpureg folds the epoch and the batch's first slice index
into a ``jax.random`` key, the port seeds a ``torch.Generator`` on the
device from the same integers (``utils.derive_seed``). The two streams
differ, so elastic fields and shuffled orders are not tpureg's: a shuffled
epoch is another permutation of the same slices.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from glob import glob
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.affine3d import affine_warp3d
from ..ops.elastic import rand_elastic_2d
from ..ops.resize import resize2d, resize_nd
from ..parallel.mesh import rank_and_world
from ..utils.seeding import derive_seed, seed_everything
from .analyze import read_analyze

__all__ = ["list_pairs", "split_volumes", "VolumeSliceSource", "SliceDataset",
           "synth_image_batch", "volume2slices_datasets", "eval_random_dataset",
           "RealPairsDataset", "real_pairs_dataset", "VOLUME_SIZE",
           "random_rigid_draws", "VolumePairDataset", "volume_dataset"]

CROP_Z = (60, 140)   # dataset.py:56 — 80 axial slices per volume
CROP_X = (0, 176)
CROP_Y = (0, 208)
SLICES_PER_VOLUME = CROP_Z[1] - CROP_Z[0]


def list_pairs(img_dir: str, seg_dir: str) -> List[Dict[str, str]]:
    imgs = sorted(glob(os.path.join(img_dir, "*.img")))
    segs = sorted(glob(os.path.join(seg_dir, "*.img")))
    return [{"image": i, "seg": s} for i, s in zip(imgs, segs)]


def _load_cropped_slices(path: str) -> np.ndarray:
    """(Z=80, X≤176, Y≤208) axial slice stack from one Analyze volume."""
    vol = read_analyze(path)  # (X, Y, Z[, V])
    if vol.ndim == 3:
        vol = vol[..., None]
    # reference Transposed([3,2,0,1]): (V, Z, X, Y); V folds into channel=1
    vol = np.transpose(vol, (3, 2, 0, 1))[0]
    return vol[CROP_Z[0]:CROP_Z[1], CROP_X[0]:CROP_X[1], CROP_Y[0]:CROP_Y[1]]


def split_volumes(items: Sequence, val_frac: float = 0.1,
                  test_frac: float = 0.1, seed: int = 6,
                  limit: Optional[int] = 10):
    """Shuffled (train, val, test) split with the reference's [:10] volume
    cap and numpy seed-6 permutation (dataset.py:35-49), as tpureg's."""
    items = list(items)[:limit] if limit else list(items)
    seed_everything(seed)
    idx = np.arange(len(items))
    np.random.shuffle(idx)
    n_test = int(test_frac * len(items))
    n_val = int(val_frac * len(items)) + n_test
    test = [items[i] for i in idx[:n_test]]
    val = [items[i] for i in idx[n_test:n_val]]
    train = [items[i] for i in idx[n_val:]]
    return train, val, test


class VolumeSliceSource:
    """Slice supplier for {'image', 'seg'} volume pairs. Each volume is
    decoded and cropped on first touch and kept on ``device``; batches are
    gathered there in slice order (GridPatchDataset semantics) or in a given
    order. ``with_seg=False`` never reads the segmentations."""

    def __init__(self, items: Sequence[Dict[str, str]], device,
                 with_seg: bool = True):
        self.items = list(items)
        self.device = torch.device(device)
        self.with_seg = with_seg
        self._cache: Dict[str, torch.Tensor] = {}
        self._flat = None

    def __len__(self):
        return len(self.items) * SLICES_PER_VOLUME

    def _vol(self, path: str) -> torch.Tensor:
        if path not in self._cache:
            self._cache[path] = torch.from_numpy(
                np.ascontiguousarray(_load_cropped_slices(path),
                                     dtype=np.float32)).to(self.device)
        return self._cache[path]

    def slice_at(self, index: int):
        vi, zi = divmod(index, SLICES_PER_VOLUME)
        item = self.items[vi]
        seg = self._vol(item["seg"])[zi] if self.with_seg else None
        return self._vol(item["image"])[zi], seg

    def flat_stacks(self):
        """([n_slices, X, Y], [n_slices, X, Y] or None) on the device."""
        if self._flat is None:
            imgs = torch.cat([self._vol(it["image"]) for it in self.items])
            segs = (torch.cat([self._vol(it["seg"]) for it in self.items])
                    if self.with_seg else None)
            self._flat = (imgs, segs)
        return self._flat

    def batches(self, batch_size: int, order: Optional[np.ndarray] = None):
        """Yield (img [B,X,Y], seg [B,X,Y] or None) on the device, in
        ``order`` (default: slice order); the last partial batch is
        dropped."""
        n = len(self)
        if n < batch_size:
            return
        order = np.arange(n) if order is None else np.asarray(order)
        flat_i, flat_s = self.flat_stacks()
        for start in range(0, n - batch_size + 1, batch_size):
            idx = torch.as_tensor(order[start:start + batch_size],
                                  device=self.device)
            yield (flat_i.index_select(0, idx),
                   None if flat_s is None else flat_s.index_select(0, idx))


def _minmax_scale(x):
    """Joint per-sample min-max to [0, 1] (ScaleIntensityd, dataset.py:83)."""
    lo = torch.amin(x, dim=(1, 2, 3), keepdim=True)
    hi = torch.amax(x, dim=(1, 2, 3), keepdim=True)
    return torch.where(hi > lo, (x - lo) / (hi - lo), x)


def _prep(x, size: int, method: str):
    """[B, X, Y] slices → [B, 1, size, size], resized and rotated."""
    x = resize2d(x[:, None], (size, size), method, align_corners=False)
    return torch.rot90(x, k=1, dims=(2, 3))


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _process_synth(img, seg, size: int = 256,
                   magnitude: Tuple[float, float] = (0.0, 0.5),
                   generator: Optional[torch.Generator] = None):
    """[B, X, Y] fixed slices → {'image_c'[, 'seg_c']} [B, size, size, 2]
    with an elastic moving image (and labels), tpureg's ``_process_synth``."""
    img = _prep(img, size, "bilinear")
    seg = None if seg is None else _prep(seg, size, "nearest")
    mov, mov_seg = rand_elastic_2d(img, seg, magnitude_range=magnitude,
                                   generator=generator)
    out = {"image_c": _nhwc(_minmax_scale(torch.cat([img, mov], dim=1)))}
    if seg is not None:
        out["seg_c"] = _nhwc(torch.cat([seg, mov_seg], dim=1))
    return out


def synth_image_batch(seed: int, flat_img, idx, size: int = 256,
                      magnitude: Tuple[float, float] = (0.0, 0.5)):
    """Gather + prep + elastic synthesis → ``image_c`` [B, S, S, 2] from a
    ``SliceDataset.batch_specs()`` spec ``(seed, flat_img, idx)``, the input
    of ``make_train_step(synth=...)``; the same batches and draws as the
    dataset's own iterator (tpureg's ``synth_image_batch``)."""
    gen = torch.Generator(device=flat_img.device).manual_seed(seed)
    return _process_synth(flat_img.index_select(0, idx), None, size,
                          magnitude, gen)["image_c"]


def _process_real(fix_img, mov_img, fix_seg, mov_seg, size: int = 256):
    """[B, X, Y] slices → {'image_c', 'seg_c'} [B, size, size, 2]."""
    image_c = _minmax_scale(torch.cat(
        [_prep(fix_img, size, "bilinear"), _prep(mov_img, size, "bilinear")],
        dim=1))
    seg_c = torch.cat([_prep(fix_seg, size, "nearest"),
                       _prep(mov_seg, size, "nearest")], dim=1)
    return {"image_c": _nhwc(image_c), "seg_c": _nhwc(seg_c)}


@dataclass
class SliceDataset:
    """Slices of a ``VolumeSliceSource`` with elastic moving images, tpureg's
    ``SliceDataset``. ``seed`` is the split's entropy (integers); the epoch
    and each batch's first slice index are mixed into it for the batch's
    generator, so epochs draw fresh deformations while the dataset and its
    device cache are reused."""

    source: VolumeSliceSource
    batch_size: int
    seed: Tuple[int, ...]
    magnitude: Tuple[float, float] = (0.0, 0.5)
    size: int = 256
    shuffle: bool = False
    epoch: int = 0

    def __len__(self):
        return len(self.source)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_plan(self):
        """(slice order, per-batch seeds) of the current epoch; a shuffle is
        a permutation drawn on the host from the epoch's seed."""
        n = len(self.source)
        order = np.arange(n)
        if self.shuffle:
            perm = torch.Generator().manual_seed(
                derive_seed(*self.seed, self.epoch, 0, 0))
            order = torch.randperm(n, generator=perm).numpy()
        starts = range(0, n - self.batch_size + 1, self.batch_size)
        seeds = [derive_seed(*self.seed, self.epoch, 1, int(order[s]))
                 for s in starts]
        return order, seeds

    @property
    def supports_fused_step(self) -> bool:
        """True when ``batch_specs()`` can feed a ``synth=`` train step:
        image-only and at least one full batch."""
        return not self.source.with_seg and len(self.source) >= self.batch_size

    def batch_specs(self) -> Iterator[tuple]:
        """Yield ``(seed, flat_img, idx)`` specs for
        ``make_train_step(synth=synth_image_batch-partial)``: the batches
        and draws of ``__iter__``, synthesised inside the step."""
        if not self.supports_fused_step:
            raise ValueError("batch_specs() needs with_seg=False and at least "
                             "one full batch")
        order, seeds = self._epoch_plan()
        flat_i, _ = self.source.flat_stacks()
        bs = self.batch_size
        for j, seed in enumerate(seeds):
            idx = torch.as_tensor(order[j * bs:(j + 1) * bs],
                                  device=self.source.device)
            yield seed, flat_i, idx

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        order, seeds = self._epoch_plan()
        dev = self.source.device
        for seed, (img, seg) in zip(seeds, self.source.batches(self.batch_size,
                                                                order)):
            gen = torch.Generator(device=dev).manual_seed(seed)
            yield _process_synth(img, seg, self.size, self.magnitude, gen)


def volume2slices_datasets(data_dir: str, seg_dir: str, batch_size: int,
                           device, val_frac: float = 0.1,
                           test_frac: float = 0.1, seed: int = 6,
                           limit: Optional[int] = 10,
                           shuffle_train: bool = False, with_seg: bool = True,
                           magnitude: Tuple[float, float] = (0.0, 0.5),
                           process_index: Optional[int] = None,
                           process_count: Optional[int] = None):
    """(train, val, test, train_len, val_len), tpureg's constructor
    (dataset.py:30-97) on ``device``. ``magnitude`` is the elastic
    control-point offset range in pixels (the reference hard-codes (0, 0.5));
    ``with_seg=False`` skips the segmentations, which the training loop never
    reads.

    The per-process input split of tpureg (pipeline.py:386-408): with
    ``process_count`` > 1 the training volumes are split round-robin
    (``train_v[pi::pc]``) and truncated to ``max(1, len(train_v) // pc)``,
    so every process takes the same number of steps an epoch; with fewer
    volumes than processes each repeats ``train_v[pi % len(train_v)]``; the
    index is folded into the training seed, so the processes draw distinct
    deformations. Val and test are not split. ``process_index`` and
    ``process_count`` default to the default process group's rank and
    size, 0 and 1 without one."""
    train_v, val_v, test_v = split_volumes(list_pairs(data_dir, seg_dir),
                                           val_frac, test_frac, seed, limit)
    rank, world = rank_and_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    train_seed = (seed, 0)
    if pc > 1:
        if train_v:
            common = max(1, len(train_v) // pc)
            shard = train_v[pi::pc] or [train_v[pi % len(train_v)]]
            train_v = shard[:common]
        train_seed = (seed, 0, pi)
    mk = lambda vols, split_seed, shuf: SliceDataset(
        VolumeSliceSource(vols, device, with_seg=with_seg), batch_size,
        split_seed, magnitude, 256, shuf)
    train = mk(train_v, train_seed, shuffle_train)
    val = mk(val_v, (seed, 1), False)
    test = mk(test_v, (seed, 2), False)
    return train, val, test, len(train), len(val)


def eval_random_dataset(data_dir: str, seg_dir: str, batch_size: int, device,
                        limit: Optional[int] = 5, seed: int = 8):
    """(dataset, length) of elastic pairs of evaluation strength, magnitude
    (0.5, 1) (dataset.py:169-219)."""
    items = list_pairs(data_dir, seg_dir)[:limit]
    ds = SliceDataset(VolumeSliceSource(items, device), batch_size, (seed,),
                      magnitude=(0.5, 1.0))
    return ds, len(ds)


@dataclass
class RealPairsDataset:
    """Inter-subject fixed/moving pairs, no augmentation (dataset.py:222-275)."""

    fix_items: List[Dict[str, str]]
    mov_items: List[Dict[str, str]]
    batch_size: int
    device: torch.device
    size: int = 256

    def __post_init__(self):
        self.fix_src = VolumeSliceSource(self.fix_items, self.device)
        self.mov_src = VolumeSliceSource(self.mov_items, self.device)

    def __len__(self):
        return len(self.mov_src)

    def __iter__(self):
        for (fi, fs), (mi, ms) in zip(self.fix_src.batches(self.batch_size),
                                      self.mov_src.batches(self.batch_size)):
            yield _process_real(fi, mi, fs, ms, self.size)


def real_pairs_dataset(fiximg_dir, fixseg_dir, movimg_dir, movseg_dir,
                       batch_size: int, device):
    """(dataset, length) on ``device``. The fixed list is tiled to the
    moving list's length (dataset.py:228-229): one fixed atlas against many
    subjects."""
    fix = list_pairs(fiximg_dir, fixseg_dir)
    mov = list_pairs(movimg_dir, movseg_dir)
    fix = (fix * len(mov))[: len(mov)]
    ds = RealPairsDataset(fix, mov, batch_size, torch.device(device))
    return ds, len(ds)


# ---------------------------------------------------------------------------
# 3-D volumes (the affine pre-registration stage's data)

VOLUME_SIZE = (176, 256, 256)   # (D, H, W), reference Resized((256, 256, 176))


def random_rigid_draws(batch: int, generator: Optional[torch.Generator] = None,
                       device=None):
    """(angle [B] ~ U(-π/4, π/4) about the axial axis, tx [B] and ty [B]
    ~ U(-5, 5) voxels in plane), drawn from ``generator`` (on its device)."""
    if generator is not None:
        device = generator.device
    u = torch.rand((3, batch), device=device, generator=generator)
    return (u[0] * (np.pi / 2) - np.pi / 4, u[1] * 10.0 - 5.0,
            u[2] * 10.0 - 5.0)


def _minmax_scale_volume(x):
    """Min-max to [0, 1] per sample and per channel of NCDHW ``x``: tpureg's
    ``_minmax_scale`` reduces axes (1, 2, 3) of its [B, D, H, W, 2] volumes,
    so the fixed and the moving volume are scaled each on its own."""
    lo = torch.amin(x, dim=(2, 3, 4), keepdim=True)
    hi = torch.amax(x, dim=(2, 3, 4), keepdim=True)
    return torch.where(hi > lo, (x - lo) / (hi - lo), x)


def _process_volume(vol, size: Tuple[int, int, int] = VOLUME_SIZE,
                    generator: Optional[torch.Generator] = None, draws=None):
    """[B, D', H', W'] volumes → ``{"image_c": [B, D, H, W, 2]}``: trilinear
    resize to ``size`` (align_corners=False), ``rot90`` k=2 over (H, W), a
    moving volume warped by a random rotation about the axial axis and an
    in-plane shift (``affine_warp3d``, kernel K6a on the card), and the
    min-max scaling. ``draws`` = (angle, tx, ty) as ``random_rigid_draws``
    gives them; drawn from ``generator`` unless given."""
    b = vol.shape[0]
    vol = resize_nd(vol[:, None].float(), size, "linear", align_corners=False)
    vol = torch.rot90(vol, 2, dims=(3, 4))
    ang, tx, ty = (draws if draws is not None
                   else random_rigid_draws(b, generator, vol.device))
    # shifts normalised to [-1, 1] coordinates
    tx = tx * 2 / size[2]
    ty = ty * 2 / size[1]
    cos, sin = torch.cos(ang), torch.sin(ang)
    zeros, ones = torch.zeros_like(ang), torch.ones_like(ang)
    theta = torch.stack([torch.stack([cos, -sin, zeros, tx], dim=-1),
                         torch.stack([sin, cos, zeros, ty], dim=-1),
                         torch.stack([zeros, zeros, ones, zeros], dim=-1)], dim=1)
    moving = affine_warp3d(vol, theta)
    image_c = _minmax_scale_volume(torch.cat([vol, moving], dim=1))
    return {"image_c": image_c.permute(0, 2, 3, 4, 1).contiguous()}


def _load_volume(path: str) -> np.ndarray:
    """(D, H, W) volume of an Analyze file: the reference's
    Transposed([3, 1, 0, 2]) of (X, Y, Z, V), first frame."""
    vol = read_analyze(path)
    if vol.ndim == 3:
        vol = vol[..., None]
    return np.transpose(vol, (3, 1, 0, 2))[0]


@dataclass
class VolumePairDataset:
    """Whole-volume fixed/moving pairs, tpureg's ``VolumePairDataset``: the
    volumes are read in order and each full batch is processed on
    ``device`` with a generator seeded from ``seed`` and the batch's index
    (the last partial batch is dropped)."""

    items: List[Dict[str, str]]
    batch_size: int
    seed: Tuple[int, ...]
    device: torch.device
    size: Tuple[int, int, int] = VOLUME_SIZE

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        vols, j = [], 0
        for item in self.items:
            vols.append(_load_volume(item["image"]))
            if len(vols) == self.batch_size:
                gen = torch.Generator(device=self.device).manual_seed(
                    derive_seed(*self.seed, j))
                batch = torch.from_numpy(np.stack(vols)).to(self.device)
                vols, j = [], j + 1
                yield _process_volume(batch, self.size, gen)


def volume_dataset(data_dir: str, batch_size: int, device,
                   val_frac: float = 0.1, test_frac: float = 0.1,
                   seed: int = 6, limit: Optional[int] = 20,
                   size: Tuple[int, int, int] = VOLUME_SIZE):
    """(train, val, test, train_len, val_len) 3-D pairs (dataset.py:100-167)
    on ``device``, from the ``*.img`` Analyze volumes of ``data_dir``."""
    items = [{"image": p} for p in sorted(glob(os.path.join(data_dir, "*.img")))]
    train_v, val_v, test_v = split_volumes(items, val_frac, test_frac, seed,
                                           limit)
    dev = torch.device(device)
    mk = lambda vols, split: VolumePairDataset(vols, batch_size, (seed, split),
                                               dev, tuple(size))
    return (mk(train_v, 0), mk(val_v, 1), mk(test_v, 2), len(train_v),
            len(val_v))
