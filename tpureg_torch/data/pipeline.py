"""OASIS-1 real-pair data for evaluation, the real-pairs part of
``tpureg/data/pipeline.py`` (reference dataset.py:222-275).

Host side: Analyze decode → (Z, X, Y) transpose → crop of the axial window
Z∈[60,140), X<176, Y<208 → cached float32 slice stacks → batches in
per-volume order. Device side (one pass per batch): resize to 256²
(bilinear for images, nearest for labels), ``rot90``, fixed/moving concat
and a joint per-sample min-max scaling of the images.

Batches are dicts ``{"image_c": [B,256,256,2], "seg_c": [B,256,256,2]}``
on the requested device, in tpureg's channels-last layout. Elastic
synthesis (``--mode synthetic``) and the training splits come with the
training slice.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from glob import glob
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.resize import resize2d
from .analyze import read_analyze

__all__ = ["list_pairs", "VolumeSliceSource", "RealPairsDataset",
           "real_pairs_dataset"]

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


class VolumeSliceSource:
    """Cached host-side slice supplier for {'image', 'seg'} volume pairs:
    decoded and cropped on first touch (the CacheDataset role), then served
    in per-volume order (GridPatchDataset semantics)."""

    def __init__(self, items: Sequence[Dict[str, str]]):
        self.items = list(items)
        self._cache: Dict[str, np.ndarray] = {}

    def __len__(self):
        return len(self.items) * SLICES_PER_VOLUME

    def _vol(self, path: str) -> np.ndarray:
        if path not in self._cache:
            self._cache[path] = _load_cropped_slices(path)
        return self._cache[path]

    def slice_at(self, index: int):
        vi, zi = divmod(index, SLICES_PER_VOLUME)
        item = self.items[vi]
        return self._vol(item["image"])[zi], self._vol(item["seg"])[zi]

    def batches(self, batch_size: int):
        """Yield (img [B,X,Y], seg [B,X,Y]) float32 batches in slice order;
        the last partial batch is dropped."""
        for start in range(0, len(self) - batch_size + 1, batch_size):
            imgs, segs = zip(*(self.slice_at(i)
                               for i in range(start, start + batch_size)))
            yield (np.stack(imgs).astype(np.float32),
                   np.stack(segs).astype(np.float32))


def _minmax_scale(x):
    """Joint per-sample min-max to [0, 1] (ScaleIntensityd, dataset.py:83)."""
    lo = torch.amin(x, dim=(1, 2, 3), keepdim=True)
    hi = torch.amax(x, dim=(1, 2, 3), keepdim=True)
    return torch.where(hi > lo, (x - lo) / (hi - lo), x)


def _process_real(fix_img, mov_img, fix_seg, mov_seg, size: int = 256):
    """[B, X, Y] slices → {'image_c', 'seg_c'} [B, size, size, 2]."""

    def prep(x, method):
        x = resize2d(x[:, None], (size, size), method, align_corners=False)
        return torch.rot90(x, k=1, dims=(2, 3))

    image_c = _minmax_scale(torch.cat(
        [prep(fix_img, "bilinear"), prep(mov_img, "bilinear")], dim=1))
    seg_c = torch.cat([prep(fix_seg, "nearest"), prep(mov_seg, "nearest")],
                      dim=1)
    return {"image_c": image_c.permute(0, 2, 3, 1).contiguous(),
            "seg_c": seg_c.permute(0, 2, 3, 1).contiguous()}


@dataclass
class RealPairsDataset:
    """Inter-subject fixed/moving pairs, no augmentation (dataset.py:222-275)."""

    fix_items: List[Dict[str, str]]
    mov_items: List[Dict[str, str]]
    batch_size: int
    size: int = 256
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))

    def __post_init__(self):
        self.fix_src = VolumeSliceSource(self.fix_items)
        self.mov_src = VolumeSliceSource(self.mov_items)

    def __len__(self):
        return len(self.mov_src)

    def __iter__(self):
        dev = lambda a: torch.from_numpy(a).to(self.device)
        for (fi, fs), (mi, ms) in zip(self.fix_src.batches(self.batch_size),
                                      self.mov_src.batches(self.batch_size)):
            yield _process_real(dev(fi), dev(mi), dev(fs), dev(ms), self.size)


def real_pairs_dataset(fiximg_dir, fixseg_dir, movimg_dir, movseg_dir,
                       batch_size: int, device="cpu"):
    """(dataset, length). The fixed list is tiled to the moving list's length
    (dataset.py:228-229): one fixed atlas against many subjects."""
    fix = list_pairs(fiximg_dir, fixseg_dir)
    mov = list_pairs(movimg_dir, movseg_dir)
    fix = (fix * len(mov))[: len(mov)]
    ds = RealPairsDataset(fix, mov, batch_size, device=torch.device(device))
    return ds, len(ds)
