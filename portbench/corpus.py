"""The slice corpus, made on the device from the seed in place of OASIS-1
(which the repository does not hold).

Each volume is an OASIS-sized phantom head, 176 × 208 × 176 voxels (X, Y,
Z) over [-1, 1]³: an ellipsoid long in z whose centre is drawn from
U(-0.1, 0.1)² in x and y, three nested tissue labels at radii 0.35, 0.6
and 0.85, intensity 250 · label plus N(0, 15²) noise, truncated to whole
numbers as the int16 Analyze files store them. The training pipeline's
crop keeps the axial slices Z 60-139, X < 176, Y < 208: [80, 176, 208] a
volume, slices of one volume adjacent in the corpus.
"""

from __future__ import annotations

import torch

SHAPE = (176, 208, 176)            # X, Y, Z of a volume
CROP_Z = (60, 140)


def make_corpus(seed: int, volumes: int, device, with_labels: bool = False):
    """(images [volumes · 80, 176, 208], labels of the same shape or None),
    fp32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    centres = torch.rand((volumes, 2), generator=gen, device=device) * 0.2 - 0.1
    lin = [torch.linspace(-1.0, 1.0, n, device=device) for n in SHAPE]
    z = lin[2][CROP_Z[0]:CROP_Z[1]][:, None, None]
    x = lin[0][None, :, None]
    y = lin[1][None, None, :]
    n_z = CROP_Z[1] - CROP_Z[0]
    noise = torch.randn((volumes, n_z, SHAPE[0], SHAPE[1]), generator=gen,
                        device=device)
    imgs, labels = [], []
    for v in range(volumes):
        r = torch.sqrt((x - centres[v, 0]) ** 2 + (y - centres[v, 1]) ** 2
                       + (z / 2.5) ** 2)
        lab = (r < 0.85).float() + (r < 0.6).float() + (r < 0.35).float()
        imgs.append(torch.trunc(lab * 250.0 + noise[v] * 15.0))
        labels.append(lab)
    images = torch.cat(imgs)
    return images, (torch.cat(labels) if with_labels else None)
