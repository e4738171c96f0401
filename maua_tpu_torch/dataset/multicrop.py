"""Multi-crop dataset for self-supervised training (SwAV-style).

Port of `maua_tpu/dataset/multicrop.py`: per image, several global and
local random-resized crops with a random horizontal flip, made on the
device from a cached image array. `random_resized_crop_at` is the crop's
arithmetic from three explicit uniforms in [0, 1) (area, top, left), as
maua_tpu computes it from its three draws; `random_resized_crop` draws
them from a torch.Generator. The epoch's permutation is numpy's
`default_rng(seed)`, as in maua_tpu. Crops are NCHW.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utility import resolve_device


def random_resized_crop_at(img: torch.Tensor, out_size: int, uniforms: torch.Tensor,
                           scale: Tuple[float, float] = (0.14, 1.0)) -> torch.Tensor:
    """Crops of images (B, C, H, W) resized bilinearly to (B, C, out_size, out_size), from uniforms (B, 3):
    the area fraction lo + u0 (hi - lo) of `scale` (at least lo, as jax.random.uniform bounds it), a square
    of side sqrt(area) * min(H, W) with its top at u1 (H - side) and its left at u2 (W - side), sampled at
    pixel centres with edge-clamped bilinear taps. Differentiable in img."""
    b, c, h, w = img.shape
    u = uniforms.to(device=img.device, dtype=torch.float32)
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=img.device) for v in scale)
    area = torch.maximum(u[:, 0] * (hi - lo) + lo, lo)  # f32 throughout, as jax.random.uniform computes it
    size = torch.sqrt(area) * min(h, w)
    y0 = u[:, 1] * (h - size)
    x0 = u[:, 2] * (w - size)
    steps = (torch.arange(out_size, device=img.device) + 0.5)[None] * size[:, None] / out_size
    ys = torch.clamp(y0[:, None] + steps - 0.5, 0, h - 1)
    xs = torch.clamp(x0[:, None] + steps - 0.5, 0, w - 1)
    yi, xi = torch.floor(ys).long(), torch.floor(xs).long()
    y1, x1 = torch.clamp(yi + 1, max=h - 1), torch.clamp(xi + 1, max=w - 1)
    wy = (ys - yi)[:, :, None, None]
    wx = (xs - xi)[:, None, :, None]
    bi = torch.arange(b, device=img.device)[:, None, None]

    def tap(r, q):  # (B, out, out, C)
        return img[bi, :, r[:, :, None], q[:, None, :]]

    v = (tap(yi, xi) * (1 - wy) * (1 - wx) + tap(yi, x1) * (1 - wy) * wx
         + tap(y1, xi) * wy * (1 - wx) + tap(y1, x1) * wy * wx)
    return v.permute(0, 3, 1, 2)


def random_resized_crop(img: torch.Tensor, out_size: int, gen: torch.Generator,
                        scale: Tuple[float, float] = (0.14, 1.0)) -> torch.Tensor:
    """`random_resized_crop_at` with each image's three uniforms drawn from `gen`."""
    u = torch.rand((img.shape[0], 3), generator=gen, device=gen.device)
    return random_resized_crop_at(img, out_size, u, scale)


class MultiCropDataset:
    """Yields, per batch, the list of crop batches [(B, C, s0, s0) x n0, (B, C, s1, s1) x n1, ...] of
    images (N, H, W, C) float in [0, 1], on `device` (cuda unless told otherwise); the crops' uniforms and
    flips come from a torch.Generator seeded with `seed` there."""

    def __init__(
        self,
        images: np.ndarray,
        size_crops: Sequence[int] = (224, 96),
        n_crops: Sequence[int] = (2, 6),
        scale_crops: Sequence[Tuple[float, float]] = ((0.14, 1.0), (0.05, 0.14)),
        batch_size: int = 8,
        seed: int = 0,
        device=None,
    ):
        self.images = np.asarray(images)
        self.size_crops = list(size_crops)
        self.n_crops = list(n_crops)
        self.scale_crops = list(scale_crops)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def __len__(self):
        return len(self.images) // self.batch_size

    def __iter__(self) -> Iterator[List[torch.Tensor]]:
        order = self.rng.permutation(len(self.images))
        for b in range(len(self)):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            batch = torch.from_numpy(np.ascontiguousarray(self.images[np.sort(idx)], np.float32))
            batch = batch.permute(0, 3, 1, 2).to(self.device)
            crops = []
            for size, n, scale in zip(self.size_crops, self.n_crops, self.scale_crops):
                for _ in range(n):
                    crop = random_resized_crop(batch, size, self.gen, scale)
                    flip = torch.rand(batch.shape[0], generator=self.gen, device=self.device) < 0.5
                    crops.append(torch.where(flip[:, None, None, None], crop.flip(-1), crop))
            yield crops
