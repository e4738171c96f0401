"""Cutout samplers for CLIP guidance.

Port of `maua_tpu/ops/cutouts.py` (random_cutouts with its gather-based
bilinear crop and resize, Cutouts, MauaCutouts, DangoCutouts,
make_cutouts). Images are NHWC. The crops are differentiable in the
image. Their sizes and offsets are drawn from a torch.Generator, or
given as `draws` = (sizes, y0s, x0s), one array of n_cuts each, so that
the same crops can be cut as another source drew them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .warp import resize

Draws = Tuple  # (sizes, y0s, x0s), each (n_cuts,)


def _crop_resize(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, size: torch.Tensor,
                 out_size: int) -> torch.Tensor:
    """Crops of img (H, W, C) at (y0, x0) with side `size`, each (n,), bilinearly
    resized to out_size: (n, out_size, out_size, C)."""
    h, w, _ = img.shape
    r = torch.arange(out_size, dtype=torch.float32, device=img.device) + 0.5
    ys = (y0[:, None] + r * size[:, None] / out_size - 0.5).clamp(0, h - 1)
    xs = (x0[:, None] + r * size[:, None] / out_size - 0.5).clamp(0, w - 1)
    y0i, x0i = ys.floor().long(), xs.floor().long()
    y1i, x1i = (y0i + 1).clamp_max(h - 1), (x0i + 1).clamp_max(w - 1)
    wy = (ys - y0i)[:, :, None, None]
    wx = (xs - x0i)[:, None, :, None]
    v00 = img[y0i[:, :, None], x0i[:, None, :]]
    v01 = img[y0i[:, :, None], x1i[:, None, :]]
    v10 = img[y1i[:, :, None], x0i[:, None, :]]
    v11 = img[y1i[:, :, None], x1i[:, None, :]]
    return v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx) + v11 * wy * wx


def cutout_draws(gen: Optional[torch.Generator], h: int, w: int, cut_size: int, n_cuts: int,
                 cut_pow: float = 1.0, device=None) -> Draws:
    """Sizes uniform^cut_pow between min(h, w, cut_size) and min(h, w); offsets uniform within the image."""
    min_size, max_size = min(h, w, cut_size), min(h, w)
    device = gen.device if gen is not None else device
    u = torch.rand((3, n_cuts), generator=gen, device=device)
    sizes = u[0] ** cut_pow * (max_size - min_size) + min_size
    return sizes, u[1] * (h - sizes), u[2] * (w - sizes)


def random_cutouts(img: torch.Tensor, cut_size: int, n_cuts: int, cut_pow: float = 1.0,
                   gen: Optional[torch.Generator] = None, draws: Optional[Draws] = None) -> torch.Tensor:
    """Random square crops resized to cut_size: img (B, H, W, C) -> (B * n_cuts, cut_size, cut_size, C),
    image-major. `draws` = (sizes, y0s, x0s) replaces the draw from `gen`."""
    b, h, w, c = img.shape
    if draws is None:
        draws = cutout_draws(gen, h, w, cut_size, n_cuts, cut_pow, img.device)
    sizes, y0s, x0s = (d.to(dtype=torch.float32, device=img.device) if isinstance(d, torch.Tensor)
                       else torch.tensor(np.asarray(d), dtype=torch.float32, device=img.device) for d in draws)
    cuts = [_crop_resize(im, y0s, x0s, sizes, cut_size) for im in img]
    return torch.stack(cuts).reshape(b * len(sizes), cut_size, cut_size, c)


class Cutouts:
    """A fixed number of random cutouts."""

    def __init__(self, cut_size: int, n_cuts: int = 16, cut_pow: float = 1.0):
        self.cut_size = cut_size
        self.n_cuts = n_cuts
        self.cut_pow = cut_pow

    def __call__(self, img, gen=None, draws: Optional[Sequence[Draws]] = None):
        """`draws`: one (sizes, y0s, x0s) for each random_cutouts call, in order."""
        return random_cutouts(img, self.cut_size, self.n_cuts, self.cut_pow, gen, draws[0] if draws else None)


class MauaCutouts(Cutouts):
    """Half the cuts biased to details (cut_pow 3), half to the whole frame (0.3)."""

    def __call__(self, img, gen=None, draws=None):
        half = self.n_cuts // 2
        detail = random_cutouts(img, self.cut_size, half, 3.0, gen, draws[0] if draws else None)
        wide = random_cutouts(img, self.cut_size, self.n_cuts - half, 0.3, gen, draws[1] if draws else None)
        return torch.cat([detail, wide])


class DangoCutouts(Cutouts):
    """`overview` copies of the whole image resized, then random inner cuts."""

    def __init__(self, cut_size: int, n_cuts: int = 16, cut_pow: float = 1.0, overview: int = 4):
        super().__init__(cut_size, n_cuts, cut_pow)
        self.overview = min(overview, n_cuts)

    def __call__(self, img, gen=None, draws=None):
        full = resize(img.permute(0, 3, 1, 2), (self.cut_size, self.cut_size), "bilinear").permute(0, 2, 3, 1)
        inner = random_cutouts(img, self.cut_size, self.n_cuts - self.overview, self.cut_pow, gen,
                               draws[0] if draws else None)
        return torch.cat([full.repeat(self.overview, 1, 1, 1), inner])


def make_cutouts(kind: str, cut_size: int, n_cuts: int = 16, cut_pow: float = 1.0):
    return {"maua": MauaCutouts, "normal": Cutouts, "dango": DangoCutouts}[kind](cut_size, n_cuts, cut_pow)
