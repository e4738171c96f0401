"""Multiscale 2-D perlin noise images.

Port of `maua_tpu/ops/noise.py` (perlin2d, create_perlin_noise); its 3-D
tileable `perlin_noise` is not ported yet. The gradients are drawn from
a torch.Generator, or passed in (`gradients`), so that the same noise can
be made from another package's draws.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _interp(t):
    return 3 * t**2 - 2 * t**3


def perlin2d(grads: torch.Tensor, width: int, height: int, scale: int = 10) -> torch.Tensor:
    """2-D gradient noise tile (width*scale, height*scale) from gradients
    `grads` (2, width + 1, height + 1) (x and y components)."""
    gx, gy = grads.reshape(2, width + 1, height + 1, 1, 1)
    xs = torch.linspace(0, 1, scale + 1, device=grads.device)[:-1][:, None]
    ys = torch.linspace(0, 1, scale + 1, device=grads.device)[None, :-1]
    wx = 1 - _interp(xs)
    wy = 1 - _interp(ys)
    dots = wx * wy * (gx[:-1, :-1] * xs + gy[:-1, :-1] * ys)
    dots += (1 - wx) * wy * (-gx[1:, :-1] * (1 - xs) + gy[1:, :-1] * ys)
    dots += wx * (1 - wy) * (gx[:-1, 1:] * xs - gy[:-1, 1:] * (1 - ys))
    dots += (1 - wx) * (1 - wy) * (-gx[1:, 1:] * (1 - xs) - gy[1:, 1:] * (1 - ys))
    return dots.permute(0, 2, 1, 3).reshape(width * scale, height * scale)


def create_perlin_noise(gen: torch.Generator, octaves=(1, 1, 1, 1), width: int = 2, height: int = 2,
                        grayscale: bool = True, gradients: Optional[Sequence] = None) -> torch.Tensor:
    """Multiscale 2-D perlin image (H, W, 3) in [0, 1] on gen's device.

    Each octave of each channel draws its gradients (2, w + 1, h + 1) from
    `gen` (channel by channel, octave by octave), or takes them in that
    order from `gradients`."""
    device = gen.device
    draws = iter(gradients) if gradients is not None else None
    channels = 1 if grayscale else 3
    outs = []
    for _ in range(channels):
        acc = 0.5
        scale = 2 ** len(octaves)
        ow, oh = width, height
        for octv in octaves:
            shape = (2, ow + 1, oh + 1)
            if draws is None:
                g = torch.randn(shape, generator=gen, device=device)
            else:
                g = torch.from_numpy(np.array(next(draws), np.float32).reshape(shape)).to(device)
            acc = acc + perlin2d(g, ow, oh, scale) * octv
            scale //= 2
            ow *= 2
            oh *= 2
        outs.append(acc)
    img = torch.clamp(torch.stack(outs, dim=-1), 0, 1)
    # autocontrast
    img = (img - img.min()) / torch.clamp(img.max() - img.min(), min=1e-8)
    if grayscale:
        img = img.repeat(1, 1, 3)
    return img
