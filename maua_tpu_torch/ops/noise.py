"""Perlin noise: 3-D tileable volumes and multiscale 2-D images.

Port of `maua_tpu/ops/noise.py` (factors, round_to_closest_divisor,
perlin_noise, perlin2d, create_perlin_noise). The gradients are drawn
from a torch.Generator, or passed in (`perlin_noise_from_angles`,
`gradients`), so that the same noise can be made from another package's
draws.
"""

from __future__ import annotations

import math
from functools import reduce
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def factors(n: int) -> np.ndarray:
    return np.array(list(set(reduce(list.__add__, ([i, n // i] for i in range(1, int(n**0.5) + 1) if n % i == 0)))))


def round_to_closest_divisor(num: int, div: int) -> int:
    options = np.sort(factors(num))
    return int(options[np.argmin(np.abs(div - options))])


def _perlinterpolant(t):
    return t * t * t * (t * (t * 6 - 15) + 10)


def perlin_noise(gen: torch.Generator, shape: Tuple[int, int, int], res: Tuple[int, int, int],
                 tileable=(True, False, False)) -> torch.Tensor:
    """3-D perlin noise (T, H, W) on gen's device: the interpolated gradient
    dot products n, as n * 2 - 1 (so magnitudes of ~1). `res` is the
    periods per axis, each snapped to the closest divisor of its size;
    `tileable` wraps the gradients along each axis. The gradient angles
    theta and phi, each (res + 1) per axis and uniform in [0, 2 pi), are
    drawn from gen in that order."""
    res = tuple(round_to_closest_divisor(shape[r], res[r]) for r in range(3))
    gshape = (res[0] + 1, res[1] + 1, res[2] + 1)
    theta = 2 * math.pi * torch.rand(gshape, generator=gen, device=gen.device)
    phi = 2 * math.pi * torch.rand(gshape, generator=gen, device=gen.device)
    return perlin_noise_from_angles(theta, phi, shape, tileable)


def perlin_noise_from_angles(theta: torch.Tensor, phi: torch.Tensor, shape: Tuple[int, int, int],
                             tileable=(True, False, False)) -> torch.Tensor:
    """`perlin_noise` from given gradient angles (res0 + 1, res1 + 1, res2 + 1)."""
    d = tuple(shape[i] // (theta.shape[i] - 1) for i in range(3))
    # the fractional position of every voxel inside its lattice cell
    axes = [torch.arange(shape[i], dtype=torch.float32, device=theta.device) / d[i] % 1.0 for i in range(3)]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    gradients = torch.stack((torch.sin(phi) * torch.cos(theta), torch.sin(phi) * torch.sin(theta), torch.cos(phi)),
                            dim=3)
    if tileable[0]:
        gradients[-1, :, :] = gradients[0, :, :]
    if tileable[1]:
        gradients[:, -1, :] = gradients[:, 0, :]
    if tileable[2]:
        gradients[:, :, -1] = gradients[:, :, 0]
    g = gradients.repeat_interleave(d[0], 0).repeat_interleave(d[1], 1).repeat_interleave(d[2], 2)

    def corner(dx, dy, dz):
        gc = g[d[0] :] if dx else g[: -d[0]]
        gc = gc[:, d[1] :] if dy else gc[:, : -d[1]]
        gc = gc[:, :, d[2] :] if dz else gc[:, :, : -d[2]]
        offs = grid - torch.tensor([dx, dy, dz], dtype=torch.float32, device=grid.device)
        return (offs * gc).sum(3)

    t = _perlinterpolant(grid)
    n00 = corner(0, 0, 0) * (1 - t[..., 0]) + t[..., 0] * corner(1, 0, 0)
    n10 = corner(0, 1, 0) * (1 - t[..., 0]) + t[..., 0] * corner(1, 1, 0)
    n01 = corner(0, 0, 1) * (1 - t[..., 0]) + t[..., 0] * corner(1, 0, 1)
    n11 = corner(0, 1, 1) * (1 - t[..., 0]) + t[..., 0] * corner(1, 1, 1)
    n0 = (1 - t[..., 1]) * n00 + t[..., 1] * n10
    n1 = (1 - t[..., 1]) * n01 + t[..., 1] * n11
    return ((1 - t[..., 2]) * n0 + t[..., 2] * n1) * 2.0 - 1.0


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
