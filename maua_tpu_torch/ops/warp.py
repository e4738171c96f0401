"""Spatial warps on NCHW tensors: grid_sample, translate / zoom / rotate, and
the bicubic resize of `jax.image.resize`.

Port of `maua_tpu/ops/warp.py`. `grid_sample` keeps the JAX function's
own reflection rule (period 2 * (size - 1), border pixels not repeated),
which is not `torch.nn.functional.grid_sample`'s, so it gathers the four
corners itself. `resize_bicubic` builds `jax.image.resize`'s separable
weights (Keys cubic, a = -0.5, kernel widened when downsampling) in
numpy and applies them as two matrix products;
`F.interpolate(mode="bicubic")` uses a = -0.75 and does not antialias.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch


def _reflect_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    if size == 1:
        return torch.zeros_like(idx)
    period = 2 * (size - 1)
    idx = idx.abs() % period
    return torch.where(idx >= size, period - idx, idx)


def grid_sample(x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "reflection") -> torch.Tensor:
    """Sample x (B, C, H, W) at grid (B, Hg, Wg, 2) of normalized (x, y)
    coords in [-1, 1] (align_corners=False). Returns (B, C, Hg, Wg)."""
    b, c, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * (w / 2.0) - 0.5
    gy = (grid[..., 1] + 1.0) * (h / 2.0) - 0.5
    flat = x.reshape(b, c, h * w)

    def gather(yi, xi):
        yi = yi.long()
        xi = xi.long()
        if padding_mode == "reflection":
            yi2, xi2, valid = _reflect_index(yi, h), _reflect_index(xi, w), None
        elif padding_mode == "border":
            yi2, xi2, valid = yi.clamp(0, h - 1), xi.clamp(0, w - 1), None
        else:  # zeros
            valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).to(x.dtype)
            yi2, xi2 = yi.clamp(0, h - 1), xi.clamp(0, w - 1)
        idx = (yi2 * w + xi2).reshape(b, 1, -1).expand(b, c, -1)
        vals = torch.gather(flat, 2, idx).reshape(b, c, *yi.shape[1:])
        return vals if valid is None else vals * valid[:, None]

    if mode == "nearest":
        return gather(torch.round(gy), torch.round(gx))
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    tx = (gx - x0)[:, None]
    ty = (gy - y0)[:, None]
    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    return v00 * (1 - tx) * (1 - ty) + v01 * tx * (1 - ty) + v10 * (1 - tx) * ty + v11 * tx * ty


def identity_grid(b: int, h: int, w: int, device=None) -> torch.Tensor:
    ys = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) * 2.0 / h - 1.0
    xs = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) * 2.0 / w - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None].repeat(b, 1, 1, 1)


def affine_grid(theta: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """Grid (B, H, W, 2) for 2x3 matrices mapping output to input coords."""
    base = identity_grid(b, h, w, theta.device)
    coords = torch.cat([base, torch.ones_like(base[..., :1])], dim=-1)
    return torch.einsum("bhwk,bjk->bhwj", coords, theta)


def _per_sample(v, b: int, device) -> torch.Tensor:
    """A scalar or (B,) parameter as a (B,) f32 tensor."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1).expand(b)


def translate(x: torch.Tensor, translation, padding_mode: str = "reflection") -> torch.Tensor:
    """Shift by (tx, ty) pixels per sample. translation: (B, 2) or (2,)."""
    b, _, h, w = x.shape
    t = torch.as_tensor(translation, dtype=torch.float32, device=x.device).expand(b, 2)
    theta = torch.zeros(b, 2, 3, device=x.device)
    theta[:, 0, 0] = 1.0
    theta[:, 1, 1] = 1.0
    theta[:, 0, 2] = -2.0 * t[:, 0] / w
    theta[:, 1, 2] = -2.0 * t[:, 1] / h
    return grid_sample(x, affine_grid(theta, b, h, w), padding_mode=padding_mode)


def _center_offsets(theta: torch.Tensor, center, h: int, w: int) -> None:
    c = torch.tensor([2.0 * center[0] / w - 1.0, 2.0 * center[1] / h - 1.0], device=theta.device)
    theta[:, :, 2] = c[None] - torch.einsum("bij,j->bi", theta[:, :, :2], c)


def rotate(x: torch.Tensor, angle_deg, center: Optional[Tuple[float, float]] = None,
           padding_mode: str = "reflection") -> torch.Tensor:
    """Rotate counter-clockwise by degrees about center (default the image center)."""
    b, _, h, w = x.shape
    ang = _per_sample(angle_deg, b, x.device) * (math.pi / 180.0)
    cos, sin = torch.cos(ang), torch.sin(ang)
    theta = torch.zeros(b, 2, 3, device=x.device)
    theta[:, 0, 0] = cos
    theta[:, 0, 1] = sin * h / w
    theta[:, 1, 0] = -sin * w / h
    theta[:, 1, 1] = cos
    if center is not None:
        _center_offsets(theta, center, h, w)
    return grid_sample(x, affine_grid(theta, b, h, w), padding_mode=padding_mode)


def zoom(x: torch.Tensor, factor, center: Optional[Tuple[float, float]] = None,
         padding_mode: str = "reflection") -> torch.Tensor:
    """Scale about center (factor > 1 zooms in)."""
    b, _, h, w = x.shape
    inv = 1.0 / _per_sample(factor, b, x.device).clamp_min(1e-6)
    theta = torch.zeros(b, 2, 3, device=x.device)
    theta[:, 0, 0] = inv
    theta[:, 1, 1] = inv
    if center is not None:
        _center_offsets(theta, center, h, w)
    return grid_sample(x, affine_grid(theta, b, h, w), padding_mode=padding_mode)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) f32 weights of jax.image.resize "bicubic" with
    antialias (jax/_src/image/scale.py compute_weight_mat)."""
    scale = np.float32(out_size / in_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = _keys_cubic(x).astype(np.float32)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def resize_bicubic(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bicubic resize of (B, C, H, W) to size (H', W'), as jax.image.resize."""
    h, w = x.shape[-2:]
    if h != size[0]:
        wh = torch.as_tensor(resize_weights(h, size[0]), dtype=x.dtype, device=x.device)
        x = torch.einsum("bchw,hk->bckw", x, wh)
    if w != size[1]:
        ww = torch.as_tensor(resize_weights(w, size[1]), dtype=x.dtype, device=x.device)
        x = torch.einsum("bchw,wk->bchk", x, ww)
    return x
