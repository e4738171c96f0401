"""Image tensor ops: tiling with blended seams, resampling, sharpening and
colour matching.

Port of `maua_tpu/ops/image.py` (smoothstep, blend_weight1d, destitch,
restitch, scaled_height_width, resample, sharpen, match_histogram). Images
are NHWC tensors, as in maua_tpu, in [-1, 1] unless noted; the
convolutions and resizes run NCHW inside. `resample` is lanczos3 with
antialias (`jax.image.resize`'s weights, `ops/warp.resize`).
`match_histogram` draws its 1e-3 jitter from a torch.Generator, or takes
the draws from `noise`. The rest of the module (colour spaces,
`original_colors`, local statistics, unsharp masks) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .warp import resize


def smoothstep(x: torch.Tensor, N: int = 2) -> torch.Tensor:
    """Generalized smoothstep polynomial."""
    result = torch.zeros_like(x)
    for n in range(0, N + 1):
        result += math.comb(N + n, n) * math.comb(2 * N + 1, N - n) * (-x) ** n
    return result * x ** (N + 1)


def blend_weight1d(total_size: int, fade_in: int, fade_out: int, device=None) -> torch.Tensor:
    """1-D fade-in/out blend profile."""
    parts = []
    if fade_in > 0:
        parts.append(smoothstep(torch.linspace(0, 1, fade_in, device=device)))
    parts.append(torch.ones(total_size - fade_in - fade_out, device=device))
    if fade_out > 0:
        parts.append(smoothstep(torch.linspace(1, 0, fade_out, device=device)))
    return torch.cat(parts)


def _tile_grid(H: int, W: int, tile_size: int, overtile: int):
    n_rows = int(round(np.floor(H / tile_size) + overtile))
    n_cols = int(round(np.floor(W / tile_size) + overtile))
    ys = np.round(np.linspace(0, H - tile_size, n_rows)).astype(int)
    xs = np.round(np.linspace(0, W - tile_size, n_cols)).astype(int)
    return ys, xs


def destitch(img: torch.Tensor, tile_size: int, overtile: int = 1) -> torch.Tensor:
    """Split (1, H, W, C) into overlapping (N, tile, tile, C) tiles, row by row."""
    _, H, W, _ = img.shape
    ys, xs = _tile_grid(H, W, tile_size, overtile)
    return torch.cat([img[:, y : y + tile_size, x : x + tile_size, :] for y in ys for x in xs], dim=0)


def restitch(tiled: torch.Tensor, H: int, W: int, overtile: int = 1, scale: int = 1) -> torch.Tensor:
    """Blend overlapping tiles back to (1, H, W, C) with smoothstep seams.

    With `scale` > 1 the tiles were cut by `destitch` from the (H / scale,
    W / scale) image and upscaled since: each goes back to destitch's
    offset times scale. (maua_tpu recomputes the grid at the upscaled
    size, whose rounded offsets can lie a pixel off those.)"""
    n, tile_size, _, C = tiled.shape
    ys, xs = _tile_grid(H // scale, W // scale, tile_size // scale, overtile)
    ys, xs = ys * scale, xs * scale
    out = torch.zeros((1, H, W, C), dtype=tiled.dtype, device=tiled.device)
    rescale = torch.zeros((1, H, W, 1), dtype=tiled.dtype, device=tiled.device)
    fade = int(tile_size - ys[1]) if len(ys) > 1 else 0
    i = 0
    for y in ys:
        wy = blend_weight1d(tile_size, 0 if y == ys[0] else fade, 0 if y == ys[-1] else fade, tiled.device)
        for x in xs:
            wx = blend_weight1d(tile_size, 0 if x == xs[0] else fade, 0 if x == xs[-1] else fade, tiled.device)
            w = (wy[:, None] * wx[None, :])[None, :, :, None].to(tiled.dtype)
            out[:, y : y + tile_size, x : x + tile_size, :] += tiled[i] * w
            rescale[:, y : y + tile_size, x : x + tile_size, :] += w
            i += 1
    return out / rescale


def scaled_height_width(h: int, w: int, size: int):
    """Short-side scaling to even dims."""
    short, long = (w, h) if w <= h else (h, w)
    new_short, new_long = size, int(size * long / short)
    w, h = (new_short, new_long) if w <= h else (new_long, new_short)
    return math.ceil(h / 2.0) * 2, math.ceil(w / 2.0) * 2


def resample(img: torch.Tensor, size, method: str = "lanczos3") -> torch.Tensor:
    """Anti-aliased resize of NHWC images, as jax.image.resize(method,
    antialias=True). `size` is (H, W) or an int (the short side)."""
    n, h, w, c = img.shape
    if isinstance(size, (int, float)):
        dh, dw = scaled_height_width(h, w, int(size))
    else:
        dh, dw = size
    return resize(img.permute(0, 3, 1, 2), (dh, dw), method).permute(0, 2, 3, 1)


def sharpen(img: torch.Tensor, strength: float) -> torch.Tensor:
    """Unsharp blend in [0, 1] space of an NHWC image in [-1, 1]: torchvision's
    adjust_sharpness, which leaves the 1px border as it is."""
    x = ((img + 1.0) / 2.0).permute(0, 3, 1, 2)
    c = x.shape[1]
    kernel = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]], device=x.device) / 13.0
    blurred = F.conv2d(x, kernel.to(x.dtype).expand(c, 1, 3, 3), padding=1, groups=c)
    out = x.clone()
    out[:, :, 1:-1, 1:-1] = torch.clamp(strength * x + (1 - strength) * blurred, 0, 1)[:, :, 1:-1, 1:-1]
    return out.permute(0, 2, 3, 1) * 2.0 - 1.0


def _covariance(flat: torch.Tensor) -> torch.Tensor:
    # flat: (C, N) mean-centered
    c = flat.shape[0]
    eye = torch.eye(c, dtype=flat.dtype, device=flat.device)
    return flat @ flat.T / flat.shape[1] + torch.finfo(flat.dtype).eps * eye


def _sqrtm_psd(C: torch.Tensor) -> torch.Tensor:
    eva, eve = torch.linalg.eigh(C)
    E = torch.sqrt(torch.clamp(eva, min=0.0))
    E = torch.nan_to_num(E, nan=0.0)
    return (eve * E[None, :]) @ eve.T


def _match_histogram_one(target: torch.Tensor, source: torch.Tensor, draw, elementwise: bool) -> torch.Tensor:
    """PCA colour transfer of target (B, H, W, C) to source (1, H', W', C)."""
    src = source + 1e-3 * draw(source.shape)
    mu_s = src.mean(dim=(0, 1, 2))
    Qs = _sqrtm_psd(_covariance((src - mu_s).reshape(-1, src.shape[-1]).T))

    def match_frame(frame):
        f = frame[None] + 1e-3 * draw((1,) + tuple(frame.shape))
        mu_t = f.mean(dim=(0, 1, 2))
        t_flat = (f - mu_t).reshape(-1, f.shape[-1]).T
        Qt = _sqrtm_psd(_covariance(t_flat))
        ts = Qs @ torch.linalg.inv(Qt) @ t_flat
        return ts.T.reshape(frame.shape) + mu_s

    if elementwise:
        return torch.stack([match_frame(frame) for frame in target])
    return match_frame(target.reshape(-1, *target.shape[2:])).reshape(target.shape)


def match_histogram(target: torch.Tensor, source, mode: str = "avg", gen: Optional[torch.Generator] = None,
                    noise: Optional[Iterator] = None) -> torch.Tensor:
    """Match target's (B, H, W, C) colour statistics to source's by PCA
    whitening and colouring.

    mode="avg": each frame against the mean source frame; any other mode:
    all frames together against one random source frame; mode="False": no
    change. `source` is one (N, H', W', C) tensor or a list of them. The
    1e-3 jitter is drawn from `gen` (seeded 0 by default), or taken in
    order from `noise`, an iterator of standard-normal arrays: per source,
    the source's draw, then each frame's (one draw for all frames
    together outside "avg")."""
    if mode == "False" or mode is False:
        return target
    if gen is None:
        gen = torch.Generator(device=target.device).manual_seed(0)

    def draw(shape):
        if noise is not None:
            a = np.array(next(noise), np.float32).reshape(shape)
            return torch.from_numpy(a).to(device=target.device, dtype=target.dtype)
        return torch.randn(shape, generator=gen, device=target.device, dtype=target.dtype)

    sources = source if isinstance(source, (list, tuple)) else [source]
    sources = [torch.as_tensor(s, dtype=target.dtype, device=target.device) for s in sources]
    out = torch.zeros_like(target)
    lo = min(float(s.min()) for s in sources)
    hi = max(float(s.max()) for s in sources)
    for src in sources:
        if mode == "avg":
            out = out + _match_histogram_one(target, src.mean(dim=0, keepdim=True), draw, True) / len(sources)
        else:
            idx = int(torch.randint(0, src.shape[0], (), generator=gen, device=gen.device))
            out = out + _match_histogram_one(target, src[idx : idx + 1], draw, False) / len(sources)
    return torch.clamp(out, lo, hi)
