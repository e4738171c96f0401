"""Image tensor ops: tiling with blended seams, resampling, sharpening and
colour matching.

Port of `maua_tpu/ops/image.py`: smoothstep, blend_weight1d, destitch,
restitch, scaled_height_width, resample, sharpen, match_histogram, the
colour spaces (luminance, rgb_to_ycbcr, ycbcr_to_rgb, original_colors),
local statistics (local_std, immerkaer), blurs and sharpening
(gaussian_blur, unsharp_mask), color_balance, normalize_minmax, positive,
wrapping_slice and the blur maps (blurriness_lbp, blurriness_svd). Images
are NHWC tensors, as in maua_tpu, in [-1, 1] unless noted; the
convolutions and resizes run NCHW inside. `resample` is lanczos3 with
antialias (`jax.image.resize`'s weights, `ops/warp.resize`).
`match_histogram` draws its 1e-3 jitter from a torch.Generator, or takes
the draws from `noise`.
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


def luminance(x: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma of an NHWC image."""
    return 0.2126 * x[..., 0] + 0.7152 * x[..., 1] + 0.0722 * x[..., 2]


_RGB2YCBCR = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5], [0.5, -0.418688, -0.081312]], np.float32)
_YCBCR2RGB = np.linalg.inv(_RGB2YCBCR.astype(np.float64)).astype(np.float32)
_CHROMA_OFFSET = (0.0, 0.5, 0.5)


def rgb_to_ycbcr(x: torch.Tensor) -> torch.Tensor:
    m = torch.as_tensor(_RGB2YCBCR, dtype=x.dtype, device=x.device)
    return x @ m.T + torch.tensor(_CHROMA_OFFSET, dtype=x.dtype, device=x.device)


def ycbcr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    m = torch.as_tensor(_YCBCR2RGB, dtype=x.dtype, device=x.device)
    return (x - torch.tensor(_CHROMA_OFFSET, dtype=x.dtype, device=x.device)) @ m.T


def original_colors(content: torch.Tensor, generated: torch.Tensor) -> torch.Tensor:
    """The generated image's luma with the content's chroma, both NHWC in [0, 1] (the content
    resampled to the generated image's size first)."""
    if content.shape != generated.shape:
        content = resample(content, generated.shape[1:3])
    merged = torch.cat([rgb_to_ycbcr(generated)[..., :1], rgb_to_ycbcr(content)[..., 1:]], dim=-1)
    return ycbcr_to_rgb(merged).clamp(0.0, 1.0)


def local_std(im: torch.Tensor, ks: int = 9) -> torch.Tensor:
    """Windowed standard deviation of an NHWC image over a ks x ks window and all channels,
    reflect-padded: (B, H, W, 1). (maua_tpu's grouped conv takes only one channel: its kernel
    has C input features where C groups need 1; ROADMAP C8.)"""
    r = ks // 2
    x = F.pad(im.permute(0, 3, 1, 2), (r, r, r, r), mode="reflect")
    c = x.shape[1]
    ones = torch.ones(c, 1, ks, ks, dtype=x.dtype, device=x.device)

    def box(v):
        return F.conv2d(v, ones, groups=c).sum(1, keepdim=True)

    s, s2, ns = box(x), box(x * x), box(torch.ones_like(x))
    return torch.sqrt(((s2 - s**2 / ns) / ns).clamp_min(0.0)).permute(0, 2, 3, 1)


def wrapping_slice(tensor: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """A circular slice along axis 0."""
    if tensor.shape[0] == 1:
        return tensor[torch.zeros(1, dtype=torch.long, device=tensor.device)]
    return tensor[(torch.arange(length, device=tensor.device) + start) % tensor.shape[0]]


def immerkaer(image_batch: torch.Tensor) -> torch.Tensor:
    """Immerkaer's fast noise-variance estimate per image of (B, H, W, C): sqrt(pi / 2) /
    (6 (W - 2)(H - 2)) sum |I * L|, L the 3x3 noise-sensitive Laplacian, on the luma (C = 3) or
    the first channel."""
    x = luminance(image_batch) if image_batch.shape[-1] == 3 else image_batch[..., 0]
    lap = torch.tensor([[1.0, -2.0, 1.0], [-2.0, 4.0, -2.0], [1.0, -2.0, 1.0]], dtype=x.dtype, device=x.device)
    conv = F.conv2d(x[:, None], lap[None, None])[:, 0]
    h, w = x.shape[1], x.shape[2]
    return math.sqrt(math.pi / 2.0) * conv.abs().sum((1, 2)) / (6.0 * (w - 2) * (h - 2))


def _gaussian_kernel1d(ks: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(ks, dtype=torch.float32, device=device) - (ks - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, ks=(7, 7), sigma: float = 1.0) -> torch.Tensor:
    """Separable gaussian blur of (B, H, W, C), reflect-padded."""
    kh = _gaussian_kernel1d(ks[0], sigma, img.device).to(img.dtype)
    kw = _gaussian_kernel1d(ks[1], sigma, img.device).to(img.dtype)
    b, h, w, c = img.shape
    x = img.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    rh, rw = ks[0] // 2, ks[1] // 2
    x = F.pad(x, (rw, rw, rh, rh), mode="reflect")
    x = F.conv2d(x, kh[None, None, :, None])
    x = F.conv2d(x, kw[None, None, None, :])
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)


def unsharp_mask(img: torch.Tensor, ks=(7, 7), sigma: float = 1.0, amount: float = 1.0,
                 thresh: float = 0.25) -> torch.Tensor:
    """Unsharp masking with a low-contrast mask: (B, H, W, C) in the uint8 range [0, 255] in,
    the same range out, rounded, with pixels whose |img - blur| < thresh left as they were."""
    img = torch.as_tensor(img).float()
    blurred = gaussian_blur(img, ks, sigma)
    sharpened = torch.round(((amount + 1.0) * img - amount * blurred).clamp(0.0, 255.0))
    if thresh > 0:
        sharpened = torch.where((img - blurred).abs() < thresh, img, sharpened)
    return sharpened


def color_balance(img: torch.Tensor, percent: float) -> torch.Tensor:
    """Simplest colour balance of an (H, W, 3) uint8-range image: each channel clipped at its
    percent / 2 low and high quantiles (linear interpolation, as jnp.quantile) and rescaled to
    [0, 255], rounded."""
    img = torch.as_tensor(img).float()
    flat = img.reshape(-1, img.shape[-1])
    q = torch.tensor([percent / 200.0, 1.0 - percent / 200.0], dtype=torch.float32, device=img.device)
    lo, hi = torch.quantile(flat, q, dim=0)
    out = (img - lo) / torch.clamp_min(hi - lo, 1e-8) * 255.0
    return torch.round(out.clamp(0.0, 255.0))


def positive(x: torch.Tensor) -> torch.Tensor:
    return (x > 0).float()


def normalize_minmax(img: torch.Tensor) -> torch.Tensor:
    """Min-max normalisation to [0, 1]."""
    img = torch.as_tensor(img).float()
    return (img - img.min()) / torch.clamp_min(img.max() - img.min(), 1e-12)


def _box_sum(x: torch.Tensor, ks: int) -> torch.Tensor:
    """maua_tpu's integral-image window sum of (H, W): edge padding of radius (ks - 1) // 2, then a
    (ks - 1) x (ks - 1) window sum offset one short of centred."""
    n, r = ks - 1, (ks - 1) // 2
    p = F.pad(x[None, None], (r, n - 1 - r, r, n - 1 - r), mode="replicate")
    return F.conv2d(p, torch.ones(1, 1, n, n, dtype=x.dtype, device=x.device))[0, 0]


def blurriness_lbp(im_gray: torch.Tensor, ks: int, thresh: float) -> torch.Tensor:
    """Local-binary-pattern sharpness map of (H, W): 8-neighbour LBP codes (diagonals bilinearly
    interpolated at radius sqrt(2) / 2), non-uniform patterns (U > 2) mapped to 9, sharpness the
    windowed density of codes 6-9."""
    I = normalize_minmax(im_gray)
    pt = F.pad(I[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    right, left = pt[1:-1, 2:], pt[1:-1, :-2]
    above, below = pt[:-2, 1:-1], pt[2:, 1:-1]
    above_right, above_left = pt[:-2, 2:], pt[:-2, :-2]
    below_right, below_left = pt[2:, 2:], pt[2:, :-2]

    q = math.sqrt(2) / 2
    interp1 = (1 - q) * ((1 - q) * I + q * right) + q * ((1 - q) * above + q * above_right)
    interp3 = (1 - q) * ((1 - q) * I + q * left) + q * ((1 - q) * above + q * above_left)
    interp5 = (1 - q) * ((1 - q) * I + q * left) + q * ((1 - q) * below + q * below_left)
    interp7 = (1 - q) * ((1 - q) * I + q * right) + q * ((1 - q) * below + q * below_right)

    s = [positive(nb - I - thresh) for nb in (right, interp1, above, interp3, left, interp5, below, interp7)]
    U = sum((s[(i + 1) % 8] - s[i]).abs() for i in range(8))
    lbpmap = torch.where(U > 2, 9.0, sum(s))
    return _box_sum((lbpmap >= 6).float(), ks) / float(ks) ** 2


def blurriness_svd(img: torch.Tensor, kr: int = 10, sv_num: int = 3) -> torch.Tensor:
    """Windowed-SVD blur map of (H, W): each pixel's 2kr x 2kr reflect-padded patch, the share of
    its top sv_num singular values, min-max inverted to [0, 1]."""
    h, w = img.shape
    x = F.pad(torch.as_tensor(img).float()[None, None], (kr, kr, kr, kr), mode="reflect")[0, 0]
    ks = kr * 2
    patches = torch.stack([x[y:y + h, xx:xx + w] for y in range(ks) for xx in range(ks)], dim=-1)
    sv = torch.linalg.svdvals(patches.reshape(h * w, ks, ks))
    degrees = sv[:, :sv_num].sum(1) / torch.clamp_min(sv.sum(1), 1e-12)
    max_sv, min_sv = degrees.min(), degrees.max()  # the names as maua_tpu has them: the map is inverted
    return ((degrees - min_sv) / (max_sv - min_sv)).reshape(h, w)
