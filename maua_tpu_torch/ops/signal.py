"""Time-axis signal ops for audio-reactive envelopes (time is axis 0).

Port of `maua_tpu/ops/signal.py`: linear resampling (`resample`, the
reference's name, is `resample_1d`), min-max normalization, the
reference's percentile, peak-percentile clipping, compression (and its
alias `expand`), causal or
circular gaussian smoothing and peak emphasis, on tensors of any device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .warp import _reflect_index


def resample_1d(x: torch.Tensor, size: int) -> torch.Tensor:
    """Linearly resample axis 0 to `size` samples (F.interpolate linear,
    align_corners=False: sample i reads position (i + 0.5) * T_in / size - 0.5)."""
    t_in = x.shape[0]
    pos = (torch.arange(size, dtype=torch.float32, device=x.device) + 0.5) * (t_in / size) - 0.5
    pos = pos.clamp(0.0, t_in - 1)
    lo = torch.floor(pos).long()
    hi = (lo + 1).clamp_max(t_in - 1)
    frac = (pos - lo).reshape((size,) + (1,) * (x.dim() - 1))
    xf = x.float()
    return xf[lo] * (1 - frac) + xf[hi] * frac


# the reference's name for it
resample = resample_1d


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Min-max normalize to [0, 1]."""
    y = x - x.min()
    return y / y.max()


def percentile(signal: torch.Tensor, p: float) -> torch.Tensor:
    """The k-th smallest value, k = 1 + round(0.01 * p * (n - 1)) (the reference's kthvalue rounding)."""
    flat = signal.reshape(-1)
    k = 1 + int(round(0.01 * float(p) * (flat.shape[0] - 1)))
    return torch.sort(flat).values[k - 1]


def percentile_clip(signal: torch.Tensor, percent: float = 95.0) -> torch.Tensor:
    """Clip each channel at the `percent` percentile of its strict local
    maxima (k = 1 + round(0.01 * p * (n - 1)) of the sorted peaks), then
    divide by the channel max. Accepts (T,) or (T, C)."""
    squeeze = signal.dim() < 2
    sig = signal[:, None] if squeeze else signal
    t = sig.shape[0]
    idx = torch.arange(t, device=sig.device)
    plus = sig[(idx + 1).clamp(0, t - 1)]
    minus = sig[(idx - 1).clamp(0, t - 1)]
    peaks = (sig > plus) & (sig > minus)
    big = torch.finfo(torch.float32).max
    srt = torch.where(peaks, sig, torch.full_like(sig, big)).sort(dim=0).values
    n = peaks.sum(dim=0).clamp_min(1)
    k = 1 + torch.round(0.01 * percent * (n - 1)).long()
    cutoff = srt.gather(0, (k - 1)[None]).squeeze(0)
    out = torch.minimum(sig.clamp_min(0.0), cutoff[None])
    out = out / out.max(dim=0, keepdim=True).values
    return out[:, 0] if squeeze else out


def compress(signal: torch.Tensor, threshold: float, ratio: float, invert: bool = False) -> torch.Tensor:
    """Multiply values above (below, if invert) threshold by ratio, then normalize."""
    cond = signal < threshold if invert else signal > threshold
    return normalize(torch.where(cond, signal * ratio, signal))


def expand(signal, threshold, ratio, invert=False):
    return compress(signal, threshold, ratio, invert)


def _pad_time(x: torch.Tensor, radius: int, mode: str) -> torch.Tensor:
    """Pad the last axis of (1, C, T). "reflect" follows numpy's rule, which
    holds for a pad of any size (F.pad's needs radius < T)."""
    if mode == "reflect":
        t = x.shape[-1]
        return x[..., _reflect_index(torch.arange(-radius, t + radius, device=x.device), t)]
    if mode not in ("circular", "replicate"):
        raise ValueError(f"unknown pad mode {mode}")
    return F.pad(x, (radius, radius), mode=mode)


def gaussian_filter(x: torch.Tensor, sigma: float, causal=None, mode: str = "circular") -> torch.Tensor:
    """Gaussian smoothing along axis 0.

    `causal` scales the future half of the kernel (0 = fully causal).
    The radius is min(int(4 * sigma), 3 * T); a radius above T pads by T
    in `mode` and the rest by replicating the edge."""
    if sigma <= 0:
        return x
    shape = x.shape
    t = shape[0]
    radius = min(int(sigma * 4), 3 * t)
    if radius == 0:
        return x
    flat = x.reshape(t, -1).float()
    k = torch.arange(-radius, radius + 1, dtype=torch.float32, device=x.device)
    kernel = torch.exp(-0.5 / sigma**2 * k**2)
    if causal is not None:
        kernel[radius + 1 :] *= causal if isinstance(causal, float) else 0.0
    kernel = kernel / kernel.sum()
    lhs = flat.t()[None]  # (1, C, T)
    if radius > t:
        padded = _pad_time(_pad_time(lhs, t, mode), radius - t, "replicate")
    else:
        padded = _pad_time(lhs, radius, mode)
    c = flat.shape[1]
    out = F.conv1d(padded, kernel.view(1, 1, -1).repeat(c, 1, 1), groups=c)
    return out[0].t().reshape(shape)


def emphasize(x: torch.Tensor, strength: float, percentile_p: float = 75.0) -> torch.Tensor:
    """Accentuate peaks: x + strength * (x - baseline) above the
    `percentile_p` percentile of all of x (linear interpolation, as
    jnp.percentile), then normalize."""
    base = torch.quantile(x.float().flatten(), percentile_p / 100.0)
    return normalize(x + strength * (x - base).clamp_min(0.0))
