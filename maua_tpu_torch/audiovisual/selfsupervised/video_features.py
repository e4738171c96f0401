"""Video feature trajectories for judging how a video follows its audio.

Port of `maua_tpu/audiovisual/selfsupervised/video_features.py`: the
fourteen per-frame descriptors (luminance, colour moments, edge energy,
flow magnitude, RGB and HSV histograms, variance, frame differences, the
radial spatial-frequency bands, flow-direction and spectral onsets),
`extract_video_features` and `video_feature_matrix`. Frames are (T, H,
W, 3) in [0, 1] on any device and the descriptors are computed there, but
for the two steps maua_tpu takes from OpenCV on the host, which stay
there: Farneback flow (`flow/models.py`) and the log-polar warp of the
spectrum. `extract_video_features` computes the flows and the spectrum
once each, where maua_tpu computes them for each descriptor that reads
them (the same values). Histograms bin as numpy's `np.histogram` does
(its edges, its closed last bin); quantiles interpolate linearly as
`np.quantile`, by sorting (torch.quantile refuses inputs above 2^24
values).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ...flow.models import farneback_flow
from ...ops.signal import resample_1d


def _gray(frames: torch.Tensor) -> torch.Tensor:
    return 0.2989 * frames[..., 0] + 0.587 * frames[..., 1] + 0.114 * frames[..., 2]


def _remainder(x: torch.Tensor, m: float) -> torch.Tensor:
    """x mod m with numpy's rule (fmod, moved into [0, m)) in x's dtype."""
    r = torch.fmod(x, m)
    return torch.where(r < 0, r + m, r)


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """np.quantile(x, q), linear interpolation over all of x."""
    srt = x.flatten().sort().values
    pos = q * (srt.numel() - 1)
    lo = int(math.floor(pos))
    t = pos - lo
    a, b = srt[lo], srt[min(lo + 1, srt.numel() - 1)]
    diff = b - a
    return b - diff * (1 - t) if t >= 0.5 else a + diff * t


def luminance_envelope(frames: torch.Tensor) -> torch.Tensor:
    """(T,) mean luma per frame."""
    return _gray(frames).mean(dim=(1, 2))


def color_moments(frames: torch.Tensor) -> torch.Tensor:
    """(T, 6) per-channel mean and std."""
    return torch.cat([frames.mean(dim=(1, 2)), frames.std(dim=(1, 2), correction=0)], dim=1)


def edge_energy(frames: torch.Tensor) -> torch.Tensor:
    """(T,) mean gradient magnitude (forward differences, 0 at the last row
    and column)."""
    gray = _gray(frames)
    gx = torch.diff(gray, dim=2, append=gray[:, :, -1:])
    gy = torch.diff(gray, dim=1, append=gray[:, -1:, :])
    return (gx.square() + gy.square()).sqrt().mean(dim=(1, 2))


def _flows(frames: torch.Tensor) -> torch.Tensor:
    """(T - 1, H, W, 2) Farneback flows between consecutive frames, computed
    by OpenCV on the host from the frames' uint8 values."""
    u8 = (frames * 255).to(torch.uint8).cpu().numpy()
    flows = np.stack([farneback_flow(u8[i], u8[i + 1]) for i in range(len(u8) - 1)])
    return torch.from_numpy(flows).to(frames.device)


def _flow_magnitude(flows: torch.Tensor) -> torch.Tensor:
    mags = flows.square().sum(-1).sqrt().mean(dim=(1, 2))
    return torch.cat([mags.new_zeros(1), mags])


def flow_magnitude(frames: torch.Tensor) -> torch.Tensor:
    """(T,) mean optical-flow magnitude, 0 for the first frame."""
    return _flow_magnitude(_flows(frames))


def _histogram_rows(x: torch.Tensor, bins: int, first: np.ndarray, last: np.ndarray,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """np.histogram of each row of x (T, N) over [first[t], last[t]] (every
    value inside it), f32 counts or f32 sums of `weights`: numpy's bin
    index ((x - first) in x's dtype, over last - first in f64, times bins),
    corrected against its f32 edges, the last bin closed."""
    dev = x.device
    first32 = torch.as_tensor(first.astype(np.float32), device=dev)[:, None]
    span = torch.as_tensor(last - first, dtype=torch.float64, device=dev)[:, None]
    idx = ((x - first32).double() / span * bins).long()
    idx = idx - (idx == bins).long()
    edges = torch.as_tensor(np.stack([np.linspace(a, b, bins + 1, dtype=np.float32) for a, b in zip(first, last)]),
                            device=dev)
    idx = idx - (x < edges.gather(1, idx)).long()
    idx = idx + ((x >= edges.gather(1, idx + 1)) & (idx != bins - 1)).long()
    rows = idx + bins * torch.arange(x.shape[0], device=dev)[:, None]
    w = None if weights is None else weights.double().flatten()
    return torch.bincount(rows.flatten(), weights=w, minlength=x.shape[0] * bins).view(x.shape[0], bins).float()


def _histogram(chan: torch.Tensor, bins: int) -> torch.Tensor:
    """Per-frame histogram over the frame's own value range, max-normalized."""
    flat = chan.reshape(chan.shape[0], -1)
    lo = flat.amin(dim=1).double().cpu().numpy()
    hi = flat.amax(dim=1).double().cpu().numpy() + 1e-6
    hist = _histogram_rows(flat, bins, lo, hi)
    return hist / hist.amax(dim=1, keepdim=True).clamp_min(1e-10)


def redogram(frames: torch.Tensor, bins: int = 32) -> torch.Tensor:
    return _histogram(frames[..., 0], bins)


def greenogram(frames: torch.Tensor, bins: int = 32) -> torch.Tensor:
    return _histogram(frames[..., 1], bins)


def blueogram(frames: torch.Tensor, bins: int = 32) -> torch.Tensor:
    return _histogram(frames[..., 2], bins)


def rgb_hist(frames: torch.Tensor, bins: int = 96) -> torch.Tensor:
    b = bins // 3
    return torch.cat([redogram(frames, b), greenogram(frames, b), blueogram(frames, b)], -1)


def _rgb_to_hsv(frames: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) RGB in [0, 1] -> HSV, hue in radians."""
    r, g, b = frames[..., 0], frames[..., 1], frames[..., 2]
    maxc = frames.amax(-1)
    delta = maxc - frames.amin(-1)
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-10), torch.zeros_like(maxc))
    dz = delta.clamp_min(1e-10)
    h = torch.where(maxc == r, _remainder((g - b) / dz, 6.0),
                    torch.where(maxc == g, (b - r) / dz + 2.0, (r - g) / dz + 4.0))
    h = torch.where(delta > 0, h, torch.zeros_like(h)) * (np.pi / 3.0)
    return torch.stack([h, s, maxc], dim=-1)


def huestogram(frames: torch.Tensor, bins: int = 32) -> torch.Tensor:
    return _histogram(_rgb_to_hsv(frames)[..., 0], bins)


def saturogram(frames: torch.Tensor, bins: int = 32) -> torch.Tensor:
    return _histogram(_rgb_to_hsv(frames)[..., 1], bins)


def valueogram(frames: torch.Tensor, bins: int = 32) -> torch.Tensor:
    return _histogram(_rgb_to_hsv(frames)[..., 2], bins)


def hsv_hist(frames: torch.Tensor, bins: int = 96) -> torch.Tensor:
    b = bins // 3
    hsv = _rgb_to_hsv(frames)
    return torch.cat([_histogram(hsv[..., c], b) for c in range(3)], -1)


def visual_variance(frames: torch.Tensor) -> torch.Tensor:
    return frames.reshape(len(frames), -1).var(dim=1, correction=0)[:, None]


def absdiff(frames: torch.Tensor) -> torch.Tensor:
    """Per-frame total absolute change from the previous frame, the last
    value repeated."""
    d = torch.diff(frames, dim=0).abs().reshape(len(frames) - 1, -1).sum(dim=1)
    return torch.cat([d, d[-1:]])[:, None]


def video_spectrogram(frames: torch.Tensor) -> torch.Tensor:
    """Radial spatial-frequency profile per frame: |rfft2| of the quarter
    plane, clamped to its 0.15 and 99.85 % quantiles, warped log-polar by
    OpenCV's linearPolar on the host and averaged over channels and angles,
    (T, F). Where OpenCV has no linearPolar (OpenCV 5 removed it), the
    mean over channels binned by integer radius, as maua_tpu falls back."""
    import cv2

    t, h, w, _ = frames.shape
    freqs = torch.fft.rfft2(frames, dim=(1, 2), norm="forward").abs()[:, : h // 2, : w // 2]
    freqs = freqs.clamp(_quantile(freqs, 0.0015), _quantile(freqs, 0.9985))
    if hasattr(cv2, "linearPolar"):
        host = freqs.cpu().numpy()
        radius = max(h, w) // 4
        polar = np.stack([
            np.stack([cv2.linearPolar(np.ascontiguousarray(host[i, :, :, c]), (0, 0), radius,
                                      cv2.WARP_FILL_OUTLIERS) for c in range(host.shape[-1])], 0)
            for i in range(t)
        ])  # (T, C, angle, radius)
        spec = torch.from_numpy(polar).to(frames.device).mean(dim=(1, 2))
    else:
        yy, xx = np.meshgrid(np.arange(h // 2), np.arange(w // 2), indexing="ij")
        rad = torch.as_tensor(np.sqrt(yy**2 + xx**2).astype(int).ravel(), device=frames.device)
        nb, n_bins = min(h, w) // 2, int(rad.max()) + 1  # n_bins >= nb
        rows = (rad[None] + n_bins * torch.arange(t, device=frames.device)[:, None]).flatten()
        sums = torch.bincount(rows, weights=freqs.mean(-1).double().flatten(), minlength=t * n_bins).view(t, n_bins)
        counts = torch.bincount(rad, minlength=n_bins)
        spec = (sums[:, :nb] / counts[:nb].clamp_min(1)).float()
    return spec[:, 2:]


def _bands(spec: torch.Tensor) -> Dict[str, torch.Tensor]:
    f = spec.shape[1]
    return {"low_freq_rms": spec[:, : f // 3].square().mean(dim=1, keepdim=True),
            "mid_freq_rms": spec[:, f // 3 : 2 * f // 3].square().mean(dim=1, keepdim=True),
            "high_freq_rms": spec[:, 2 * f // 3 :].square().mean(dim=1, keepdim=True)}


def low_freq_rms(frames: torch.Tensor) -> torch.Tensor:
    return _bands(video_spectrogram(frames))["low_freq_rms"]


def mid_freq_rms(frames: torch.Tensor) -> torch.Tensor:
    return _bands(video_spectrogram(frames))["mid_freq_rms"]


def high_freq_rms(frames: torch.Tensor) -> torch.Tensor:
    return _bands(video_spectrogram(frames))["high_freq_rms"]


def _adaptive_freq_rms(spec: torch.Tensor, k: int = 10) -> torch.Tensor:
    k = min(k, spec.shape[1])
    idx = torch.argsort(spec.std(dim=0, correction=0), stable=True)[-k:]
    return spec[:, idx].square().mean(dim=1, keepdim=True)


def adaptive_freq_rms(frames: torch.Tensor, k: int = 10) -> torch.Tensor:
    return _adaptive_freq_rms(video_spectrogram(frames), k)


def directogram(flow: torch.Tensor, bins: int = 8) -> torch.Tensor:
    """Magnitude-weighted flow-direction histogram per frame, 3-tap
    median-smoothed along time."""
    mag = flow.square().sum(-1).sqrt().reshape(len(flow), -1)
    ang = _remainder(torch.atan2(flow[..., 1], flow[..., 0]), 2 * np.pi).reshape(len(flow), -1)
    n = len(flow)
    dg = _histogram_rows(ang, bins, np.zeros(n), np.full(n, 2 * np.pi), weights=mag)
    if len(dg) >= 3:
        padded = torch.cat([dg[:1], dg, dg[-1:]])
        dg = torch.stack([padded[:-2], padded[1:-1], padded[2:]]).median(dim=0).values
    return dg


def spectral_flux(spec: torch.Tensor) -> torch.Tensor:
    return torch.diff(spec, dim=0, append=spec.new_zeros(1, spec.shape[1]))


def onset_envelope(flux: torch.Tensor) -> torch.Tensor:
    """Half-wave-rectified flux summed per frame, clamped to its 2.5 and
    97.5 % quantiles, scaled to [0, 1]."""
    u = (0.5 * (flux + flux.abs())).sum(dim=1)
    u = u.clamp(_quantile(u, 0.025), _quantile(u, 0.975))
    u = u - u.min()
    return u / u.max().clamp_min(1e-10)


def _flow_onsets(flows: torch.Tensor) -> torch.Tensor:
    onset = onset_envelope(spectral_flux(directogram(flows)))
    return torch.cat([onset[:1], onset])[:, None]


def video_flow_onsets(frames: torch.Tensor) -> torch.Tensor:
    return _flow_onsets(_flows(frames))


def video_spectral_onsets(frames: torch.Tensor) -> torch.Tensor:
    return onset_envelope(spectral_flux(video_spectrogram(frames)))[:, None]


def extract_video_features(frames, n_frames_out: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """frames (T, H, W, 3) in [0, 1] (a tensor, or an array taken to the CPU)
    -> {descriptor: (T, F)} on the frames' device, resampled to
    `n_frames_out` frames when given."""
    frames = torch.as_tensor(frames)
    spec = video_spectrogram(frames)
    flows = _flows(frames)
    feats = {
        "luminance": luminance_envelope(frames)[:, None],
        "color": color_moments(frames),
        "edges": edge_energy(frames)[:, None],
        "flow": _flow_magnitude(flows)[:, None],
        "rgb_hist": rgb_hist(frames),
        "hsv_hist": hsv_hist(frames),
        "visual_variance": visual_variance(frames),
        "absdiff": absdiff(frames),
        **_bands(spec),
        "adaptive_freq_rms": _adaptive_freq_rms(spec),
        "flow_onsets": _flow_onsets(flows),
        "spectral_onsets": onset_envelope(spectral_flux(spec))[:, None],
    }
    if n_frames_out is not None:
        feats = {k: resample_1d(v, n_frames_out) for k, v in feats.items()}
    return feats


def video_feature_matrix(frames, n_frames_out: Optional[int] = None) -> torch.Tensor:
    return torch.cat(list(extract_video_features(frames, n_frames_out).values()), dim=1)
