"""Pitch tracking: piptrack and tuning estimation.

Port of `maua_tpu/audio/pitch.py` (piptrack, pitch_tuning,
estimate_tuning, pitch_track_envelope) with librosa's parabolic
interpolation of spectral peaks.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .spectral import stft


def piptrack(y: torch.Tensor, sr: float = 22050, n_fft: int = 2048, hop_length: int = 512, fmin: float = 150.0,
             fmax: float = 4000.0, threshold: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parabolic-interpolated pitches and magnitudes of the spectral peaks,
    both (1 + n_fft // 2, T)."""
    S = stft(y, n_fft=n_fft, hop_length=hop_length).abs()
    fft_freqs = torch.as_tensor(np.linspace(0, sr / 2, 1 + n_fft // 2, dtype=np.float32), device=S.device)
    up, down = torch.roll(S, -1, dims=0), torch.roll(S, 1, dims=0)
    avg = 0.5 * (up - down)
    shift = 2 * S - up - down
    shift = avg / torch.where(shift.abs() < 1e-10, torch.ones_like(shift), shift)
    avg[0] = avg[-1] = 0
    shift[0] = shift[-1] = 0
    freq_mask = (fft_freqs >= fmin) & (fft_freqs <= fmax)
    ref = threshold * S.amax(dim=0, keepdim=True)
    peaks = (S > ref) & (S > down) & (S >= up) & freq_mask[:, None]
    bins = torch.arange(S.shape[0], device=S.device)[:, None] + shift
    zero = torch.zeros_like(S)
    return torch.where(peaks, bins * sr / n_fft, zero), torch.where(peaks, S + 0.5 * avg * shift, zero)


def pitch_tuning(frequencies: torch.Tensor, resolution: float = 0.01, bins_per_octave: int = 12) -> torch.Tensor:
    """Tuning offset in fractional bins from a set of frequencies
    (librosa.pitch_tuning); 0 frequencies do not count."""
    f = torch.where(frequencies > 0, frequencies, torch.full_like(frequencies, 440.0))
    residual = torch.remainder(bins_per_octave * torch.log2(f / (440.0 / 16)), 1.0)
    residual = torch.where(residual >= 0.5, residual - 1.0, residual)
    weights = (frequencies > 0).float()
    bins = torch.linspace(-0.5, 0.5, int(np.ceil(1.0 / resolution)) + 1, device=f.device)
    idx = (torch.searchsorted(bins, residual.reshape(-1).contiguous()) - 1).clamp(0, len(bins) - 2)
    counts = torch.zeros(len(bins) - 1, device=f.device).index_add_(0, idx, weights.reshape(-1))
    return bins[counts.argmax()]


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x where mask holds (the two middle values averaged, as
    numpy's nanmedian does), nan where it holds nowhere; no host sync."""
    srt = torch.where(mask, x, torch.full_like(x, torch.inf)).reshape(-1).sort().values
    n = mask.sum()
    mid = 0.5 * (srt[((n - 1) // 2).clamp_min(0)] + srt[(n // 2).clamp_max(srt.numel() - 1)])
    return torch.where(n > 0, mid, torch.full_like(mid, torch.nan))


def estimate_tuning(y: torch.Tensor, sr: float = 22050, n_fft: int = 2048, resolution: float = 0.01,
                    **kwargs) -> torch.Tensor:
    """Tuning of the pitches whose magnitude is at least the median's."""
    pitches, mags = piptrack(y, sr=sr, n_fft=n_fft, **kwargs)
    pos = pitches > 0
    sel = pos & (mags >= torch.nan_to_num(masked_median(mags, pos)))
    return pitch_tuning(torch.where(sel, pitches, torch.zeros_like(pitches)), resolution=resolution)


def pitch_track_envelope(y: torch.Tensor, sr: float = 22050, **kwargs) -> torch.Tensor:
    """Magnitude-weighted average pitch of each frame."""
    pitches, mags = piptrack(y, sr=sr, **kwargs)
    w = mags + 1e-8
    return (pitches * w).sum(dim=0) / w.sum(dim=0)
