"""Music-information features of the audio-reactive path.

Port of `onset_ensemble`, `onsets` and `chroma` from
`maua_tpu/audio/mir.py`. The onset ensemble is the mean of five
normalized onset detection functions on a log-filtered STFT magnitude.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.signal import percentile_clip
from . import chroma as _chroma
from .spectral import harmonic, percussive, stft


@functools.lru_cache(maxsize=None)
def _log_filterbank(sr: float, n_fft: int, bands_per_octave: int = 24, fmin: float = 30.0,
                    fmax: float = 17000.0) -> np.ndarray:
    """Triangular filterbank on a log frequency axis (madmom LogarithmicFilterbank)."""
    fmax = min(fmax, sr / 2)
    n_oct = np.log2(fmax / fmin)
    n_bands = int(np.floor(n_oct * bands_per_octave)) + 2
    centers = fmin * 2.0 ** (np.arange(n_bands) / bands_per_octave)
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    bins = np.unique(np.round(centers / (sr / n_fft)).astype(int))
    bins = bins[(bins > 0) & (bins < len(fftfreqs))]
    fb = np.zeros((len(bins) - 2, 1 + n_fft // 2), np.float32)
    for i in range(len(bins) - 2):
        lo, mid, hi = bins[i], bins[i + 1], bins[i + 2]
        if mid > lo:
            fb[i, lo:mid] = np.linspace(0, 1, mid - lo, endpoint=False)
        if hi > mid:
            fb[i, mid:hi] = np.linspace(1, 0, hi - mid, endpoint=False)
    return fb


def onset_ensemble(y: torch.Tensor, sr: float, n_fft: int = 2048, hop_length: int = 512) -> torch.Tensor:
    """Mean of five normalized onset detection functions: spectral diff,
    spectral flux, superflux, complex flux and modified KL."""
    D = stft(y, n_fft=n_fft, hop_length=hop_length)
    mag = D.abs()
    phase = D.angle()
    fb = torch.as_tensor(_log_filterbank(float(sr), n_fft), device=y.device)
    filt = (fb @ mag).t()  # (T, bands)
    log_filt = torch.log10(1.0 + 5.0 * filt)

    spectral_diff = torch.diff(filt, dim=0).clamp_min(0).square().sum(dim=1)
    spectral_flux = torch.diff(log_filt, dim=0).clamp_min(0).sum(dim=1)
    pad = torch.cat([log_filt[:, :1], log_filt, log_filt[:, -1:]], dim=1)
    maxfilt = torch.maximum(torch.maximum(pad[:, :-2], pad[:, 1:-1]), pad[:, 2:])
    superflux = (log_filt[2:] - maxfilt[:-2]).clamp_min(0).sum(dim=1)
    superflux = torch.cat([superflux[:1], superflux])
    mag_t, phase_t = mag.t(), phase.t()
    target_phase = 2 * phase_t[1:-1] - phase_t[:-2]
    d_re = mag_t[2:] * torch.cos(phase_t[2:]) - mag_t[1:-1] * torch.cos(target_phase)
    d_im = mag_t[2:] * torch.sin(phase_t[2:]) - mag_t[1:-1] * torch.sin(target_phase)
    cdev = torch.sqrt(d_re * d_re + d_im * d_im)
    complex_flux = (fb @ cdev.t()).t().sum(dim=1)
    complex_flux = torch.cat([complex_flux[:1], complex_flux])
    mkl = torch.log(1.0 + filt[1:] / (filt[:-1] + 0.03)).sum(dim=1)

    feats = [spectral_diff, spectral_flux, superflux, complex_flux, mkl]
    T = min(f.shape[0] for f in feats)
    stack = torch.stack([f[:T] / f[:T].max().clamp_min(1e-10) for f in feats])
    return stack.mean(dim=0)


def onsets(audio: torch.Tensor, sr, prepercussive: int = 4) -> torch.Tensor:
    """Onset envelope: optional percussive pre-separation, the flux
    ensemble, then a 95th-peak-percentile clip."""
    y = audio
    if prepercussive:
        y = percussive(y, margin=float(prepercussive))
    return percentile_clip(onset_ensemble(y, sr), 95.0)


def chroma(audio: torch.Tensor, sr, nearest_neighbor: bool = True, preharmonic: int = 4,
           notes: int = 12) -> torch.Tensor:
    """CENS chromagram of the harmonic component, (T, notes) in [0, 1]."""
    y = audio
    if preharmonic:
        y = harmonic(y, margin=float(preharmonic))
    ch = _chroma.chroma_cens(y, sr=sr)
    if nearest_neighbor:
        ch = torch.minimum(ch, _chroma.nn_filter_cosine_median(ch))
    ch = ch.t()
    if notes < 12:
        order = torch.argsort(-ch.sum(dim=0))
        ch = ch[:, order[:notes]]
    ch = ch - ch.min()
    return ch / (ch.max() + 1e-8)
