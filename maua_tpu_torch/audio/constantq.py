"""Constant-Q / variable-Q transform, multirate with early downsampling.

Port of `maua_tpu/audio/constantq.py` (vqt, cqt, pseudo_cqt, decimate2,
wavelet_basis): per octave, the frames are correlated with that
octave's time-domain wavelets in one matrix product, then the signal is
halved in rate (anti-aliased) and the hop with it.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .convert import cqt_frequencies, note_to_hz
from .spectral import frame, stft


@functools.lru_cache(maxsize=None)
def _lowpass_kernel(numtaps: int = 64, cutoff: float = 0.5) -> np.ndarray:
    """Kaiser-windowed half-band lowpass for decimation by 2."""
    from scipy.signal import firwin

    return firwin(numtaps + 1, cutoff, window=("kaiser", 8.0)).astype(np.float32)


def reflect_pad(y: torch.Tensor, r: int) -> torch.Tensor:
    """Reflect-pad a 1-D signal by r on both sides, reflecting again where
    r exceeds the length (numpy's "reflect", which the JAX functions use)."""
    n = y.shape[-1]
    idx = torch.arange(-r, n + r, device=y.device)
    if n == 1:
        return y[torch.zeros_like(idx)]
    period = 2 * (n - 1)
    idx = idx.abs() % period
    return y[torch.where(idx >= n, period - idx, idx)]


def decimate2(y: torch.Tensor) -> torch.Tensor:
    """Anti-aliased downsample of a 1-D signal by 2 (FIR, reflect-padded)."""
    if y.dim() != 1:
        raise NotImplementedError("decimate2 expects 1-D input")
    k = torch.as_tensor(_lowpass_kernel(), device=y.device)
    r = k.shape[0] // 2
    out = F.conv1d(reflect_pad(y, r)[None, None], k.flip(0)[None, None])[0, 0]  # convolution, as np.convolve
    return out[::2]


def wavelet_basis(freqs: np.ndarray, sr: float, Q: float, gamma: float = 0.0,
                  alpha: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray, int]:
    """Frequency-domain complex wavelet filterbank: (basis (n_bins, 1 + n_fft // 2),
    lengths, n_fft); rows are FFTs of l1-normalized Hann-windowed exponentials."""
    if alpha is None:
        alpha = 2.0 ** (1.0 / 12) - 1
    lengths = Q * sr / (freqs + gamma / alpha)
    n_fft = int(2.0 ** np.ceil(np.log2(lengths.max())))
    basis = np.zeros((len(freqs), n_fft), np.complex64)
    for i, (f, l) in enumerate(zip(freqs, lengths)):
        li = int(np.floor(l))
        t = np.arange(li) - li // 2
        sig = np.exp(2j * np.pi * f * t / sr)
        win = 0.5 - 0.5 * np.cos(2 * np.pi * (np.arange(li) + 0.5) / li)
        sig = sig * win
        sig = sig / np.sum(np.abs(sig))
        start = (n_fft - li) // 2
        basis[i, start : start + li] = sig
    fft_basis = np.fft.fft(basis * lengths[:, None] / n_fft, axis=1)[:, : 1 + n_fft // 2]
    return fft_basis.astype(np.complex64), lengths, n_fft


@functools.lru_cache(maxsize=None)
def _time_basis(freqs: Tuple[float, ...], sr: float, Q: float, gamma: float, alpha: float):
    """The octave's wavelets in the time domain, (n_fft, 2 * bins) with the
    real parts first: the DFT of the zero-padded half spectrum of
    `wavelet_basis`, so frames @ basis is the octave's response."""
    basis, lengths, n_fft = wavelet_basis(np.asarray(freqs), sr, Q, gamma=gamma, alpha=alpha)
    half = np.zeros((len(lengths), n_fft), np.complex128)
    half[:, : 1 + n_fft // 2] = basis
    Wt = np.fft.fft(half, axis=1)
    wk = np.concatenate([Wt.real.astype(np.float32), Wt.imag.astype(np.float32)], 0).T
    return np.ascontiguousarray(wk), lengths, n_fft


def vqt(y: torch.Tensor, sr: float = 22050, hop_length: int = 512, fmin: Optional[float] = None,
        n_bins: int = 84, bins_per_octave: int = 12, gamma: float = 0.0, filter_scale: float = 1.0,
        scale: bool = True) -> torch.Tensor:
    """Variable-Q transform of a 1-D signal, complex (n_bins, T)."""
    if fmin is None:
        fmin = note_to_hz("C1")
    n_octaves = int(math.ceil(n_bins / bins_per_octave))
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    alpha = 2.0 ** (1.0 / bins_per_octave) - 1
    Q = filter_scale / alpha

    responses = []
    my, msr, mhop = y, float(sr), hop_length
    for octv in range(n_octaves):
        hi = n_bins - bins_per_octave * octv
        lo = max(hi - bins_per_octave, 0)
        wk, lengths, n_fft = _time_basis(tuple(freqs[lo:hi]), msr, Q, gamma, alpha)
        yp = reflect_pad(my, n_fft // 2)
        out = (frame(yp, n_fft, mhop, time_major=True) @ torch.as_tensor(wk, device=y.device)).t()
        re, im = out.chunk(2, dim=0)
        responses.append((torch.complex(re, im), np.asarray(lengths)))
        if mhop % 2 == 0 and octv < n_octaves - 1 and my.shape[-1] >= 2 * n_fft:
            my = decimate2(my) * np.sqrt(2.0)
            msr /= 2.0
            mhop //= 2
    min_t = min(r.shape[-1] for r, _ in responses)
    C = torch.cat([r[:, :min_t] for r, _ in reversed(responses)], dim=0)[-n_bins:]
    all_lengths = np.concatenate([l for _, l in reversed(responses)])[-n_bins:]
    if scale:
        C = C / torch.as_tensor(np.sqrt(all_lengths), dtype=torch.float32, device=y.device)[:, None]
    return C


def cqt(y: torch.Tensor, sr: float = 22050, hop_length: int = 512, fmin: Optional[float] = None,
        n_bins: int = 84, bins_per_octave: int = 12, filter_scale: float = 1.0, scale: bool = True) -> torch.Tensor:
    """Constant-Q transform: the VQT with gamma 0."""
    return vqt(y, sr, hop_length, fmin, n_bins, bins_per_octave, gamma=0.0, filter_scale=filter_scale, scale=scale)


def pseudo_cqt(y: torch.Tensor, sr: float = 22050, hop_length: int = 512, fmin: Optional[float] = None,
               n_bins: int = 84, bins_per_octave: int = 12) -> torch.Tensor:
    """Single-resolution CQT approximation: the magnitudes of the CQT filterbank applied to the magnitude
    STFT at the longest filter's n_fft (librosa's pseudo_cqt), (n_bins, frames)."""
    if fmin is None:
        fmin = note_to_hz("C1")
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    Q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1)
    basis, _, n_fft = wavelet_basis(freqs, sr, Q)
    mag_basis = torch.as_tensor(np.abs(basis), device=y.device)
    return mag_basis @ torch.abs(stft(y, n_fft=n_fft, hop_length=hop_length))
