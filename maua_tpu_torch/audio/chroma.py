"""Chromagrams, their nearest-neighbour smoothing and tonnetz.

Port of `maua_tpu/audio/chroma.py` (chroma_stft, chroma_cqt, chroma_cens,
nn_filter_cosine_median, tonnetz) with librosa's semantics.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .constantq import cqt
from .convert import chroma_filterbank, cq_to_chroma, note_to_hz
from .spectral import stft


def _normalize_cols(x: torch.Tensor, norm: float = np.inf, dim: int = 0) -> torch.Tensor:
    if norm == np.inf:
        mag = x.abs().amax(dim=dim, keepdim=True)
    elif norm == 1:
        mag = x.abs().sum(dim=dim, keepdim=True)
    else:
        mag = x.square().sum(dim=dim, keepdim=True).sqrt()
    return x / mag.clamp_min(1e-10)


def chroma_stft(y: torch.Tensor, sr: float = 22050, n_fft: int = 2048, hop_length: int = 512, n_chroma: int = 12,
                tuning: float = 0.0) -> torch.Tensor:
    """STFT chromagram (librosa.feature.chroma_stft), (n_chroma, T)."""
    S = stft(y, n_fft=n_fft, hop_length=hop_length).abs() ** 2
    fb = torch.as_tensor(chroma_filterbank(sr, n_fft, n_chroma=n_chroma, tuning=tuning), device=y.device)
    return _normalize_cols(fb @ S)


def chroma_cqt(y: torch.Tensor, sr: float = 22050, hop_length: int = 512, fmin: Optional[float] = None,
               n_chroma: int = 12, n_octaves: int = 7, bins_per_octave: int = 36) -> torch.Tensor:
    """CQT chromagram (n_chroma, T)."""
    if fmin is None:
        fmin = note_to_hz("C1")
    n_bins = n_octaves * bins_per_octave
    C = cqt(y, sr=sr, hop_length=hop_length, fmin=fmin, n_bins=n_bins, bins_per_octave=bins_per_octave).abs()
    proj = torch.as_tensor(cq_to_chroma(n_bins, bins_per_octave=bins_per_octave, n_chroma=n_chroma, fmin=fmin),
                           device=y.device)
    return _normalize_cols(proj @ C)


def chroma_cens(y: torch.Tensor, sr: float = 22050, hop_length: int = 512, fmin: Optional[float] = None,
                n_chroma: int = 12, n_octaves: int = 7, bins_per_octave: int = 36,
                win_len_smooth: int = 41) -> torch.Tensor:
    """Chroma Energy Normalized Statistics: l1-normalize, quantize, smooth with Hann."""
    chroma = chroma_cqt(y, sr=sr, hop_length=hop_length, fmin=fmin, n_chroma=n_chroma,
                        n_octaves=n_octaves, bins_per_octave=bins_per_octave)
    chroma = _normalize_cols(chroma, norm=1)
    steps = torch.tensor([0.4, 0.2, 0.1, 0.05], device=y.device)
    quant = ((chroma[None] > steps[:, None, None]) * 0.25).sum(dim=0)
    win = np.hanning(win_len_smooth + 2)[1:-1]
    win = win / win.sum()
    r = len(win) // 2
    qp = F.pad(quant, (r, len(win) - 1 - r))
    # the same sum as the JAX function, window tap by tap, in its order
    smoothed = sum(qp[:, i : i + quant.shape[1]] * float(win[i]) for i in range(len(win)))
    return _normalize_cols(smoothed, norm=2)


def _median_last(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis; an even count averages the two middle values."""
    k = x.shape[-1]
    srt = x.sort(dim=-1).values
    if k % 2:
        return srt[..., k // 2]
    return 0.5 * (srt[..., k // 2 - 1] + srt[..., k // 2])


def nn_neighbours(x: torch.Tensor, k: Optional[int] = None, chunk: int = 2048) -> torch.Tensor:
    """(T, k) indices of the k most cosine-similar other frames of x (d, T),
    most similar first, in row chunks so the (T, T) similarity never
    exists whole. Exact ties go to the lower frame index, as
    `jax.lax.top_k` breaks them, so the choice does not depend on the
    thread count; near-ties (equal up to f32 roundoff) can still fall
    either way between two libraries."""
    t = x.shape[1]
    if k is None:
        k = min(t - 1, int(2 * np.ceil(np.sqrt(t))))
    xn = x / x.norm(dim=0, keepdim=True).clamp_min(1e-10)
    out = []
    for r0 in range(0, t, chunk):
        rows = xn[:, r0 : r0 + chunk].t()  # (c, d)
        sim = rows @ xn  # (c, T)
        idx = torch.arange(rows.shape[0], device=x.device)
        sim[idx, r0 + idx] -= 2.0  # exclude self
        out.append(sim.sort(dim=1, descending=True, stable=True).indices[:, :k])
    return torch.cat(out, dim=0)


def nn_filter_cosine_median(x: torch.Tensor, k: Optional[int] = None, chunk: int = 2048) -> torch.Tensor:
    """Replace each frame of x (d, T) by the median of its k most
    cosine-similar other frames (librosa.decompose.nn_filter)."""
    nbr = nn_neighbours(x, k, chunk)
    return torch.cat([_median_last(x[:, nbr[r0 : r0 + chunk]]) for r0 in range(0, x.shape[1], chunk)], dim=1)


def tonnetz(chroma: torch.Tensor) -> torch.Tensor:
    """Tonal centroids (librosa.feature.tonnetz): (n_chroma, T) -> (6, T)."""
    n_chroma = chroma.shape[0]
    dim_map = np.linspace(0, 12, num=n_chroma, endpoint=False)
    scale = np.asarray([7.0 / 6, 7.0 / 6, 3.0 / 2, 3.0 / 2, 2.0 / 3, 2.0 / 3])
    V = scale[:, None] * dim_map[None, :]
    V[::2] -= 0.5
    R = np.array([1, 1, 1, 1, 0.5, 0.5])
    phi = torch.as_tensor(R[:, None] * np.cos(np.pi * V), dtype=torch.float32, device=chroma.device)
    return phi @ (chroma / chroma.abs().sum(dim=0, keepdim=True).clamp_min(1e-10))
