"""Music-information features with the reference's signatures.

Port of `maua_tpu/audio/mir.py`: onset_ensemble, onsets ("mm" flux
ensemble or "rosa" onset strength), volume, chroma (cens, cqt, stft),
tonnetz, pitch_track, spectral_max, pitch_dominance, pulse, tempo and
laplacian_segmentation. The onset ensemble is the mean of five
normalized onset detection functions on a log-filtered STFT magnitude.
`tempo` reads the onset autocorrelation back to the host to pick its
candidates, as the JAX function does.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ..ops.signal import percentile_clip
from . import beat as _beat
from . import chroma as _chroma
from . import pitch as _pitch
from . import segment as _segment
from .convert import tempo_frequencies
from .spectral import harmonic, melspectrogram, percussive, rms, stft


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


def onsets(audio: torch.Tensor, sr, type: str = "mm", prepercussive: int = 4) -> torch.Tensor:
    """Onset envelope: optional percussive pre-separation, the flux
    ensemble ("mm") or the mel onset strength ("rosa"), then a
    95th-peak-percentile clip."""
    y = audio
    if prepercussive:
        y = percussive(y, margin=float(prepercussive))
    onset = _beat.onset_strength(y, sr=sr) if type == "rosa" else onset_ensemble(y, sr)
    return percentile_clip(onset, 95.0)


def volume(audio: torch.Tensor, sr) -> torch.Tensor:
    """RMS envelope normalized to [0, 1]."""
    vol = rms(audio)
    vol = vol - vol.min()
    return vol / vol.max().clamp_min(1e-10)


def chroma(audio: torch.Tensor, sr, type: str = "cens", nearest_neighbor: bool = True, preharmonic: int = 4,
           notes: int = 12) -> torch.Tensor:
    """Chromagram (cens, cqt or stft) of the harmonic component, (T, notes) in [0, 1]."""
    y = audio
    if preharmonic:
        y = harmonic(y, margin=float(preharmonic))
    if type == "cqt":
        ch = _chroma.chroma_cqt(y, sr=sr)
    elif type == "stft":
        ch = _chroma.chroma_stft(y, sr=sr)
    else:
        if type != "cens":
            print(f"chroma type {type} not available, options are [cens, cqt, stft]. defaulting to cens...")
        ch = _chroma.chroma_cens(y, sr=sr)
    if nearest_neighbor:
        ch = torch.minimum(ch, _chroma.nn_filter_cosine_median(ch))
    ch = ch.t()
    if notes < 12:
        order = torch.argsort(-ch.sum(dim=0))
        ch = ch[:, order[:notes]]
    ch = ch - ch.min()
    return ch / (ch.max() + 1e-8)


def tonnetz(audio: torch.Tensor, sr, type: str = "cens", nearest_neighbor: bool = True,
            preharmonic: int = 4) -> torch.Tensor:
    """(T, 6) tonal centroids in [0, 1]."""
    ch = chroma(audio, sr, type=type, nearest_neighbor=nearest_neighbor, preharmonic=preharmonic)
    ton = _chroma.tonnetz(ch.t()).t()
    ton = ton - ton.min()
    return ton / ton.max().clamp_min(1e-10)


def pitch_track(audio: torch.Tensor, sr, preharmonic: int = 4) -> torch.Tensor:
    y = audio
    if preharmonic:
        y = harmonic(y, margin=float(preharmonic))
    return _pitch.pitch_track_envelope(y, sr=sr)


def spectral_max(audio: torch.Tensor, sr, n_mels: int = 512) -> torch.Tensor:
    """The loudest mel band of each frame, normalized to [0, 1]."""
    spec = melspectrogram(audio, sr, n_mels=n_mels).amax(dim=0)
    spec = spec - spec.min()
    return spec / spec.max().clamp_min(1e-10)


def pitch_dominance(audio: torch.Tensor, sr, type: str = "cens", nearest_neighbor: bool = True,
                    preharmonic: int = 4) -> torch.Tensor:
    """Pitch classes sorted by dominance."""
    ch = chroma(audio, sr, type=type, nearest_neighbor=nearest_neighbor, preharmonic=preharmonic)
    norm = ch / ch.sum(dim=1, keepdim=True).clamp_min(1e-10)
    return torch.argsort(-norm.sum(dim=0))


def pulse(audio: torch.Tensor, sr, prior: str = "lognorm", type: str = "mm", prepercussive: int = 4) -> torch.Tensor:
    """Predominant local pulse of the onset envelope."""
    onset_env = onsets(audio, sr, type=type, prepercussive=prepercussive)
    fps = onset_env.shape[0] / (audio.shape[-1] / sr)
    pul = _beat.plp(onset_env, sr=fps, hop_length=1, tempo_min=30.0, tempo_max=300.0)
    return pul / pul.abs().max().clamp_min(1e-10)


def round_to_nearest_half(number: float) -> float:
    return round(number * 2) / 2


def tempo(audio: torch.Tensor, sr, prior: str = "uniform", type: str = "mm", prepercussive: int = 4) -> List[float]:
    """Tempo candidates in BPM: the global estimate, then the ten largest
    local maxima of the onset autocorrelation folded into [80, 200], each
    rounded to the nearest half BPM."""
    onset_env = onsets(audio, sr, type=type, prepercussive=prepercussive)
    fps = onset_env.shape[0] / (audio.shape[-1] / sr)
    ac = _beat.autocorrelate(onset_env, max_size=512)
    ac_np = (ac / ac.abs().max().clamp_min(1e-10)).cpu().numpy()
    is_peak = np.zeros(len(ac_np), bool)
    is_peak[1:-1] = (ac_np[1:-1] >= ac_np[:-2]) & (ac_np[1:-1] >= ac_np[2:])
    cand = np.where(is_peak)[0]
    peaks = cand[np.argsort(-ac_np[cand])][:10]
    peaks = peaks[(peaks > 3) & (peaks < len(ac_np))]
    tempos_ac = tempo_frequencies(512, hop_length=1, sr=fps)[peaks]
    for t in range(len(tempos_ac)):
        while tempos_ac[t] < 80:
            tempos_ac[t] *= 2
        while tempos_ac[t] > 200:
            tempos_ac[t] /= 2
    main = float(_beat.tempo(onset_env, sr=fps, hop_length=1))
    return [round_to_nearest_half(b) for b in (main, *tempos_ac)]


def laplacian_segmentation(audio: torch.Tensor, sr, k: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    return _segment.laplacian_segmentation(audio, sr, k=k)
