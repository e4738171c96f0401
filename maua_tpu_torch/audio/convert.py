"""Unit conversions and filterbanks used by the audio features.

Port of `maua_tpu/audio/convert.py`: power_to_db / amplitude_to_db /
db_to_power, the mel scale (hz_to_mel, mel_to_hz, mel_frequencies),
hz_to_octs, hz_to_midi, note_to_hz, the fft / cqt / tempo frequency
axes and the mel and chroma filterbanks. Frequency axes and filterbanks
are numpy in float64 (host constants); the JAX package computes
`hz_to_mel` / `mel_to_hz` of arrays in float32.
"""

from __future__ import annotations

import math
import re
from typing import Optional

import numpy as np
import torch


def power_to_db(magnitude: torch.Tensor, ref_value=1.0, amin=1e-10, top_db: Optional[float] = 80.0) -> torch.Tensor:
    log_spec = 10.0 * torch.log10(magnitude.clamp_min(amin))
    log_spec = log_spec - 10.0 * np.log10(max(amin, ref_value))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def amplitude_to_db(magnitude: torch.Tensor, ref_value=1.0, amin=1e-5, top_db: Optional[float] = 80.0) -> torch.Tensor:
    return power_to_db(magnitude.square(), ref_value=ref_value**2, amin=amin**2, top_db=top_db)


def db_to_power(db: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, 0.1 * db)


_MIN_LOG_HZ = 1000.0
_F_SP = 200.0 / 3
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def hz_to_mel(frequencies, htk: bool = False) -> np.ndarray:
    """Slaney (or HTK) mel of each frequency."""
    f = np.asarray(frequencies, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    linear = f / _F_SP
    logpart = _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(f >= _MIN_LOG_HZ, logpart, linear)


def mel_to_hz(mels, htk: bool = False) -> np.ndarray:
    m = np.asarray(mels, np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    linear = _F_SP * m
    logpart = _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL))
    return np.where(m >= _MIN_LOG_MEL, logpart, linear)


def mel_frequencies(n_mels: int = 128, fmin: float = 0.0, fmax: float = 11025.0, htk: bool = False) -> np.ndarray:
    """Mel band centres in Hz."""
    mels = np.linspace(float(hz_to_mel(fmin, htk)), float(hz_to_mel(fmax, htk)), n_mels)
    return mel_to_hz(mels, htk)


def hz_to_octs(frequencies, tuning: float = 0.0, bins_per_octave: int = 12) -> np.ndarray:
    A440 = 440.0 * 2.0 ** (tuning / bins_per_octave)
    return np.log2(np.asarray(frequencies, np.float64) / (A440 / 16.0))


def hz_to_midi(frequencies):
    return 12.0 * (np.log2(np.asarray(frequencies, np.float64)) - np.log2(440.0)) + 69.0


def midi_to_hz(notes):
    return 440.0 * 2.0 ** ((np.asarray(notes, np.float64) - 69.0) / 12.0)


_NOTE_MAP = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


def note_to_midi(note: str) -> float:
    """Parse notes like 'C1', 'A#4', 'Db3' (octave -1 starts at midi 0)."""
    m = re.match(r"^([A-Ga-g])([#b♯♭!]*)(-?\d+)?$", note)
    if not m:
        raise ValueError(f"bad note {note!r}")
    pitch = _NOTE_MAP[m.group(1).upper()]
    for acc in m.group(2):
        pitch += 1 if acc in "#♯" else -1
    octave = int(m.group(3)) if m.group(3) is not None else 0
    return 12 * (octave + 1) + pitch


def note_to_hz(note: str) -> float:
    return float(midi_to_hz(note_to_midi(note)))


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    return np.linspace(0, sr / 2, 1 + n_fft // 2)


def cqt_frequencies(n_bins: int, fmin: float, bins_per_octave: int = 12, tuning: float = 0.0) -> np.ndarray:
    correction = 2.0 ** (tuning / bins_per_octave)
    return correction * fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)


def tempo_frequencies(n_bins: int, hop_length: int = 512, sr: float = 22050) -> np.ndarray:
    """BPM of each autocorrelation lag (librosa.tempo_frequencies)."""
    bin_frequencies = np.zeros(n_bins)
    bin_frequencies[0] = np.inf
    bin_frequencies[1:] = 60.0 * sr / (hop_length * np.arange(1.0, n_bins))
    return bin_frequencies


def fourier_tempo_frequencies(sr: float = 22050, win_length: int = 384, hop_length: int = 512) -> np.ndarray:
    return fft_frequencies(sr=sr * 60 / hop_length, n_fft=win_length)


def mel_filterbank(sr: float, n_fft: int, n_mels: int = 128, fmin: float = 0.0, fmax: Optional[float] = None,
                   htk: bool = False) -> np.ndarray:
    """Slaney-normalized mel filterbank (n_mels, 1 + n_fft // 2), float32."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:] - mel_f[:-2])
    return (weights * enorm[:, None]).astype(np.float32)


def chroma_filterbank(sr: float, n_fft: int, n_chroma: int = 12, tuning: float = 0.0, ctroct: float = 5.0,
                      octwidth: float = 2.0, base_c: bool = True) -> np.ndarray:
    """STFT-bin -> chroma projection (librosa.filters.chroma)."""
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    frqbins = n_chroma * hz_to_octs(frequencies, tuning=tuning, bins_per_octave=n_chroma)
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1]))
    D = np.subtract.outer(frqbins, np.arange(0, n_chroma, dtype="d")).T
    n_chroma2 = np.round(float(n_chroma) / 2)
    D = np.remainder(D + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
    wts = np.exp(-0.5 * (2 * D / np.tile(binwidthbins, (n_chroma, 1))) ** 2)
    wts /= np.sqrt(np.sum(wts**2, axis=0, keepdims=True))
    if octwidth is not None:
        wts *= np.tile(np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)), (n_chroma, 1))
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, : int(1 + n_fft / 2)], dtype=np.float32)


def cq_to_chroma(n_input: int, bins_per_octave: int = 12, n_chroma: int = 12, fmin: Optional[float] = None,
                 base_c: bool = True) -> np.ndarray:
    """CQT-bin -> chroma aggregation matrix."""
    n_merge = float(bins_per_octave) / n_chroma
    if fmin is None:
        fmin = note_to_hz("C1")
    cq_to_ch = np.repeat(np.eye(n_chroma), int(round(n_merge)), axis=1)
    cq_to_ch = np.roll(cq_to_ch, -int(n_merge // 2), axis=1)
    n_octaves = int(np.ceil(float(n_input) / bins_per_octave))
    cq_to_ch = np.tile(cq_to_ch, (1, n_octaves))[:, :n_input]
    midi_0 = hz_to_midi(fmin) % 12
    roll = midi_0 if base_c else midi_0 - 9
    roll = int(np.round(roll * (n_chroma / 12.0)))
    return np.roll(cq_to_ch, roll, axis=0).astype(np.float32)
