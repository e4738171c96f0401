"""The self-supervised audio feature set at hop 1024.

Port of `maua_tpu/audiovisual/selfsupervised/features.py`: onsets, rms,
drop_strength, chromagram, tonnetz, mfcc, pulse, spectral_contrast and
spectral_flatness, each (T, F) on the signal's device, and
salience_weighted. `onsets`, `pulse` and `mfcc` reach `melspectrogram`,
so on the card they launch the mel kernel (n_fft 2048, hop 1024, 128
mels).
"""

from __future__ import annotations

from typing import Dict

import torch

from ...audio import beat as _beat
from ...audio import chroma as _chroma
from ...audio.spectral import harmonic as _harmonic
from ...audio.spectral import mfcc as _mfcc
from ...audio.spectral import percussive as _percussive
from ...audio.spectral import rms as _rms
from ...audio.spectral import spectral_contrast as _contrast
from ...audio.spectral import spectral_flatness as _flatness
from ...ops.signal import emphasize, gaussian_filter, normalize

HOP = 1024


def onsets(audio: torch.Tensor, sr) -> torch.Tensor:
    """(T, 1)"""
    env = _beat.onset_strength(_percussive(audio), sr=sr, hop_length=HOP)
    return normalize(env)[:, None]


def rms(audio: torch.Tensor, sr) -> torch.Tensor:
    """(T, 1)"""
    return _rms(audio, frame_length=2048, hop_length=HOP)[:-1][:, None]


def drop_strength(audio: torch.Tensor, sr) -> torch.Tensor:
    """(T, 1)"""
    return emphasize(gaussian_filter(rms(audio, sr), 10.0), strength=10.0, percentile_p=50.0)


def chromagram(audio: torch.Tensor, sr) -> torch.Tensor:
    """(T, 12)"""
    return _chroma.chroma_cens(_harmonic(audio), sr=sr, hop_length=HOP).t()


def tonnetz(audio: torch.Tensor, sr) -> torch.Tensor:
    """(T, 6)"""
    return _chroma.tonnetz(chromagram(audio, sr).t()).t()


def mfcc(audio: torch.Tensor, sr) -> torch.Tensor:
    """(T, 20)"""
    return _mfcc(audio, sr, hop_length=HOP)[:20].t()


def pulse(audio: torch.Tensor, sr) -> torch.Tensor:
    """(T, 1)"""
    env = _beat.onset_strength(_percussive(audio), sr=sr, hop_length=HOP)
    return _beat.plp(env, sr=sr, hop_length=HOP)[:, None]


def spectral_contrast(audio: torch.Tensor, sr) -> torch.Tensor:
    """(T, 7)"""
    return _contrast(audio, sr, hop_length=HOP).t()


def spectral_flatness(audio: torch.Tensor, sr) -> torch.Tensor:
    """(T, 1)"""
    return _flatness(audio, hop_length=HOP)[:, None]


AFEATFNS = [chromagram, tonnetz, mfcc, spectral_contrast, spectral_flatness, rms, drop_strength, onsets]
UNITFEATS = ["rms", "drop_strength", "onsets", "spectral_flatness"]
ALLFEATS = ["chromagram", "tonnetz", "mfcc", "spectral_contrast"] + UNITFEATS


def salience_weighted(envelope: torch.Tensor, short_sigma: float = 5.0, long_sigma: float = 80.0) -> torch.Tensor:
    """Emphasize locally salient envelope motion: (short / long smoothing)^2
    times the envelope."""
    env = envelope.squeeze() if envelope.dim() > 1 else envelope
    short = gaussian_filter(env, short_sigma, causal=0.0, mode="reflect")
    long = gaussian_filter(env, long_sigma, causal=0.0, mode="reflect")
    weighted = (short / long.clamp_min(1e-8)) ** 2 * env
    return weighted[:, None] if weighted.dim() < 2 else weighted


def extract_features(audio: torch.Tensor, sr) -> Dict[str, torch.Tensor]:
    """All eight features, cut to the same frame count."""
    feats = {fn.__name__: fn(audio, sr) for fn in AFEATFNS}
    t = min(int(f.shape[0]) for f in feats.values())
    return {k: v[:t] for k, v in feats.items()}
