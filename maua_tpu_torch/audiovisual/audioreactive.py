"""The `ar` API that patches program against: frame-aligned envelopes,
latent loops and smoothing.

Port of `maua_tpu/audiovisual/audioreactive.py`: onsets ("mm" or
"rosa"), rms, chroma (cens, cqt, stft), volume, tempo, pulse,
laplacian_segmentation, separate_sources (the DSP split; the neural
separator needs weights and is not ported yet), chroma_weight_latents,
and the filters, signal ops and latent blends and loops re-exported for
patches. Every envelope is resampled to `n_frames`, percentile-clipped
and gaussian-smoothed on request. Features run on the device of the
audio tensor they are given. The plotting helpers are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..audio import beat as _beat
from ..audio import mir as _mir
from ..audio.io import band_pass, high_pass, load_audio, low_pass  # noqa: F401
from ..audio.latent import multi_weighted, single_weighted, slerp, slerp_loops, spline_loops, tempo_loops  # noqa: F401
from ..audio.spectral import harmonic as _harmonic
from ..audio.spectral import percussive as _percussive
from ..audio.spectral import rms as _rms
from ..ops.signal import compress, gaussian_filter, normalize, percentile_clip, resample_1d  # noqa: F401


def _postprocess(env: torch.Tensor, n_frames: Optional[int], clip: Optional[float],
                 smooth: Optional[float]) -> torch.Tensor:
    if n_frames is not None:
        env = resample_1d(env, n_frames)
    if clip is not None:
        env = percentile_clip(env, float(clip))
    if smooth is not None and smooth > 0:
        env = gaussian_filter(env, float(smooth), causal=0.0)
        env = normalize(env)
    return env


def onsets(audio: torch.Tensor, sr, n_frames: Optional[int] = None, margin: float = 2.0,
           clip: Optional[float] = 95.0, smooth: Optional[float] = 2.0, type: str = "mm") -> torch.Tensor:
    """Frame-aligned onset envelope in [0, 1]: the "mm" flux ensemble or the
    "rosa" mel onset strength."""
    y = audio
    if margin:
        y = _percussive(y, margin=float(margin))
    env = _mir.onset_ensemble(y, sr) if type == "mm" else _beat.onset_strength(y, sr=sr)
    return _postprocess(env, n_frames, clip, smooth)


def rms(audio: torch.Tensor, sr, n_frames: Optional[int] = None, smooth: Optional[float] = 5.0,
        clip: Optional[float] = 95.0, power: float = 1.0) -> torch.Tensor:
    """Frame-aligned loudness envelope in [0, 1]."""
    return _postprocess(_rms(audio) ** power, n_frames, clip, smooth)


def chroma(audio: torch.Tensor, sr, n_frames: Optional[int] = None, margin: float = 2.0, type: str = "cens",
           notes: int = 12) -> torch.Tensor:
    """Frame-aligned chromagram (n_frames, notes) of type cens, cqt or stft."""
    ch = _mir.chroma(audio, sr, type=type, preharmonic=margin, notes=notes)
    return resample_1d(ch, n_frames) if n_frames is not None else ch


def volume(audio: torch.Tensor, sr, n_frames: Optional[int] = None, smooth: Optional[float] = None) -> torch.Tensor:
    return _postprocess(_mir.volume(audio, sr), n_frames, None, smooth)


def tempo(audio: torch.Tensor, sr, **kw):
    """Tempo candidates in BPM (a list of floats, the global estimate first)."""
    return _mir.tempo(audio, sr, **kw)


def pulse(audio: torch.Tensor, sr, n_frames: Optional[int] = None, **kw) -> torch.Tensor:
    return _postprocess(_mir.pulse(audio, sr, **kw), n_frames, None, None)


def laplacian_segmentation(audio: torch.Tensor, sr, k: int = 5):
    """(boundary times in seconds, segment labels) as numpy arrays."""
    return _mir.laplacian_segmentation(audio, sr, k=k)


def separate_sources(audio: torch.Tensor, sr) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(vocals, drums, bass, other) by DSP: HPSS (margin 3) splits the
    percussive drums from the harmonic part, which is band-split into
    bass (< 250 Hz), vocals (250 Hz - 4 kHz) and the rest."""
    harm = _harmonic(audio, margin=3.0)
    drums = _percussive(audio, margin=3.0)
    bass = low_pass(harm, sr, 250)
    vocals = band_pass(harm, sr, 250, 4000)
    return vocals, drums, bass, harm - bass - vocals


def chroma_weight_latents(chroma: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """Latents weighted by chroma activations: (T, N), (N, L, D) -> (T, L, D)."""
    w = chroma / chroma.sum(dim=1, keepdim=True).clamp_min(1e-10)
    return torch.einsum("tn,nld->tld", w, latents)
