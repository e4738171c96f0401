"""The `ar` API that patches program against: frame-aligned envelopes,
latent loops and smoothing.

Port of `maua_tpu/audiovisual/audioreactive.py`: onsets ("mm" or
"rosa"), rms, chroma (cens, cqt, stft), volume, tempo, pulse,
laplacian_segmentation, separate_sources (the DSP split, or the
openunmix-style networks of `audio/separate.py` given weights or
`neural=True`), chroma_weight_latents, the plotting helpers (no-ops
without matplotlib), and the filters, signal ops and latent blends and
loops re-exported for patches. Every envelope is resampled to
`n_frames`, percentile-clipped and gaussian-smoothed on request.
Features run on the device of the audio tensor they are given.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
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


def separate_sources(audio: torch.Tensor, sr, device=None, params=None, checkpoint: Optional[str] = None,
                     neural: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(vocals, drums, bass, other), on the audio's device.

    Neural (`neural=True`, or weights given): the openunmix-style mask
    networks of `audio/separate.py` at `UMXConfig()`, from `params`
    ({target: state dict}), from `checkpoint` (a directory of openunmix
    `{target}.pth` state dicts) or random. Otherwise by DSP: HPSS (margin
    3) splits the percussive drums from the harmonic part, which is
    band-split into bass (< 250 Hz), vocals (250 Hz - 4 kHz) and the
    rest. `device` is accepted for maua_tpu's signature and unused."""
    if neural or params is not None or checkpoint is not None:
        import os

        from ..audio import separate as umx

        cfg = umx.UMXConfig()
        if params is None and checkpoint is not None:
            params = umx.params_from_torch(
                {t: torch.load(os.path.join(checkpoint, f"{t}.pth"), map_location=audio.device, weights_only=True)
                 for t in umx.TARGETS}, cfg)
        return umx.separate(audio, sr, params=params, cfg=cfg)
    harm = _harmonic(audio, margin=3.0)
    drums = _percussive(audio, margin=3.0)
    bass = low_pass(harm, sr, 250)
    vocals = band_pass(harm, sr, 250, 4000)
    return vocals, drums, bass, harm - bass - vocals


def chroma_weight_latents(chroma: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """Latents weighted by chroma activations: (T, N), (N, L, D) -> (T, L, D)."""
    w = chroma / chroma.sum(dim=1, keepdim=True).clamp_min(1e-10)
    return torch.einsum("tn,nld->tld", w, latents)


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def _save(plt, fig, path: Optional[str], default: str) -> None:
    import os

    path = path or default
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)


def _numpy(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plot_signals(signals, path: Optional[str] = None):
    """One line plot per signal, stacked (default workspace/signals.png);
    a no-op without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return
    fig, axes = plt.subplots(len(signals), 1, figsize=(12, 2 * len(signals)), squeeze=False)
    for ax, sig in zip(axes[:, 0], signals):
        ax.plot(_numpy(sig).squeeze())
    _save(plt, fig, path, "workspace/signals.png")


def plot_spectra(spectra, path: Optional[str] = None):
    """One image per (T, F) spectrum, stacked (default workspace/spectra.png);
    a no-op without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return
    fig, axes = plt.subplots(len(spectra), 1, figsize=(12, 2 * len(spectra)), squeeze=False)
    for ax, spec in zip(axes[:, 0], spectra):
        ax.imshow(_numpy(spec).squeeze().T, aspect="auto", origin="lower")
    _save(plt, fig, path, "workspace/spectra.png")


def plot_audio(audio: torch.Tensor, sr, path: Optional[str] = None):
    """The signal's mel spectrogram in dB (default workspace/audio.png); a
    no-op without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return
    from ..audio.convert import power_to_db
    from ..audio.spectral import melspectrogram

    mel = _numpy(power_to_db(melspectrogram(audio, sr)))
    fig = plt.figure(figsize=(16, 9))
    plt.imshow(mel.squeeze().T if mel.shape[0] > mel.shape[-1] else mel.squeeze(), aspect="auto", origin="lower")
    plt.colorbar(format="%+2.f dB")
    _save(plt, fig, path, "workspace/audio.png")


def plot_chroma_comparison(audio: torch.Tensor, sr, path: Optional[str] = None):
    """Chromagrams of maua_tpu's five type names side by side (deep and clp
    fall back to cens, in both packages) (default
    workspace/chroma-comparison.png); a no-op without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return
    fig, ax = plt.subplots(nrows=2, ncols=3, figsize=(16, 9), squeeze=False)
    for col, types in enumerate([["cens", "cqt"], ["deep", "clp"], ["stft"]]):
        for row, type in enumerate(types):
            ch = _numpy(chroma(audio, sr, n_frames=None, type=type))
            if ch.ndim == 2 and ch.shape[1] == 12:
                ch = ch.T
            ax[row][col].imshow(ch, aspect="auto", origin="lower")
            ax[row][col].set(title=type)
    _save(plt, fig, path, "workspace/chroma-comparison.png")
