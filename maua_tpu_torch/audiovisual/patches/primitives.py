"""Patch building blocks: looping, tonal and modulated latent and noise
sequences.

Port of `maua_tpu/audiovisual/patches/primitives.py`. Every primitive
produces its whole (n_frames, ...) sequence; `modulation_sum` averages
weighted ones. Noise is (T, size, size, 1), the JAX package's layout, and
is drawn from a `torch.Generator` where the JAX functions take a key
(the two give different numbers from the same seed).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ...audio.latent import slerp_loops, spline_loops
from ...ops.signal import gaussian_filter, resample_1d


def loop_latents(latent_selection: torch.Tensor, loop_len: int, type: str = "spline",
                 smooth: float = 10.0) -> torch.Tensor:
    """Looping latent sequence: (K, L, D) -> (loop_len, L, D)."""
    if loop_len == 1 or type == "constant":
        return latent_selection[:1]
    if type == "spline":
        return spline_loops(latent_selection, loop_len, 1)
    if type == "slerp":
        return slerp_loops(latent_selection, loop_len, 1)
    if type == "gaussian":
        reps = max(round(loop_len / latent_selection.shape[0]), 1)
        lat = resample_1d(latent_selection.repeat_interleave(reps, dim=0), loop_len)
        return gaussian_filter(lat, smooth)
    raise ValueError(f"unknown loop type {type}")


def tempo_loop_latents(tempo: float, latent_selection: torch.Tensor, n_bars: int, fps: float, **kw) -> torch.Tensor:
    """A latent loop lasting n_bars bars of 4 beats at `tempo` BPM."""
    loop_len = 1 if latent_selection.shape[0] == 1 else round(n_bars * fps * 60 / (tempo / 4))
    return loop_latents(latent_selection, loop_len, **kw)


def pitch_track_latents(pitch_track: torch.Tensor, latent_selection: torch.Tensor) -> torch.Tensor:
    """The latent indexed by the pitch's position between its quartiles."""
    low, high = torch.quantile(pitch_track, 0.25), torch.quantile(pitch_track, 0.75)
    pt = (pitch_track - low) / (high - low).clamp_min(1e-10) * latent_selection.shape[0]
    return latent_selection[torch.round(pt).long() % latent_selection.shape[0]]


def tonal_latents(chroma_or_tonnetz: torch.Tensor, latent_selection: torch.Tensor) -> torch.Tensor:
    """(T, A), (K, L, D) -> (T, L, D): latents weighted by the activations."""
    w = chroma_or_tonnetz / chroma_or_tonnetz.sum(dim=1, keepdim=True).clamp_min(1e-10)
    a = chroma_or_tonnetz.shape[1]
    sel = latent_selection[torch.arange(a, device=w.device) % latent_selection.shape[0]]
    return torch.einsum("ta,ald->tld", w, sel)


def modulated_latents(modulation: torch.Tensor, base_latents: torch.Tensor) -> torch.Tensor:
    """(T,), (*, L, D) -> (T, L, D)."""
    return modulation[:, None, None] * base_latents[:1]


def loop_noise(loop_len: int, size: int, smooth: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Smoothed looping noise video (loop_len, size, size, 1), circular in
    time, on the generator's device (a CPU generator seeded with 0 by default)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    noise = torch.randn(loop_len, size, size, 1, generator=generator, device=generator.device)
    noise = gaussian_filter(noise, smooth)
    std = gaussian_filter(noise.std(dim=(1, 2, 3), correction=0), smooth)
    return noise / std.reshape(-1, 1, 1, 1)


def tempo_loop_noise(tempo: float, n_bars: int, fps: float, **kw) -> torch.Tensor:
    """Looping noise lasting n_bars bars of 4 beats at `tempo` BPM."""
    return loop_noise(round(n_bars * fps * 60 / (tempo / 4)), **kw)


def tonal_noise(chroma_or_tonnetz: torch.Tensor, size: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Noise fields, one per activation, weighted by the activations."""
    device = chroma_or_tonnetz.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    w = chroma_or_tonnetz / chroma_or_tonnetz.sum(dim=1, keepdim=True).clamp_min(1e-10)
    noises = torch.randn(w.shape[1], size, size, 1, generator=generator, device=generator.device).to(device)
    noise = torch.einsum("ta,ahwc->thwc", w, noises)
    std = gaussian_filter(noise.std(dim=(1, 2, 3), correction=0), 10.0)
    return noise / std.reshape(-1, 1, 1, 1)


def modulated_noise(modulation: torch.Tensor, base_noise: Optional[torch.Tensor] = None, size: Optional[int] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The base noise (looping noise by default) scaled by the modulation."""
    if base_noise is None:
        base_noise = loop_noise(modulation.shape[0], size, 1.0, generator)
    idx = torch.arange(modulation.shape[0], device=modulation.device) % base_noise.shape[0]
    return modulation.reshape(-1, 1, 1, 1) * base_noise.to(modulation.device)[idx]


class Modulated:
    """A (sequence, modulation) pair for modulation_sum."""

    def __init__(self, sequence: torch.Tensor, modulation: torch.Tensor):
        self.sequence = sequence
        self.modulation = modulation


def modulation_sum(modulated: List[Modulated], n_frames: int) -> torch.Tensor:
    """Weighted average of modulated sequences, each indexed modulo its length."""
    total, weight = None, None
    for m in modulated:
        idx = torch.arange(n_frames, device=m.sequence.device)
        mod = m.modulation[idx % m.modulation.shape[0]]
        seq = m.sequence[idx % m.sequence.shape[0]]
        contrib = mod.reshape((-1,) + (1,) * (seq.dim() - 1)) * seq
        total = contrib if total is None else total + contrib
        weight = mod if weight is None else weight + mod
    return total / weight.reshape((-1,) + (1,) * (total.dim() - 1)).clamp_min(1e-10)
