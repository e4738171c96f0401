"""Lazy noise windows of self-supervised patches.

Port of `maua_tpu/audiovisual/selfsupervised/noise.py`: Loop, Blend,
Multiply, Average, Modulate and ScaleBias, and noise_patch. Each module
holds its random banks on the device and computes only the window of
frames [i, i + b) of its (T, H, W) noise video when it is called, so
1024^2 noise never exists for the whole video. Frame indices wrap
modulo the module's length: a window past the end continues the loop
from its start. The banks are drawn by the caller (a JAX key in
maua_tpu).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from .latent import linspace


def _frames(i: int, b: int, length: int, device) -> torch.Tensor:
    """The indices of frames i .. i + b - 1, wrapped modulo `length`."""
    return torch.arange(i, i + b, device=device) % length


class Noise:
    def __init__(self, length: int, size):
        self.length = length
        self.size = tuple(size)

    def __call__(self, i: int, b: int) -> torch.Tensor:
        raise NotImplementedError


class Loop(Noise):
    """A smooth sinusoidal noise loop over a bank (3, H, W) of normal draws,
    n_loops turns over the length, each frame scaled to unit RMS."""

    def __init__(self, noise: torch.Tensor, length: int, n_loops: float = 1.0, sigma: float = 5.0):
        super().__init__(length, noise.shape[1:])
        self.sigma = sigma
        self.noise = noise
        self.idx = linspace(float(n_loops) * 2 * math.pi, length, device=noise.device)

    def __call__(self, i, b):
        phase = self.idx[_frames(i, b, self.length, self.noise.device)][:, None, None]
        freqs = torch.cos(phase + self.noise[0][None]) / (self.sigma / 50.0)
        out = torch.sin(freqs + self.noise[1][None]) * self.noise[2][None]
        rmsv = out.square().mean(dim=(1, 2), keepdim=True).sqrt()
        return out / (rmsv + torch.finfo(out.dtype).eps)


class Blend(Noise):
    """Two banks (2, M, H, W) weighted by a feature (T, M) and by its
    complement."""

    def __init__(self, noise: torch.Tensor, length: int, modulator: torch.Tensor):
        super().__init__(length, noise.shape[2:])
        self.noise = noise
        self.modulator = modulator

    def __call__(self, i, b):
        mod = self.modulator[_frames(i, b, self.length, self.modulator.device)].reshape(-1, self.modulator.shape[1])
        left = torch.einsum("MHW,BM->BHW", self.noise[0], mod)
        right = torch.einsum("MHW,BM->BHW", self.noise[1], 1 - mod)
        return left + right


class Multiply(Noise):
    """A bank (M, H, W) weighted by a feature (T, M)."""

    def __init__(self, noise: torch.Tensor, length: int, modulator: torch.Tensor):
        super().__init__(length, noise.shape[1:])
        self.noise = noise
        self.modulator = modulator

    def __call__(self, i, b):
        mod = self.modulator[_frames(i, b, self.length, self.modulator.device)].reshape(-1, self.modulator.shape[1])
        return torch.einsum("MHW,BM->BHW", self.noise, mod)


class Average(Noise):
    def __init__(self, left, right):
        super().__init__(left.length, left.size)
        self.left, self.right = left, right

    def __call__(self, i, b):
        return (self.left(i, b) + self.right(i, b)) / 2


class Modulate(Noise):
    def __init__(self, left, right, modulator: torch.Tensor):
        super().__init__(left.length, left.size)
        self.left, self.right = left, right
        self.modulator = modulator.mean(dim=1)

    def __call__(self, i, b):
        mod = self.modulator[_frames(i, b, self.length, self.modulator.device)][:, None, None]
        return self.left(i, b) * mod + self.right(i, b) * (1 - mod)


class ScaleBias(Noise):
    def __init__(self, base, scale, bias):
        super().__init__(base.length, base.size)
        self.base, self.scale, self.bias = base, scale, bias

    def __call__(self, i, b):
        return self.scale * self.base(i, b) + self.bias


def noise_patch(
    draw: Callable[[int, tuple], torch.Tensor],
    noise: List[Noise],
    features: Dict,
    tempo: float,
    fps: float,
    patch_type: str,
    loop_bars: int,
    seq_feat: str,
    seq_feat_weight: float,
    mod_feat: str,
    mod_feat_weight: float,
    merge_type: str,
    merge_depth: str,
    noise_mean: float,
    noise_std: float,
) -> List[Noise]:
    """Apply one noise subpatch to the per-layer stack: a new Blend,
    Multiply or Loop on each layer of `merge_depth`, averaged or modulated
    into it, then scaled and shifted. `draw(layer, shape)` gives a layer's
    normal bank."""
    n_layers = len(noise)
    ranges = {
        "low": range(0, min(6, n_layers)),
        "mid": range(min(6, n_layers), min(12, n_layers)),
        "high": range(min(12, n_layers), n_layers),
        "lowmid": range(0, min(12, n_layers)),
        "midhigh": range(min(6, n_layers), n_layers),
        "all": range(0, n_layers),
    }
    feature = seq_feat_weight * features[seq_feat]
    length = len(feature)
    for n in ranges[merge_depth]:
        h, w = noise[n].size
        if patch_type == "blend":
            new_noise = Blend(draw(n, (2, feature.shape[1], h, w)), length, feature)
        elif patch_type == "multiply":
            new_noise = Multiply(draw(n, (feature.shape[1], h, w)), length, feature)
        else:  # loop
            n_loops = max(length / fps * max(tempo, 1e-3) / 60 / 4 / loop_bars, 0.25)
            new_noise = Loop(draw(n, (3, h, w)), length, n_loops=n_loops)

        if merge_type == "average":
            noise[n] = Average(noise[n], new_noise)
        elif merge_type == "modulate":
            noise[n] = Modulate(noise[n], new_noise, mod_feat_weight * features[mod_feat])
        else:
            noise[n] = new_noise
        noise[n] = ScaleBias(noise[n], scale=noise_std, bias=noise_mean)
    return noise
