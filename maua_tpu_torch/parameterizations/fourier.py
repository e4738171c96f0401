"""Fourier-space image parameterization with a frequency-scaled spectrum
(the lucid / CLIP-style decorrelated parameterization).

Port of `maua_tpu/parameterizations/fourier.py` on `torch.fft.irfft2` /
`rfft2` (maua_tpu's real-DFT matrices are its TPU path to the same
function). The spectrum (1, 3, H, W // 2 + 1, 2) is scaled by
sqrt(H W) / max(|f|, 1 / max(H, W)), inverted, divided by 4, colour
decorrelated and squashed by tanh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utility import resolve_device
from . import Parameterization

# lucid's colour decorrelation matrix
_COLOR_CORR = np.asarray([[0.26, 0.09, 0.02], [0.27, 0.00, -0.05], [0.27, -0.09, 0.03]], np.float32)
_COLOR_CORR_NORM = _COLOR_CORR / np.linalg.norm(_COLOR_CORR, axis=0).max()


def _freqs(h, w):
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    return np.sqrt(fx * fx + fy * fy)


class Fourier(Parameterization):
    def __init__(self, height, width, tensor=None, std: float = 0.01, ema: bool = False,
                 gen: Optional[torch.Generator] = None, device=None):
        """`tensor`: the spectrum; without one, N(0, std^2) drawn from `gen` (seed 0 on `device`, cuda
        unless told otherwise)."""
        if tensor is None:
            gen = gen if gen is not None else torch.Generator(device=resolve_device(device)).manual_seed(0)
            tensor = torch.randn((1, 3, height, width // 2 + 1, 2), generator=gen, device=gen.device) * std
        tensor = torch.as_tensor(tensor, device=device).float()
        super().__init__(height, width, tensor, ema)
        dev = tensor.device
        scale = 1.0 / np.maximum(_freqs(height, width), 1.0 / max(height, width))
        self.scale = torch.as_tensor(scale * np.sqrt(height * width), dtype=torch.float32, device=dev)
        self.color = torch.as_tensor(_COLOR_CORR_NORM.T, device=dev)

    def decode(self, tensor=None):
        t = self.tensor if tensor is None else tensor
        spectrum = torch.complex(t[..., 0] * self.scale, t[..., 1] * self.scale)
        img = torch.fft.irfft2(spectrum, s=(self.h, self.w)).permute(0, 2, 3, 1) / 4.0  # (1, H, W, 3)
        return torch.tanh(img @ self.color)

    def encode(self, img):
        x = torch.atanh(torch.clamp(torch.as_tensor(img, device=self.scale.device).float(), -0.999, 0.999))
        x = (x @ torch.linalg.inv(self.color)).permute(0, 3, 1, 2) * 4.0
        spec = torch.fft.rfft2(x) / self.scale
        self.set_params(torch.stack([spec.real, spec.imag], dim=-1))
