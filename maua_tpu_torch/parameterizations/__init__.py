"""Optimizable image parameterizations with a debiased EMA.

Port of `maua_tpu/parameterizations/__init__.py` (Parameterization,
load_parameterization). A parameterization holds its optimizable tensor,
or a dict of them, in `tensor`, and decodes it to an NHWC image in
[-1, 1]. `params()` lists the leaves for a `torch.optim.Optimizer` (they
require grad and are updated in place); `set_params` replaces them.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def clip(x, lo: float, hi: float):
    """x clipped to [lo, hi] as jnp.clip is, min(max(x, lo), hi): at a bound the gradient is halved
    (torch.maximum / minimum split it at ties, as JAX's do); torch.clamp passes all of it."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: fn(a[k], b[k]) for k in a}
    return fn(a, b)


class Parameterization:
    """A tensor (or a dict of tensors) decoded into an image, with an optional debiased EMA
    (`average`: the EMA of the tensor divided by 1 - decay^steps)."""

    def __init__(self, height: int, width: int, tensor, ema: bool = False, decay: float = 0.99):
        self.h, self.w = height, width
        self.tensor = _map(lambda t: t.detach().clone().requires_grad_(True), tensor)
        self.ema = ema
        self.decay = decay
        if ema:
            self.reset_ema()

    def params(self) -> List:
        """The optimizable leaves, in a fixed order."""
        return list(self.tensor.values()) if isinstance(self.tensor, dict) else [self.tensor]

    def set_params(self, tensor):
        self.tensor = _map(lambda t: t.detach().clone().requires_grad_(True), tensor)

    def encode(self, img):
        raise NotImplementedError

    def decode(self, tensor=None):
        raise NotImplementedError

    def update_ema(self):
        if self.ema:
            d = self.decay
            self.accum = self.accum * np.float32(d)  # f32, as maua_tpu keeps it
            self.biased = _map2(lambda b, t: b * d + (1 - d) * t.detach(), self.biased, self.tensor)
            self.average = _map(lambda b: b / float(1 - self.accum), self.biased)

    def reset_ema(self):
        if self.ema:
            self.biased = _map(lambda t: t.detach() * 0, self.tensor)
            self.average = _map(lambda t: t.detach() * 0, self.tensor)
            self.accum = np.float32(1.0)
            self.update_ema()

    def decode_average(self):
        if self.ema:
            return self.decode(self.average)
        return self.decode()

    def __call__(self):
        return self.decode()


def load_parameterization(which: str):
    """The class for a name: rgb, fourier, pixel or vqgan ("stylegan" waits for the StyleGAN2
    Generator class)."""
    which = which.lower()
    if which == "rgb":
        from .rgb import RGB

        return RGB
    if which == "fourier":
        from .fourier import Fourier

        return Fourier
    if which == "pixel":
        from .pixel import Pixel

        return Pixel
    if which == "vqgan":
        from .vqgan import VQGAN

        return VQGAN
    if which == "stylegan":
        raise NotImplementedError("the stylegan parameterization is not ported yet (maua_tpu/parameterizations/"
                                  "stylegan.py): it needs maua_tpu/gan/stylegan2.py's Generator class")
    raise ValueError(f"Parameterization {which} not recognized!")
