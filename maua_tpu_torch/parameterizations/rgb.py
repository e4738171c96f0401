"""Direct pixel parameterization. Port of `maua_tpu/parameterizations/rgb.py`:
the image is stored in [0, 1] and decoded through `clamp_with_grad`."""

from __future__ import annotations

from typing import Optional

import torch

from ..loss import clamp_with_grad
from ..utility import resolve_device
from . import Parameterization


class RGB(Parameterization):
    def __init__(self, height, width, tensor=None, colorspace: str = "rgb", ema: bool = False,
                 gen: Optional[torch.Generator] = None, device=None):
        """`tensor`: an NHWC image in [-1, 1]; without one, U(0, 0.1) drawn from `gen` (seed 0 on
        `device`, cuda unless told otherwise)."""
        if tensor is None:
            gen = gen if gen is not None else torch.Generator(device=resolve_device(device)).manual_seed(0)
            tensor = torch.rand((1, height, width, 3), generator=gen, device=gen.device) * 0.1
        else:
            tensor = (torch.as_tensor(tensor, device=device).float() + 1.0) / 2.0  # stored in [0, 1]
        super().__init__(height, width, tensor, ema)
        self.colorspace = colorspace

    def decode(self, tensor=None):
        t = self.tensor if tensor is None else tensor
        return clamp_with_grad(t, 0.0, 1.0) * 2.0 - 1.0

    def encode(self, img):
        self.set_params(torch.clamp((torch.as_tensor(img, device=self.tensor.device).float() + 1.0) / 2.0, 0, 1))
