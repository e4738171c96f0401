"""StyleGAN w-latent parameterization.

Port of `maua_tpu/parameterizations/stylegan.py` (`StyleGANLatent`): w+
latents (1, num_ws, w_dim) decoded through a frozen StyleGAN2 synthesis
network without noise, resized bilinearly (as jax.image.resize, with
antialias when it shrinks) to the parameterization's size. Every
synthesis layer ends in the epilogue kernel, under autograd through
`kernels/epilogue.ModconvEpilogue`. Images are NHWC in [-1, 1].
"""

from __future__ import annotations

from typing import Optional

import torch

from ..gan import stylegan2 as sg2
from ..ops.warp import resize
from ..utility import resolve_device
from . import Parameterization


class StyleGANLatent(Parameterization):
    def __init__(self, height, width, tensor=None, generator: Optional[sg2.Generator] = None, ema: bool = False,
                 gen: Optional[torch.Generator] = None, device=None, z: Optional[torch.Tensor] = None):
        """Without `generator`, SG2Config(img_resolution=min(h, w), num_fp16_res=0) drawn from `gen`
        (seed 0 on `device`, cuda unless told otherwise); without `tensor`, w+ = mapping(z) with z
        (1, z_dim) drawn from `gen` after the generator unless given."""
        gen = gen if gen is not None else torch.Generator(device=resolve_device(device)).manual_seed(0)
        if generator is None:
            generator = sg2.Generator(sg2.SG2Config(img_resolution=min(height, width), num_fp16_res=0), gen=gen)
        self.generator = generator
        dev = generator.params["mapping"]["w_avg"].device
        if tensor is None:
            if z is None:
                z = torch.randn((1, generator.cfg.z_dim), generator=gen, device=gen.device)
            with torch.no_grad():
                tensor = generator.mapping(torch.as_tensor(z, device=dev).float())
        super().__init__(height, width, torch.as_tensor(tensor, device=dev).float(), ema)

    def decode(self, tensor=None) -> torch.Tensor:
        ws = self.tensor if tensor is None else tensor
        img = self.generator.synthesis(ws, noise_mode="none")
        if img.shape[2] != self.h or img.shape[3] != self.w:
            img = resize(img, (self.h, self.w), "bilinear")
        return img.permute(0, 2, 3, 1)

    def encode(self, img):
        raise NotImplementedError("use projection (optimize w) to encode an image")
