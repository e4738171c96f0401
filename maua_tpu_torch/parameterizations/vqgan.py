"""Latent-space parameterization with straight-through vector quantization.

Port of `maua_tpu/parameterizations/vqgan.py`: z (1, h, w, C) is snapped to
its nearest codebook entries with the gradient passed straight through,
then decoded, by default through the port's AutoencoderKL decoder at
VAEConfig(base_channels=32, channel_mult=(1, 2, 4), num_res_blocks=1)
(downscale 4, 4 latent channels). Its single-head mid attention (D = 128,
N = (size / 4)^2) takes the attention kernel route from 64^2 up, through
the autograd Function when the style loss differentiates it. Pass
`decode_fn` (and `encode_fn`) to use a converted VQGAN instead.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..loss import replace_grad
from ..utility import resolve_device, to_device
from . import Parameterization, clip

VQGAN_VAE = dict(base_channels=32, channel_mult=(1, 2, 4), num_res_blocks=1)


class VQGAN(Parameterization):
    def __init__(self, height, width, tensor=None, codebook: Optional[torch.Tensor] = None,
                 decode_fn: Optional[Callable] = None, encode_fn: Optional[Callable] = None, ema: bool = False,
                 gen: Optional[torch.Generator] = None, device=None, vae_params: Optional[Dict] = None):
        """Random draws come from `gen` (seed 0 on `device`, cuda unless told otherwise): the default
        decoder's parameters unless `vae_params` is given, z ~ 0.1 N(0, 1) unless `tensor`, the
        256-entry codebook ~ N(0, 1) unless `codebook`."""
        gen = gen if gen is not None else torch.Generator(device=resolve_device(device)).manual_seed(0)
        dev = gen.device
        if decode_fn is None:
            from ..diffusion.models import vae as vae_mod

            cfg = vae_mod.VAEConfig(**VQGAN_VAE)
            params = to_device(vae_params, dev) if vae_params is not None else vae_mod.init_params(cfg, gen)
            self.vae_params = params
            decode_fn = lambda z: vae_mod.decode(params, z.permute(0, 3, 1, 2), cfg).permute(0, 2, 3, 1)  # noqa: E731
            if encode_fn is None:
                encode_fn = lambda im: vae_mod.encode(params, im.permute(0, 3, 1, 2), cfg).permute(0, 2, 3, 1)  # noqa: E731
            downscale, z_ch = cfg.downscale, cfg.z_channels
        else:
            downscale, z_ch = 8, 4
        self.decode_fn, self.encode_fn = decode_fn, encode_fn
        if tensor is None:
            tensor = torch.randn((1, height // downscale, width // downscale, z_ch), generator=gen, device=dev) * 0.1
        super().__init__(height, width, torch.as_tensor(tensor, device=dev).float(), ema)
        if codebook is None:
            codebook = torch.randn((256, z_ch), generator=gen, device=dev)
        self.codebook = torch.as_tensor(codebook, device=dev).float()

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """Straight-through nearest-codebook-entry quantization."""
        flat = z.reshape(-1, z.shape[-1])
        cb = self.codebook
        d = flat.square().sum(-1, keepdim=True) - 2 * flat @ cb.T + cb.square().sum(-1)[None]
        zq = cb[d.argmin(-1)].reshape(z.shape)
        return replace_grad(zq, z)

    def decode(self, tensor=None):
        z = self.tensor if tensor is None else tensor
        return clip(self.decode_fn(self.quantize(z)), -1.0, 1.0)

    def encode(self, img):
        """z from an NHWC image in [-1, 1] through the encoder and the quantizer."""
        if self.encode_fn is None:
            raise NotImplementedError("this VQGAN was built with a custom decode_fn and no encode_fn; pass encode_fn=")
        with torch.no_grad():
            z = self.quantize(self.encode_fn(torch.as_tensor(img, device=self.codebook.device).float()))
        self.set_params(z)
        return self.tensor
