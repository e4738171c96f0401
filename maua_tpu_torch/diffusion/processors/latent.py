"""Latent diffusion (CompVis LDM text to image) with the alpha-space samplers.

Port of `maua_tpu/diffusion/processors/latent.py` (LatentDiffusion):
text conditioning and classifier-free guidance as one 2x-batched UNet
evaluation, PLMS or DDIM over a linspace of 1000 timesteps, encode ->
q_sample -> sample -> decode; with grad modules the x0 prediction is
decoded, the modules' image gradient pulled back through the decoder
and added to eps. It shares its networks with StableDiffusion. Images
are NHWC in [-1, 1] at the interface; the networks run NCHW.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ...prompt import TextPrompt
from ...text.clip_text import CLIPTextConfig, encode_text, tokenize
from ...text.clip_text import init_params as init_text_params
from ...utility import resolve_device, to_device
from ..models import unet as unet_mod
from ..models import vae as vae_mod
from ..samplers import ddim_sample_loop, make_ddpm_schedule, plms_sample_loop, q_sample
from .base import BaseDiffusionProcessor
from .stable import _to_nchw


class LatentDiffusion(BaseDiffusionProcessor):
    """forward(img, prompts, t_start, t_end) partial-denoise processor. Without
    given parameters the UNet, VAE and text encoder are drawn, in that order,
    from a torch.Generator seeded with `seed` on `device`."""

    def __init__(
        self,
        cfg_scale: float = 5.0,
        sampler: str = "plms",
        timesteps: int = 50,
        ddim_eta: float = 0.0,
        image_size: int = 256,
        grad_modules: Sequence = (),
        unet_params=None,
        unet_cfg: unet_mod.UNetConfig = unet_mod.SD1_UNET,
        vae_params=None,
        vae_cfg: vae_mod.VAEConfig = vae_mod.VAEConfig(),
        text_params=None,
        text_cfg: CLIPTextConfig = CLIPTextConfig(),
        device=None,
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.unet_cfg, self.vae_cfg, self.text_cfg = unet_cfg, vae_cfg, text_cfg
        self.unet_params = to_device(unet_params, self.device) if unet_params is not None \
            else unet_mod.init_params(unet_cfg, gen)
        self.vae_params = to_device(vae_params, self.device) if vae_params is not None \
            else vae_mod.init_params(vae_cfg, gen)
        self.text_params = to_device(text_params, self.device) if text_params is not None \
            else init_text_params(text_cfg, gen)
        self.alphas_cumprod = make_ddpm_schedule(1000, schedule="scaled_linear")
        self.sampler = sampler
        self.timesteps = timesteps
        self.ddim_eta = ddim_eta
        self.cfg_scale = cfg_scale
        self.image_size = image_size
        self.grad_modules = [gm for gm in grad_modules if getattr(gm, "scale", 1) != 0]
        self.timestep_map = np.linspace(0, 999, timesteps).round().astype(int)
        self._acp = torch.tensor(self.alphas_cumprod, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def conditioning(self, prompts):
        texts = [p.text for p in prompts if isinstance(p, TextPrompt)]
        cl = self.text_cfg.context_length
        cond = encode_text(self.text_params, tokenize(" ".join(texts) or "", cl), self.text_cfg)
        uncond = encode_text(self.text_params, tokenize("", cl), self.text_cfg)
        return cond, uncond

    @torch.no_grad()
    def encode(self, img: torch.Tensor) -> torch.Tensor:
        """NCHW image in [-1, 1] -> scaled NCHW latent."""
        return vae_mod.encode(self.vae_params, img, self.vae_cfg)

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """Scaled NCHW latent -> NCHW image (differentiable: the guidance pulls back through it)."""
        return vae_mod.decode(self.vae_params, x, self.vae_cfg)

    @torch.no_grad()
    def forward(self, img, prompts, t_start, t_end=1.0, verbose=True, latent=False,
                gen: Optional[torch.Generator] = None, noise=None, noises: Optional[Sequence] = None,
                stage_times: Optional[Dict] = None):
        """img (B, H, W, 3) in [-1, 1] (a latent (B, h, w, z) with `latent`) -> the same layout, f32.
        `noise` (NHWC latent) replaces the draw from `gen` that starts the latent (t_start 0) or noises
        the encoded image; `noises` (one per step) ddim's eta > 0 draws. (`stage_times` is taken for the
        multi-size pipeline's calls and not filled.)"""
        x_in = _to_nchw(img, self.device)
        cond, uncond = self.conditioning(prompts)
        n = len(self.timestep_map)
        start = round((1 - t_start) * (n - 1)) if t_start > 0 else n - 1
        steps = self.timestep_map[: start + 1][::-1].copy()  # descending
        if len(steps) == 0:
            return x_in.permute(0, 2, 3, 1)
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)

        ds = self.vae_cfg.downscale
        if t_start > 0:
            x0 = x_in if latent else self.encode(x_in)
            eps0 = _to_nchw(noise, self.device) if noise is not None else \
                torch.randn(x0.shape, generator=gen, device=self.device)
            x = q_sample(x0, np.full((x0.shape[0],), self.alphas_cumprod[steps[0]], np.float32), eps0)
        else:
            b, _, h, w = x_in.shape
            shape = (b, self.vae_cfg.z_channels) + ((h, w) if latent else (h // ds, w // ds))
            x = _to_nchw(noise, self.device) if noise is not None else \
                torch.randn(shape, generator=gen, device=self.device)
        b = x.shape[0]
        ctx = torch.cat([uncond.expand(b, *uncond.shape[1:]), cond.expand(b, *cond.shape[1:])])

        def eps_model(x_t, t):
            out = unet_mod.forward(self.unet_params, torch.cat([x_t, x_t]), torch.cat([t, t]).float(), self.unet_cfg,
                                   ctx)
            un, co = out[:b], out[b:]
            return un + (co - un) * self.cfg_scale

        if self.grad_modules:
            for gm in self.grad_modules:
                gm.set_targets(prompts)
            base_eps_model = eps_model

            def eps_model(x_t, t):  # noqa: F811
                # the guidance gradient at the decoded x0 prediction, pulled back through the decoder and
                # added to eps: a step down the guidance loss in x0 space
                e = base_eps_model(x_t, t)
                a_t = self._acp[t][:, None, None, None]
                pred_x0 = (x_t - torch.sqrt(1.0 - a_t) * e) / torch.sqrt(a_t)
                with torch.enable_grad():
                    z = pred_x0.detach().requires_grad_(True)
                    imgd = self.decode(z)
                    im = imgd.detach().permute(0, 2, 3, 1)
                    img_grad = torch.zeros_like(im)
                    for gm in self.grad_modules:
                        img_grad = img_grad + gm(im, t)
                    (x0_grad,) = torch.autograd.grad(imgd, z, img_grad.permute(0, 3, 1, 2))
                return e + torch.sqrt(1.0 - a_t) / torch.sqrt(a_t) * x0_grad

        if self.sampler == "plms":
            _, out = plms_sample_loop(eps_model, x, steps, self.alphas_cumprod)
        else:
            out, _ = ddim_sample_loop(eps_model, x, steps, self.alphas_cumprod, eta=self.ddim_eta, gen=gen,
                                      noises=noises)
        out = out if latent else self.decode(out)
        return out.float().permute(0, 2, 3, 1)
