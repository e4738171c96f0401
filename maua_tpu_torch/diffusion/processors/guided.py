"""Guided diffusion: OpenAI's pixel-space UNet with gradient guidance.

Port of `maua_tpu/diffusion/processors/guided.py` (respaced_timesteps,
GradientGuidedConditioning, GuidedDiffusion): DDIM, PLMS or ancestral
("p") sampling over a respaced schedule, pred_x0 clamped at each step,
and guidance whose gradient goes through the secondary model's x0
prediction only ("fast") or through the exact noise subtraction
("hyper"). Images are NHWC in [-1, 1] at the interface; the networks run
NCHW. At 256^2 the UNet's attention at 32^2 and 16^2 (D 64) takes the
flash-attention kernel route.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ...utility import resolve_device, to_device
from ..models import secondary as secondary_mod
from ..models import unet as unet_mod
from ..samplers import ddim_sample_loop, make_ddpm_schedule, plms_sample_loop, q_sample
from .base import BaseDiffusionProcessor
from .stable import _to_nchw


def respaced_timesteps(num_timesteps: int, respacing: str) -> np.ndarray:
    """guided-diffusion's space_timesteps: "N" or "ddimN" -> ascending original timesteps."""
    if respacing.startswith("ddim"):
        n = int(respacing[len("ddim"):])
        return np.arange(0, num_timesteps, num_timesteps // n)[:n]
    n = int(respacing)
    return np.linspace(0, num_timesteps - 1, n).round().astype(int)


class GradientGuidedConditioning:
    """The guidance gradient at x_t: the grad modules' image gradient at an
    x0 estimate, pulled back to x_t by autograd."""

    def __init__(self, alphas_cumprod: np.ndarray, secondary_params, grad_modules, speed: str = "fast"):
        self.speed = speed
        self.secondary_params = secondary_params
        self.grad_modules = list(grad_modules)
        ac = torch.tensor(np.asarray(alphas_cumprod), dtype=torch.float32,
                          device=secondary_params["timestep_embed"].device)
        self.sqrt_ac, self.sqrt_1mac = torch.sqrt(ac), torch.sqrt(1.0 - ac)
        self.noise = None

    def set_targets(self, prompts, noise):
        self.noise = noise
        for gm in self.grad_modules:
            gm.set_targets(prompts)

    def x_to_img(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        alpha = self.sqrt_ac[t][:, None, None, None]
        sigma = self.sqrt_1mac[t][:, None, None, None]
        if self.speed == "hyper":
            return (x - sigma * self.noise) / alpha
        cosine_t = torch.atan2(sigma[:, 0, 0, 0], alpha[:, 0, 0, 0]) * 2 / math.pi
        pred = secondary_mod.forward(self.secondary_params, x, cosine_t)["pred"]
        return pred * sigma + x * (1 - sigma)  # the reference's blend, kept as it is

    def __call__(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x (B, 3, H, W), t (B,) int64 -> -d(loss)/dx."""
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            img = self.x_to_img(xx, t)
            img_nhwc = img.detach().permute(0, 2, 3, 1)
            img_grad = torch.zeros_like(img_nhwc)
            for gm in self.grad_modules:
                g = gm(img_nhwc, t)
                img_grad = img_grad + torch.where(torch.isnan(g), torch.zeros_like(g), g)
            (grad,) = torch.autograd.grad(img, xx, img_grad.permute(0, 3, 1, 2))
        return -grad


class GuidedDiffusion(BaseDiffusionProcessor):
    """forward(img, prompts, t_start, t_end) over OpenAI's 256^2 unconditional
    UNet (GUIDED_UNET, learn_sigma: the first 3 output channels are eps).

    Without given parameters the UNet and the secondary model are drawn, in
    that order, from a torch.Generator seeded with `seed` on `device`."""

    def __init__(
        self,
        grad_modules: Sequence = (),
        sampler: str = "ddim",
        timesteps: int = 100,
        ddim_eta: float = 0.0,
        speed: str = "fast",
        image_size: int = 256,
        unet_params=None,
        unet_cfg: unet_mod.UNetConfig = unet_mod.GUIDED_UNET,
        secondary_params=None,
        device=None,
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.unet_cfg = unet_cfg
        self.unet_params = to_device(unet_params, self.device) if unet_params is not None \
            else unet_mod.init_params(unet_cfg, gen)
        secondary_params = to_device(secondary_params, self.device) if secondary_params is not None \
            else secondary_mod.init_params(gen)
        self.alphas_cumprod = make_ddpm_schedule(1000, schedule="linear")
        respacing = f"ddim{timesteps}" if sampler == "ddim" else str(timesteps)
        self.timestep_map = list(respaced_timesteps(1000, respacing))
        self.sampler = sampler
        self.ddim_eta = ddim_eta
        self.image_size = image_size
        self.conditioning = GradientGuidedConditioning(
            self.alphas_cumprod, secondary_params, [gm for gm in grad_modules if gm.scale != 0], speed=speed)

    def _eps_model(self, x, t):
        """The UNet's eps prediction at original timesteps (the first 3 of its 6 output channels)."""
        return unet_mod.forward(self.unet_params, x, t, self.unet_cfg)[:, : x.shape[1]]

    @torch.no_grad()
    def forward(self, img, prompts, t_start, t_end=1.0, verbose=True, gen: Optional[torch.Generator] = None,
                noise=None, noises: Optional[Sequence] = None, stage_times: Optional[Dict] = None):
        """img (B, H, W, 3) in [-1, 1] -> the last step's pred_x0, the same layout, f32. t_start is the
        skipped fraction (0: from pure noise). `noise` (B, H, W, 3) replaces the draw from `gen` that
        noises the image; `noises` (one per step) the ancestral draws of ddim with eta > 0 and "p".
        (`stage_times` is taken for the multi-size pipeline's calls and not filled.)"""
        x_in = _to_nchw(img, self.device)
        n_map = len(self.timestep_map)
        start_step = round((1.0 - t_start) * (n_map - 1))
        end_step = round((1.0 - t_end) * (n_map - 1))
        if t_end <= t_start or start_step < end_step:
            return x_in.permute(0, 2, 3, 1)
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        eps = _to_nchw(noise, self.device) if noise is not None else torch.randn(x_in.shape, generator=gen,
                                                                                 device=self.device)
        self.conditioning.set_targets(prompts, eps)
        t0 = self.timestep_map[start_step]
        x = q_sample(x_in, np.full((x_in.shape[0],), self.alphas_cumprod[t0], np.float32), eps)
        steps = np.asarray(self.timestep_map[end_step : start_step + 1][::-1])
        guided = len(self.conditioning.grad_modules) > 0

        def eps_model(x, t):
            e = self._eps_model(x, t)
            if guided:
                e = e - self.conditioning.sqrt_1mac[t][:, None, None, None] * self.conditioning(x, t)
            return e

        # an image-space model: pred_x0 clamped at each step, as guided-diffusion's clip_denoised
        if self.sampler == "plms":
            _, pred = plms_sample_loop(eps_model, x, steps, self.alphas_cumprod, clip_denoised=True)
        else:
            eta = self.ddim_eta if self.sampler == "ddim" else 1.0
            _, pred = ddim_sample_loop(eps_model, x, steps, self.alphas_cumprod, eta=eta, gen=gen,
                                       clip_denoised=True, noises=noises)
        return pred.float().permute(0, 2, 3, 1)
