"""Stable Diffusion: the latent diffusion processor.

Port of `maua_tpu/diffusion/processors/stable.py` (StableDiffusion):
CLIP text conditioning, classifier-free guidance as one 2x-batched UNet
evaluation per step, the k-diffusion samplers, partial sigma ranges, and
the VAE around the latent loop. Images are NHWC in [-1, 1] at this
processor's interface, as in the reference; the networks run NCHW.

With `grad_modules` (`maua_tpu_torch.grad`) sampling is guided: at each
model call the CFG denoiser's output is decoded, the modules' image
gradient is pulled back through the decoder and the UNet by autograd
(`guided_denoiser`), and the denoised latent moves by it times sigma^2.
With `image_cond` an ImagePrompt conditions through the CLIP image tower
instead of the text (one context token of its embedding).

`cfg_scale` and the sampler are read at each call. (The reference bakes
both into its jitted unguided program at the first call, while its
guided path reads them live; the port reads them live everywhere.)
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ...prompt import ImagePrompt, TextPrompt
from ...text.clip_text import CLIPTextConfig, encode_text, tokenize
from ...text.clip_text import init_params as init_text_params
from ...utility import resolve_device, to_device
from ..models import unet as unet_mod
from ..models import vae as vae_mod
from ..samplers import ANCESTRAL, get_sampler, make_ddpm_schedule
from ..wrappers import EpsDenoiser, cfg_denoiser, guided_denoiser
from .base import BaseDiffusionProcessor


def _to_nchw(img, device) -> torch.Tensor:
    img = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.array(img, np.float32))
    return img.to(dtype=torch.float32, device=device).permute(0, 3, 1, 2)


class StableDiffusion(BaseDiffusionProcessor):
    """forward(img, prompts, t_start, t_end) partial-denoise processor.

    Without given parameters the UNet, VAE, text encoder and (with
    `image_cond`) CLIP image tower are drawn at random, in that order, from
    one torch.Generator seeded with `seed` on `device`. Given parameters are
    in the port's layout (see `maua_tpu_torch.bridge` and
    `maua_tpu_torch.diffusion.load`) and move to `device`. The image-
    conditioned variant's unconditional branch embeds uniform noise in
    [-1, 1] at the tower's size: `uncond_image` (NHWC) when set, else a
    draw from a generator seeded with 0, the same at every call."""

    def __init__(
        self,
        grad_modules: Sequence = (),
        sampler: str = "lms",
        timesteps: int = 50,
        cfg_scale: float = 7.5,
        image_size: int = 512,
        unet_params=None,
        unet_cfg: unet_mod.UNetConfig = unet_mod.SD1_UNET,
        vae_params=None,
        vae_cfg: vae_mod.VAEConfig = vae_mod.VAEConfig(),
        text_params=None,
        text_cfg: CLIPTextConfig = CLIPTextConfig(),
        image_cond: bool = False,
        vision_params=None,
        vision_cfg=None,
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
        self.image_cond = image_cond
        self.uncond_image = None
        if image_cond:
            from ...perceptors import clip as clip_vision

            self.vision_cfg = vision_cfg or clip_vision.CLIPVisionConfig(embed_dim=unet_cfg.context_dim)
            self.vision_params = to_device(vision_params, self.device) if vision_params is not None \
                else clip_vision.init_vision_params(self.vision_cfg, gen)
        self.grad_modules = [gm for gm in grad_modules if getattr(gm, "scale", 1) != 0]
        self.alphas_cumprod = make_ddpm_schedule(1000, schedule="scaled_linear")
        self.denoiser = EpsDenoiser(
            lambda x, t, context=None: unet_mod.forward(self.unet_params, x, t, self.unet_cfg, context),
            self.alphas_cumprod,
        )
        self.sigmas = self.denoiser.get_sigmas(timesteps)
        get_sampler(sampler)
        self.sampler_name = sampler
        self.cfg_scale = cfg_scale
        self.image_size = image_size

    @torch.no_grad()
    def conditioning(self, prompts):
        """Prompts -> (cond, uncond) embeddings: the text's, each (1, L, width);
        with image_cond and an ImagePrompt, the last image's CLIP embedding and
        the noise image's, each (1, 1, embed_dim)."""
        imgs = [p for p in prompts if isinstance(p, ImagePrompt)] if self.image_cond else []
        if imgs:
            from ...perceptors.clip import encode_image, resize_to

            s = self.vision_cfg.image_size
            img = resize_to(torch.as_tensor(np.asarray(imgs[-1].img, np.float32), device=self.device), s)
            cond = encode_image(self.vision_params, img, self.vision_cfg)[:, None, :]
            if self.uncond_image is not None:
                noise = torch.tensor(np.asarray(self.uncond_image), dtype=torch.float32, device=self.device)
            else:
                gen = torch.Generator(device=self.device).manual_seed(0)
                noise = torch.rand(img.shape, generator=gen, device=self.device) * 2.0 - 1.0
            return cond, encode_image(self.vision_params, noise, self.vision_cfg)[:, None, :]
        texts = [p.text for p in prompts if isinstance(p, TextPrompt)]
        cl = self.text_cfg.context_length
        cond = encode_text(self.text_params, tokenize(" ".join(texts) if texts else "", cl), self.text_cfg)
        uncond = encode_text(self.text_params, tokenize("", cl), self.text_cfg)
        return cond, uncond

    @torch.no_grad()
    def encode(self, img: torch.Tensor) -> torch.Tensor:
        """NCHW image in [-1, 1] -> scaled NCHW latent."""
        return vae_mod.encode(self.vae_params, img, self.vae_cfg)

    @torch.no_grad()
    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """Scaled NCHW latent -> NCHW image."""
        return vae_mod.decode(self.vae_params, x, self.vae_cfg)

    def cond_fn(self, x, sigma, denoised, vjp):
        """The guidance gradient at x: the grad modules' gradient at the decoded
        image, pulled back through the decoder and then through the model (vjp)."""
        with torch.enable_grad():
            z = denoised.detach().requires_grad_(True)
            imgd = vae_mod.decode(self.vae_params, z, self.vae_cfg)
            img = imgd.detach().permute(0, 2, 3, 1)
            img_grad = torch.zeros_like(img)
            for gm in self.grad_modules:
                img_grad = img_grad + gm(img, sigma)
            (z_grad,) = torch.autograd.grad(imgd, z, img_grad.permute(0, 3, 1, 2))
        (x_grad,) = vjp(z_grad)
        return -x_grad

    def get_sigmas(self, t_s: float, t_e: Optional[float] = None):
        """The partial sigma range: t indexes the descending schedule (t = 0 is full noise)."""
        step_start = round(t_s * (len(self.sigmas) - 1))
        if t_e is None:
            return self.sigmas[step_start]
        step_end = round(t_e * (len(self.sigmas) - 1)) + 1
        return self.sigmas[step_start:step_end]

    def _mark(self, stage_times: Optional[Dict], name: Optional[str] = None, t0: float = 0.0) -> float:
        """With `stage_times`, wait for the device and add the seconds since t0 to `name`."""
        if stage_times is None:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if name is not None:
            stage_times[name] = stage_times.get(name, 0.0) + now - t0
        return now

    @torch.no_grad()
    def forward(self, img, prompts, t_start, t_end=1.0, verbose=True, reverse=False, latent=False,
                gen: Optional[torch.Generator] = None, noise=None, stage_times: Optional[Dict] = None):
        """img (B, H, W, 3) in [-1, 1] (a latent (B, h, w, z) with `latent`) ->
        the same layout, f32, on this processor's device. `noise` is an
        optional standard-normal latent (B, h, w, z) in place of a draw
        from `gen`; `stage_times` collects seconds of text (with the
        grad modules' targets), encode, sampling and decode."""
        x_in = _to_nchw(img, self.device)
        sigmas = np.asarray(self.get_sigmas(t_start, t_end))
        if reverse:
            sigmas = sigmas[::-1].copy()
        if len(sigmas) < 2:
            return x_in.permute(0, 2, 3, 1)
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)

        t0 = self._mark(stage_times)
        cond, uncond = self.conditioning(prompts)
        for gm in self.grad_modules:
            gm.set_targets(prompts)
        t0 = self._mark(stage_times, "text", t0)
        model_fn = cfg_denoiser(self.denoiser, cond, uncond, self.cfg_scale)
        if self.grad_modules:
            model_fn = guided_denoiser(model_fn, self.cond_fn)

        ds = self.vae_cfg.downscale
        b, _, h, w = x_in.shape
        shape = (b, self.vae_cfg.z_channels) + ((h, w) if latent else (h // ds, w // ds))
        if noise is not None:
            eps = _to_nchw(noise, self.device)
            if tuple(eps.shape) != shape:
                raise ValueError(f"noise must be {shape[:1] + shape[2:] + shape[1:2]} (NHWC), got {tuple(noise.shape)}")
        else:
            eps = torch.randn(shape, generator=gen, device=self.device)
        if t_start > 0 or reverse:
            x = x_in if latent else self.encode(x_in)
            t0 = self._mark(stage_times, "encode", t0)
            x = x + eps * float(sigmas[0])
        else:
            x = eps * float(sigmas[0])

        sample_fn = get_sampler(self.sampler_name)
        if self.sampler_name in ANCESTRAL:
            out = sample_fn(model_fn, x, sigmas, gen=gen)
        else:
            out = sample_fn(model_fn, x, sigmas)
        t0 = self._mark(stage_times, "sampling", t0)
        if not latent:
            out = self.decode(out)
            self._mark(stage_times, "decode", t0)
        return out.float().permute(0, 2, 3, 1)
