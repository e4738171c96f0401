"""GLIDE (a 64^2 CFG base and a 256^2 upsampler) and GLID3XL (latent
diffusion conditioned by BERT).

Port of `maua_tpu/diffusion/processors/glide.py` (GLIDE_BASE,
GLIDE_UPSAMPLE, GLIDE, GLID3XL). GLIDE: the image is bilinear-resized to
the base size, the text-conditioned base UNet samples it with
classifier-free guidance (one 2x-batched evaluation per step), the base
output is bicubic-resized to the image size, and the upsampler UNet,
conditioned on that low-resolution image by channel concatenation, samples
the final image; both stages by DDIM (eta 0) over a linspace of the 1000
cosine-schedule timesteps, x0 clipped to [-1, 1], and a partial denoise
(t_start > 0) starts each stage from its input noised by q_sample. GLID3XL:
`LatentDiffusion` (PLMS or DDIM, the optional latent grad modules) with the
CLIP text conditioning swapped for BERT's context embeddings
(`text/bert.py`). Images are NHWC in [-1, 1] at the interface; the networks
run NCHW.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ...ops.warp import resize
from ...prompt import TextPrompt
from ...text.clip_text import CLIPTextConfig, encode_text, tokenize
from ...text.clip_text import init_params as init_text_params
from ...utility import StageClock, resolve_device, to_device
from ..models import unet as unet_mod
from ..samplers import ddim_sample_loop, make_ddpm_schedule, q_sample
from .base import BaseDiffusionProcessor
from .stable import _to_nchw

GLIDE_BASE = unet_mod.UNetConfig(
    in_channels=3, out_channels=6, model_channels=192, channel_mult=(1, 2, 3, 4), num_res_blocks=3,
    attention_resolutions=(2, 4, 8), num_head_channels=64, context_dim=512, use_scale_shift_norm=True,
)
GLIDE_UPSAMPLE = unet_mod.UNetConfig(
    in_channels=6, out_channels=6, model_channels=192, channel_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2,
    attention_resolutions=(8, 16, 32), num_head_channels=64, context_dim=512, use_scale_shift_norm=True,
)


class GLIDE(BaseDiffusionProcessor):
    """forward(img, prompts, t_start, t_end) -> the upsampler's image. Without
    given parameters the base UNet, the upsampler and the text encoder are
    drawn, in that order, from a torch.Generator seeded with `seed` on
    `device`. Both stages sample by DDIM: `sampler` takes only "ddim"."""

    def __init__(
        self,
        cfg_scale: float = 3.0,
        sampler: str = "ddim",
        timesteps: int = 50,
        image_size: int = 256,
        base_cfg: unet_mod.UNetConfig = GLIDE_BASE,
        up_cfg: unet_mod.UNetConfig = GLIDE_UPSAMPLE,
        base_params=None,
        up_params=None,
        text_params=None,
        text_cfg: Optional[CLIPTextConfig] = None,
        base_size: int = 64,
        device=None,
        seed: int = 0,
    ):
        if sampler != "ddim":
            raise ValueError(f"GLIDE samples both stages by DDIM, got sampler {sampler!r}")
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.base_cfg, self.up_cfg = base_cfg, up_cfg
        self.text_cfg = text_cfg or CLIPTextConfig(width=512, layers=4, heads=8)
        self.base_params = to_device(base_params, self.device) if base_params is not None \
            else unet_mod.init_params(base_cfg, gen)
        self.up_params = to_device(up_params, self.device) if up_params is not None \
            else unet_mod.init_params(up_cfg, gen)
        self.text_params = to_device(text_params, self.device) if text_params is not None \
            else init_text_params(self.text_cfg, gen)
        self.alphas_cumprod = make_ddpm_schedule(1000, schedule="cosine")
        self.cfg_scale = cfg_scale
        self.timesteps = timesteps
        self.image_size = image_size
        self.base_size = base_size
        self.timestep_map = np.linspace(0, 999, timesteps).round().astype(int)
        self.grad_modules = []

    @torch.no_grad()
    def conditioning(self, prompts):
        texts = [p.text for p in prompts if isinstance(p, TextPrompt)]
        cl = self.text_cfg.context_length
        cond = encode_text(self.text_params, tokenize(" ".join(texts) or "", cl), self.text_cfg)
        uncond = encode_text(self.text_params, tokenize("", cl), self.text_cfg)
        return cond, uncond

    def _sample(self, params, cfg, x, steps, context_pair, extra=None, guided=True):
        cond, uncond = context_pair
        b, c = x.shape[:2]

        def eps_model(x_t, t):
            xc = x_t if extra is None else torch.cat([x_t, extra], dim=1)
            if guided:
                ctx = torch.cat([uncond.expand(b, *uncond.shape[1:]), cond.expand(b, *cond.shape[1:])])
                out = unet_mod.forward(params, torch.cat([xc, xc]), torch.cat([t, t]).float(), cfg, ctx)[:, :c]
                un, co = out[:b], out[b:]
                return un + (co - un) * self.cfg_scale
            return unet_mod.forward(params, xc, t.float(), cfg, cond.expand(b, *cond.shape[1:]))[:, :c]

        _, pred = ddim_sample_loop(eps_model, x, steps, self.alphas_cumprod, eta=0.0, clip_denoised=True)
        return pred

    @torch.no_grad()
    def forward(self, img, prompts, t_start, t_end=1.0, verbose=True, gen: Optional[torch.Generator] = None,
                noise: Optional[Sequence] = None, stage_times: Optional[Dict] = None):
        """img (B, H, W, 3) in [-1, 1] -> (B, image_size, image_size, 3), f32. `noise` is a pair of
        standard-normal NHWC images, (B, base_size, base_size, 3) and (B, image_size, image_size, 3), in
        place of the two stages' draws from `gen`. `stage_times` collects seconds of text, base and
        upsample. (`t_end` is taken for the multi-size pipeline's calls and not used.)"""
        x_in = _to_nchw(img, self.device)
        b = x_in.shape[0]
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)

        def draw(i, shape):
            if noise is None:
                return torch.randn(shape, generator=gen, device=self.device)
            eps = _to_nchw(noise[i], self.device)
            if tuple(eps.shape) != shape:
                raise ValueError(f"noise {i} must be {(shape[0],) + shape[2:] + shape[1:2]} (NHWC), got "
                                 f"{tuple(noise[i].shape)}")
            return eps

        clock = StageClock(self.device, stage_times)
        ctx = clock.stage("text", lambda: self.conditioning(prompts))
        n = len(self.timestep_map)
        start = round(t_start * (n - 1))
        steps = self.timestep_map[: n - start][::-1].copy()
        a0 = np.full((b,), self.alphas_cumprod[steps[0]], np.float32)

        low = resize(x_in, (self.base_size, self.base_size), "bilinear")
        eps = draw(0, tuple(low.shape))
        x = q_sample(low, a0, eps) if t_start > 0 else eps
        base_out = clock.stage("base", lambda: self._sample(self.base_params, self.base_cfg, x, steps, ctx))

        # the upsampler, conditioned on the base output; a partial denoise starts from the noised upsampled
        # base output, so that the state matches the marginal at steps[0]
        up_low = resize(base_out, (self.image_size, self.image_size), "bicubic")
        eps = draw(1, tuple(up_low.shape))
        x_up = q_sample(up_low, a0, eps) if t_start > 0 else eps
        up_out = clock.stage("upsample", lambda: self._sample(self.up_params, self.up_cfg, x_up, steps, ctx,
                                                               extra=up_low, guided=False))
        return up_out.float().permute(0, 2, 3, 1)


class GLID3XL(BaseDiffusionProcessor):
    """Latent diffusion conditioned by BERT: `LatentDiffusion` built from the
    keyword arguments (its grad modules, sampler, networks, device and seed),
    with the text conditioning of `bert` (a `BERTEmbedder`; by default one of
    width unet_cfg.context_dim, 2 layers, 4 heads and the text encoder's
    context length, from `bert_checkpoint` or drawn with the seed) in place of
    CLIP's; the unconditional slot embeds the empty text."""

    def __init__(self, grad_modules: Sequence = (), cfg_scale: float = 5.0, sampler: str = "plms",
                 timesteps: int = 50, image_size: int = 256, bert=None, bert_checkpoint=None, bert_vocab=None,
                 bert_cfg=None, seed: int = 0, **kw):
        from ...text.bert import BERTConfig, BERTEmbedder
        from .latent import LatentDiffusion

        self._ld = LatentDiffusion(cfg_scale=cfg_scale, sampler=sampler, timesteps=timesteps, image_size=image_size,
                                   grad_modules=grad_modules, seed=seed, **kw)
        if bert is None:
            cfg = bert_cfg or BERTConfig(width=self._ld.unet_cfg.context_dim, layers=2, heads=4,
                                         max_len=self._ld.text_cfg.context_length)
            bert = BERTEmbedder(cfg, checkpoint=bert_checkpoint, vocab_path=bert_vocab, device=self._ld.device,
                                seed=seed)
        self.bert = bert
        self._ld.conditioning = self._bert_conditioning  # the instance attribute shadows LatentDiffusion's method
        self.grad_modules = self._ld.grad_modules
        self.image_size = image_size
        self.device = self._ld.device

    def _bert_conditioning(self, prompts):
        texts = [p.text for p in prompts if isinstance(p, TextPrompt)]
        return self.bert([" ".join(texts) or ""]), self.bert([""])

    def forward(self, img, prompts, t_start, t_end=1.0, verbose=True, **kw):
        """LatentDiffusion.forward's (latent, gen, noise, noises, stage_times)."""
        return self._ld.forward(img, prompts, t_start, t_end, verbose=verbose, **kw)
