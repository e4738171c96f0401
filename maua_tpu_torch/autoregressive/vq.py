"""VQ image-token decoder and encoder: token grids <-> pixels.

Port of `maua_tpu/autoregressive/vq.py`: a codebook embed feeding the
port's AutoencoderKL decoder (`diffusion/models/vae.py`, the taming-style
resblock and upsample stack, latent scale 1), so converted taming VQGAN
weights load through the CompVis converter plus the
`quantize.embedding.weight` codebook. Images are NCHW in [-1, 1].

The decoder's single-head mid attention is (B, 1, rows * cols, C) at the
deepest width: at ruDALL-E's 32 x 32 token grid and 512 channels it takes the
attention kernel route (`kernels/attention.py`), at the CLI's 8 x 8 grid the
plain one. Encoding snaps each latent to the nearest code by maua_tpu's
expanded distance |z|^2 - 2 z.c + |c|^2, so that ties break alike.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..diffusion.models import vae as vae_mod


@dataclasses.dataclass(frozen=True)
class VQConfig:
    codebook_size: int = 8192
    z_channels: int = 4
    base_channels: int = 32
    channel_mult: tuple = (1, 2, 4)
    num_res_blocks: int = 1

    @property
    def vae_cfg(self) -> vae_mod.VAEConfig:
        return vae_mod.VAEConfig(base_channels=self.base_channels, channel_mult=tuple(self.channel_mult),
                                 num_res_blocks=self.num_res_blocks, z_channels=self.z_channels, scale_factor=1.0)

    @property
    def upscale(self) -> int:
        return self.vae_cfg.downscale


def init_params(cfg: VQConfig, gen: torch.Generator) -> Dict:
    """A 0.1 N(0, 1) codebook, then the VAE's random parameters, drawn from `gen`."""
    codebook = torch.randn(cfg.codebook_size, cfg.z_channels, generator=gen, device=gen.device) * 0.1
    return {"codebook": codebook, "vae": vae_mod.init_params(cfg.vae_cfg, gen)}


def params_from_torch(sd, cfg: VQConfig) -> Dict:
    """A taming VQGAN state dict -> params: the codebook from `quantize.embedding.weight`, the decoder
    (and encoder) through the CompVis VAE converter."""
    from ..diffusion.load import vae_params_from_compvis

    sd = {k: np.asarray(v.float().cpu() if isinstance(v, torch.Tensor) else v) for k, v in sd.items()}
    return {"codebook": torch.from_numpy(np.array(sd["quantize.embedding.weight"], np.float32)),
            "vae": vae_params_from_compvis(sd, cfg.vae_cfg)}


def _decode(params, z, cfg):
    """z (B, rows, cols, C) -> (B, 3, H, W) clamped to [-1, 1]."""
    return torch.clamp(vae_mod.decode(params["vae"], z.permute(0, 3, 1, 2).contiguous(), cfg.vae_cfg), -1.0, 1.0)


@torch.no_grad()
def decode_tokens(params: Dict, tokens: torch.Tensor, cfg: VQConfig, rows: int, cols: int) -> torch.Tensor:
    """tokens (B, rows * cols) image-vocab ids -> (B, 3, rows * U, cols * U) in [-1, 1]."""
    tokens = torch.as_tensor(tokens, device=params["codebook"].device).long()
    return _decode(params, params["codebook"][tokens].reshape(tokens.shape[0], rows, cols, cfg.z_channels), cfg)


def decode_video_tokens(params: Dict, tokens: torch.Tensor, cfg: VQConfig, rows: int, cols: int) -> torch.Tensor:
    """tokens (F, B, rows * cols) -> (F, B, 3, H, W): the frames fold into the batch for one decode."""
    f, b, n = tokens.shape
    imgs = decode_tokens(params, torch.as_tensor(tokens).reshape(f * b, n), cfg, rows, cols)
    return imgs.reshape(f, b, *imgs.shape[1:])


@torch.no_grad()
def decode_rq_tokens(params: Dict, tokens: torch.Tensor, cfg: VQConfig, rows: int, cols: int,
                     depth: int) -> torch.Tensor:
    """Residual-quantized tokens (B, rows * cols * depth, raster-depth order) -> (B, 3, H, W): each
    position's latent is the sum of its depth codes' embeddings (RQ-VAE); depth 1 is plain VQ."""
    tokens = torch.as_tensor(tokens, device=params["codebook"].device).long()
    ids = tokens.reshape(tokens.shape[0], rows, cols, depth)
    return _decode(params, params["codebook"][ids].sum(dim=3), cfg)


def _nearest(resid: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    d = (resid ** 2).sum(-1, keepdim=True) - 2.0 * resid @ cb.T + (cb ** 2).sum(-1)
    return torch.argmin(d, dim=-1)


def _latents(params, images, cfg):
    z = vae_mod.encode(params["vae"], torch.as_tensor(images, device=params["codebook"].device), cfg.vae_cfg)
    return z.permute(0, 2, 3, 1).reshape(-1, cfg.z_channels)  # raster order, as maua_tpu's NHWC


@torch.no_grad()
def encode_tokens(params: Dict, images: torch.Tensor, cfg: VQConfig) -> torch.Tensor:
    """images (B, 3, H, W) in [-1, 1] -> (B, (H/U) * (W/U)) image-vocab ids: the encoder's latents
    snapped to the nearest code."""
    return _nearest(_latents(params, images, cfg), params["codebook"]).reshape(images.shape[0], -1)


@torch.no_grad()
def encode_rq_tokens(params: Dict, images: torch.Tensor, cfg: VQConfig, depth: int) -> torch.Tensor:
    """images (B, 3, H, W) -> (B, (H/U) * (W/U) * depth) residual code ids: each level snaps the
    remaining residual to the nearest code."""
    resid, cb, levels = _latents(params, images, cfg), params["codebook"], []
    for _ in range(depth):
        ids = _nearest(resid, cb)
        levels.append(ids)
        resid = resid - cb[ids]
    return torch.stack(levels, dim=-1).reshape(images.shape[0], -1)
