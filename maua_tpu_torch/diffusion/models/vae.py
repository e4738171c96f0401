"""AutoencoderKL (the SD / LDM first-stage VAE) in PyTorch.

Port of `maua_tpu/diffusion/models/vae.py`: a resnet encoder and decoder
with a single-head mid attention block, a diagonal Gaussian posterior
and the 0.18215 latent scale. NCHW activations, OIHW conv weights. The
mid attention has one head of the block's full width (512 at SD 1.x),
so at 64^2 latents it takes the attention kernel route (N 4096, D 512).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...kernels.attention import attention
from .unet import _conv_init, _norm_init, _upsample_nn, conv2d, group_norm


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    base_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    scale_factor: float = 0.18215
    dtype: str = "float32"

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.channel_mult) - 1)


def _init_vae_resblock(gen, ci, co):
    p = {
        "norm1": _norm_init(ci, gen.device),
        "conv1": _conv_init(gen, 3, ci, co),
        "norm2": _norm_init(co, gen.device),
        "conv2": _conv_init(gen, 3, co, co),
    }
    if ci != co:
        p["skip"] = _conv_init(gen, 1, ci, co)
    return p


def _vae_resblock(p, x):
    h = conv2d(p["conv1"], F.silu(group_norm(p["norm1"], x)))
    h = conv2d(p["conv2"], F.silu(group_norm(p["norm2"], h)))
    skip = conv2d(p["skip"], x, padding=0) if "skip" in p else x
    return skip + h


def _init_mid_attn(gen, c):
    return {"norm": _norm_init(c, gen.device), **{k: _conv_init(gen, 1, c, c) for k in ("q", "k", "v", "proj")}}


def _mid_attn(p, x):
    b, c, h, w = x.shape
    n = group_norm(p["norm"], x)
    q, k, v = (conv2d(p[name], n, padding=0).reshape(b, 1, c, h * w).transpose(-1, -2) for name in "qkv")
    out = attention(q, k, v).transpose(-1, -2).reshape(b, c, h, w)
    return x + conv2d(p["proj"], out, padding=0)


def _mid(p, h):
    h = _vae_resblock(p["res1"], h)
    h = _mid_attn(p["attn"], h)
    return _vae_resblock(p["res2"], h)


def init_params(cfg: VAEConfig, gen: torch.Generator) -> Dict:
    """Random parameters with the JAX package's init distributions, drawn from `gen`."""
    bc = cfg.base_channels
    dev = gen.device

    def mid(ch):
        return {"res1": _init_vae_resblock(gen, ch, ch), "attn": _init_mid_attn(gen, ch),
                "res2": _init_vae_resblock(gen, ch, ch)}

    enc = {"conv_in": _conv_init(gen, 3, cfg.in_channels, bc)}
    ch = bc
    blocks = []
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            blocks.append({"res": _init_vae_resblock(gen, ch, mult * bc)})
            ch = mult * bc
        if level != len(cfg.channel_mult) - 1:
            blocks.append({"down": _conv_init(gen, 3, ch, ch)})
    enc["blocks"] = blocks
    enc["mid"] = mid(ch)
    enc["norm_out"] = _norm_init(ch, dev)
    enc["conv_out"] = _conv_init(gen, 3, ch, 2 * cfg.z_channels)
    enc["quant_conv"] = _conv_init(gen, 1, 2 * cfg.z_channels, 2 * cfg.z_channels)

    dec = {
        "post_quant_conv": _conv_init(gen, 1, cfg.z_channels, cfg.z_channels),
        "conv_in": _conv_init(gen, 3, cfg.z_channels, ch),
        "mid": mid(ch),
    }
    dblocks = []
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for _ in range(cfg.num_res_blocks + 1):
            dblocks.append({"res": _init_vae_resblock(gen, ch, mult * bc)})
            ch = mult * bc
        if level != 0:
            dblocks.append({"up": _conv_init(gen, 3, ch, ch)})
    dec["blocks"] = dblocks
    dec["norm_out"] = _norm_init(ch, dev)
    dec["conv_out"] = _conv_init(gen, 3, ch, cfg.in_channels)
    return {"encoder": enc, "decoder": dec}


def encode_moments(params: Dict, img: torch.Tensor, cfg: VAEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """img (B, 3, H, W) in [-1, 1] -> (mean, logvar) of the latent posterior, f32."""
    p = params["encoder"]
    h = conv2d(p["conv_in"], img.to(torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32))
    for blk in p["blocks"]:
        if "down" in blk:
            h = conv2d(blk["down"], F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
        else:
            h = _vae_resblock(blk["res"], h)
    h = _mid(p["mid"], h)
    h = conv2d(p["conv_out"], F.silu(group_norm(p["norm_out"], h)))
    h = conv2d(p["quant_conv"], h, padding=0)
    mean, logvar = h.chunk(2, dim=1)
    return mean.float(), logvar.float().clamp(-30.0, 20.0)


def encode(params: Dict, img: torch.Tensor, cfg: VAEConfig, gen: Optional[torch.Generator] = None,
           sample: bool = False) -> torch.Tensor:
    """-> the scaled latent; with `sample` and `gen`, a draw from the posterior."""
    mean, logvar = encode_moments(params, img, cfg)
    if sample and gen is not None:
        mean = mean + torch.exp(0.5 * logvar) * torch.randn(mean.shape, generator=gen, device=mean.device)
    return cfg.scale_factor * mean


def decode(params: Dict, z: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    """scaled latent (B, z, h, w) -> image (B, 3, H, W) in about [-1, 1], f32."""
    p = params["decoder"]
    h = conv2d(p["post_quant_conv"], z / cfg.scale_factor, padding=0)
    h = conv2d(p["conv_in"], h)
    h = _mid(p["mid"], h)
    for blk in p["blocks"]:
        h = conv2d(blk["up"], _upsample_nn(h)) if "up" in blk else _vae_resblock(blk["res"], h)
    h = conv2d(p["conv_out"], F.silu(group_norm(p["norm_out"], h)))
    return h.float()
