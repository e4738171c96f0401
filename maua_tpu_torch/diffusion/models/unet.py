"""Diffusion UNet in PyTorch, as plain functions over a parameter dict.

Port of `maua_tpu/diffusion/models/unet.py`: one configurable network for
the guided-diffusion family (self-attention blocks, scale-shift norm) and
the LDM / Stable Diffusion family (spatial transformers with
cross-attention and a GEGLU feed-forward). Attention goes through the
dispatcher of `kernels/attention.py`, whose kernel route launches the
flash-attention CUDA kernel.

Layout: NCHW activations, OIHW conv weights, (out, in) linear weights;
`maua_tpu_torch.bridge.diffusion_params_to_torch` converts the JAX
package's pytree (NHWC / HWIO / (in, out)) into this form. With
`dtype="bfloat16"` activations and weights are cast at each op, and the
norms compute in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...kernels.attention import attention


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)  # downsample factors
    num_heads: int = 8
    num_head_channels: Optional[int] = None
    context_dim: Optional[int] = 768  # None = self-attention-only UNet
    transformer_depth: int = 1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def heads_for(self, channels: int) -> int:
        if self.num_head_channels is not None:
            return max(channels // self.num_head_channels, 1)
        return self.num_heads


# SD v1.x (CompVis v1-inference.yaml)
SD1_UNET = UNetConfig()
# guided-diffusion 256/512 unconditional
GUIDED_UNET = UNetConfig(
    in_channels=3, out_channels=6, model_channels=256, channel_mult=(1, 1, 2, 2, 4, 4),
    num_res_blocks=2, attention_resolutions=(32, 16, 8), num_head_channels=64,
    context_dim=None, use_scale_shift_norm=True, resblock_updown=True,
)


# ------------------------------------------------------------- helpers
def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _uniform(gen, shape, scale):
    return (torch.rand(shape, generator=gen, device=gen.device) * 2 - 1) * scale


def _linear(gen, ci, co, zero=False):
    w = torch.zeros(co, ci, device=gen.device) if zero else _uniform(gen, (co, ci), 1.0 / math.sqrt(ci))
    return {"w": w, "b": torch.zeros(co, device=gen.device)}


def _conv_init(gen, k, ci, co, zero=False):
    shape = (co, ci, k, k)
    w = torch.zeros(shape, device=gen.device) if zero else _uniform(gen, shape, 1.0 / math.sqrt(ci * k * k))
    return {"w": w, "b": torch.zeros(co, device=gen.device)}


def _norm_init(c, device):
    return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}


def linear(p, x):
    return F.linear(x, p["w"].to(x.dtype), p["b"].to(x.dtype))


def conv2d(p, x, stride=1, padding=1):
    return F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride=stride, padding=padding)


def group_norm(p, x, groups: int = 32, eps: float = 1e-5):
    c = x.shape[1]
    g = min(groups, c)
    while c % g != 0:
        g -= 1
    # contiguous: group norm's forward-mode rule (KLMC2's jvp) views its input (the op copies it anyway)
    return F.group_norm(x.float().contiguous(), g, p["scale"], p["bias"], eps).to(x.dtype)


def layer_norm(p, x, eps: float = 1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"], p["bias"], eps).to(x.dtype)


# ------------------------------------------------------------ resblock
def _init_resblock(gen, ci, co, emb_dim, cfg: UNetConfig):
    p = {
        "norm1": _norm_init(ci, gen.device),
        "conv1": _conv_init(gen, 3, ci, co),
        "emb": _linear(gen, emb_dim, co * 2 if cfg.use_scale_shift_norm else co),
        "norm2": _norm_init(co, gen.device),
        "conv2": _conv_init(gen, 3, co, co, zero=True),
    }
    if ci != co:
        p["skip"] = _conv_init(gen, 1, ci, co)
    return p


def _upsample_nn(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _avgpool(x):
    return F.avg_pool2d(x, 2)


def resblock(p, x, emb, cfg: UNetConfig, up=False, down=False):
    h = F.silu(group_norm(p["norm1"], x))
    if up:
        x, h = _upsample_nn(x), _upsample_nn(h)
    elif down:
        x, h = _avgpool(x), _avgpool(h)
    h = conv2d(p["conv1"], h)
    emb_out = linear(p["emb"], F.silu(emb))[:, :, None, None]
    if cfg.use_scale_shift_norm:
        scale, shift = emb_out.chunk(2, dim=1)
        h = F.silu(group_norm(p["norm2"], h) * (1 + scale) + shift)
    else:
        h = F.silu(group_norm(p["norm2"], h + emb_out))
    h = conv2d(p["conv2"], h)
    skip = conv2d(p["skip"], x, padding=0) if "skip" in p else x
    return skip + h


# ----------------------------------------------------------- attention
def _init_selfattn(gen, c):
    return {
        "norm": _norm_init(c, gen.device),
        "qkv": _conv_init(gen, 1, c, c * 3),
        "proj": _conv_init(gen, 1, c, c, zero=True),
    }


def self_attention_block(p, x, n_heads: int):
    """guided-diffusion AttentionBlock."""
    b, c, h, w = x.shape
    qkv = conv2d(p["qkv"], group_norm(p["norm"], x), padding=0)
    qkv = qkv.reshape(b, 3, n_heads, c // n_heads, h * w).transpose(-1, -2)  # (B, 3, H, N, D)
    out = attention(qkv[:, 0], qkv[:, 1], qkv[:, 2])
    out = out.transpose(-1, -2).reshape(b, c, h, w)
    return x + conv2d(p["proj"], out, padding=0)


def _init_crossattn(gen, query_dim, context_dim, n_heads, head_dim):
    inner = n_heads * head_dim
    dev = gen.device
    return {
        "to_q": {"w": torch.randn(inner, query_dim, generator=gen, device=dev) / math.sqrt(query_dim)},
        "to_k": {"w": torch.randn(inner, context_dim, generator=gen, device=dev) / math.sqrt(context_dim)},
        "to_v": {"w": torch.randn(inner, context_dim, generator=gen, device=dev) / math.sqrt(context_dim)},
        "to_out": _linear(gen, inner, query_dim),
    }


def cross_attention(p, x, context, n_heads: int):
    """LDM CrossAttention. x: (B, N, C); context: (B, M, Ctx)."""
    b, n, _ = x.shape
    q = F.linear(x, p["to_q"]["w"].to(x.dtype))
    k = F.linear(context, p["to_k"]["w"].to(x.dtype))
    v = F.linear(context, p["to_v"]["w"].to(x.dtype))
    hd = q.shape[-1] // n_heads
    q = q.reshape(b, n, n_heads, hd).transpose(1, 2)
    k = k.reshape(b, -1, n_heads, hd).transpose(1, 2)
    v = v.reshape(b, -1, n_heads, hd).transpose(1, 2)
    out = attention(q, k, v)
    return linear(p["to_out"], out.transpose(1, 2).reshape(b, n, -1))


def _init_transformer_block(gen, c, context_dim, n_heads, head_dim):
    return {
        "norm1": _norm_init(c, gen.device),
        "attn1": _init_crossattn(gen, c, c, n_heads, head_dim),
        "norm2": _norm_init(c, gen.device),
        "attn2": _init_crossattn(gen, c, context_dim, n_heads, head_dim),
        "norm3": _norm_init(c, gen.device),
        "ff_in": _linear(gen, c, c * 8),  # GEGLU: 2 * 4c
        "ff_out": _linear(gen, c * 4, c),
    }


def transformer_block(p, x, context, n_heads):
    h = layer_norm(p["norm1"], x)
    x = x + cross_attention(p["attn1"], h, h, n_heads)
    ctx = context if context is not None else x
    x = x + cross_attention(p["attn2"], layer_norm(p["norm2"], x), ctx, n_heads)
    a, gate = linear(p["ff_in"], layer_norm(p["norm3"], x)).chunk(2, dim=-1)
    # jax.nn.gelu defaults to the tanh approximation
    return x + linear(p["ff_out"], a * F.gelu(gate, approximate="tanh"))


def _init_spatial_transformer(gen, c, context_dim, n_heads, depth):
    head_dim = c // n_heads
    p = {
        "norm": _norm_init(c, gen.device),
        "proj_in": _conv_init(gen, 1, c, c),
        "blocks": [_init_transformer_block(gen, c, context_dim, n_heads, head_dim) for _ in range(depth)],
    }
    # small (not zero) init, as the JAX package's, so a random net is not degenerate
    p["proj_out"] = {k: v * 0.1 for k, v in _conv_init(gen, 1, c, c).items()}
    return p


def spatial_transformer(p, x, context, n_heads):
    b, c, h, w = x.shape
    residual = x
    x = conv2d(p["proj_in"], group_norm(p["norm"], x), padding=0)
    x = x.reshape(b, c, h * w).transpose(1, 2)
    for blk in p["blocks"]:
        x = transformer_block(blk, x, context, n_heads)
    x = x.transpose(1, 2).reshape(b, c, h, w)
    return residual + conv2d(p["proj_out"], x, padding=0)


# ----------------------------------------------------------- full unet
def init_params(cfg: UNetConfig, gen: torch.Generator) -> Dict:
    """Random parameters with the JAX package's init distributions, drawn
    from `gen` on its device (the numbers differ from JAX's)."""
    mc = cfg.model_channels
    emb_dim = mc * 4
    dev = gen.device
    p = {
        "time_mlp1": _linear(gen, mc, emb_dim),
        "time_mlp2": _linear(gen, emb_dim, emb_dim),
        "conv_in": _conv_init(gen, 3, cfg.in_channels, mc),
    }

    def attn_init(c):
        heads = cfg.heads_for(c)
        if cfg.context_dim is not None:
            return {"spatial": _init_spatial_transformer(gen, c, cfg.context_dim, heads, cfg.transformer_depth)}
        return {"self": _init_selfattn(gen, c)}

    downs = []
    ch, ds = mc, 1
    input_chs = [mc]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            blk = {"res": _init_resblock(gen, ch, mult * mc, emb_dim, cfg)}
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                blk["attn"] = attn_init(ch)
            downs.append(blk)
            input_chs.append(ch)
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                downs.append({"down_res": _init_resblock(gen, ch, ch, emb_dim, cfg)})
            else:
                downs.append({"down": _conv_init(gen, 3, ch, ch)})
            input_chs.append(ch)
            ds *= 2
    p["downs"] = downs
    p["mid"] = {
        "res1": _init_resblock(gen, ch, ch, emb_dim, cfg),
        "attn": attn_init(ch),
        "res2": _init_resblock(gen, ch, ch, emb_dim, cfg),
    }
    ups = []
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            skip_ch = input_chs.pop()
            blk = {"res": _init_resblock(gen, ch + skip_ch, mult * mc, emb_dim, cfg)}
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                blk["attn"] = attn_init(ch)
            if level != 0 and i == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    blk["up_res"] = _init_resblock(gen, ch, ch, emb_dim, cfg)
                else:
                    blk["up"] = _conv_init(gen, 3, ch, ch)
                ds //= 2
            ups.append(blk)
    p["ups"] = ups
    p["norm_out"] = _norm_init(ch, dev)
    co = _conv_init(gen, 3, ch, cfg.out_channels)
    p["conv_out"] = {"w": co["w"] * 0.1, "b": co["b"]}
    return p


def forward(
    params: Dict,
    x: torch.Tensor,  # (B, C_in, H, W)
    t: torch.Tensor,  # (B,) timesteps (continuous or discrete)
    cfg: UNetConfig,
    context: Optional[torch.Tensor] = None,  # (B, M, context_dim)
) -> torch.Tensor:
    """-> (B, C_out, H, W), f32."""
    dtype = cfg.compute_dtype
    x = x.to(dtype)
    if context is not None:
        context = context.to(dtype)
    emb = timestep_embedding(t, cfg.model_channels)
    emb = linear(params["time_mlp2"], F.silu(linear(params["time_mlp1"], emb))).to(dtype)

    def run_attn(blk, h):
        if "spatial" in blk:
            return spatial_transformer(blk["spatial"], h, context, cfg.heads_for(h.shape[1]))
        return self_attention_block(blk["self"], h, cfg.heads_for(h.shape[1]))

    h = conv2d(params["conv_in"], x)
    skips = [h]
    for blk in params["downs"]:
        if "down" in blk:
            h = conv2d(blk["down"], h, stride=2)
        elif "down_res" in blk:
            h = resblock(blk["down_res"], h, emb, cfg, down=True)
        else:
            h = resblock(blk["res"], h, emb, cfg)
            if "attn" in blk:
                h = run_attn(blk["attn"], h)
        skips.append(h)

    h = resblock(params["mid"]["res1"], h, emb, cfg)
    h = run_attn(params["mid"]["attn"], h)
    h = resblock(params["mid"]["res2"], h, emb, cfg)

    for blk in params["ups"]:
        h = resblock(blk["res"], torch.cat([h, skips.pop()], dim=1), emb, cfg)
        if "attn" in blk:
            h = run_attn(blk["attn"], h)
        if "up" in blk:
            h = conv2d(blk["up"], _upsample_nn(h))
        elif "up_res" in blk:
            h = resblock(blk["up_res"], h, emb, cfg, up=True)

    h = F.silu(group_norm(params["norm_out"], h))
    return conv2d(params["conv_out"], h).float()
