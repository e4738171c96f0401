"""SwinIR, the window-attention transformer for real-world super-resolution.

Port of `maua_tpu/super/models/swinir.py`: the "nearest+conv" real-SR
variants M (embed 180, 6x6 blocks, 6 heads, 1conv residual) and L (embed
240, 9x6 blocks, 8 heads, 3conv residual), window 8, mlp ratio 2. The
convolutions take NCHW; the transformer blocks work on (B, H, W, C)
tokens, so that the linear layers act on the last axis. Window attention
is `torch.matmul` and a softmax in f32, as maua_tpu's einsums are (it does
not route them through its Pallas attention either). The shifted-window
mask (-100 across regions) and the relative-position index are built in
numpy, once per forward. `params_from_torch` reads the official state
dict (layers.{i}.residual_group.blocks.{j}.*).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .rrdbnet import _conv_init, as_f32, conv


@dataclasses.dataclass(frozen=True)
class SwinIRConfig:
    in_chans: int = 3
    embed_dim: int = 180
    depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    num_heads: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    window_size: int = 8
    mlp_ratio: float = 2.0
    upscale: int = 4
    img_range: float = 1.0
    resi_connection: str = "1conv"  # "1conv" | "3conv"
    num_feat: int = 64  # upsampler width
    dtype: str = "float32"


SWINIR_M = SwinIRConfig()
SWINIR_L = SwinIRConfig(embed_dim=240, depths=(6,) * 9, num_heads=(8,) * 9, resi_connection="3conv")

_RGB_MEAN = (0.4488, 0.4371, 0.4040)


# ------------------------------------------------------------- params
def _linear_init(gen, ci, co):
    return {"w": torch.randn((co, ci), generator=gen, device=gen.device) * 0.02,
            "b": torch.zeros((co,), device=gen.device)}


def _ln_init(dim, device):
    return {"g": torch.ones((dim,), device=device), "b": torch.zeros((dim,), device=device)}


def _init_block(gen, cfg: SwinIRConfig, heads: int):
    d = cfg.embed_dim
    hidden = int(d * cfg.mlp_ratio)
    nbias = (2 * cfg.window_size - 1) ** 2
    return {
        "norm1": _ln_init(d, gen.device),
        "qkv": _linear_init(gen, d, 3 * d),
        "proj": _linear_init(gen, d, d),
        "rpb": torch.randn((nbias, heads), generator=gen, device=gen.device) * 0.02,
        "norm2": _ln_init(d, gen.device),
        "fc1": _linear_init(gen, d, hidden),
        "fc2": _linear_init(gen, hidden, d),
    }


def _init_resi_conv(gen, cfg: SwinIRConfig):
    d = cfg.embed_dim
    if cfg.resi_connection == "1conv":
        return {"conv": _conv_init(gen, d, d)}
    return {"conv0": _conv_init(gen, d, d // 4), "conv1": _conv_init(gen, d // 4, d // 4, k=1),
            "conv2": _conv_init(gen, d // 4, d)}


def init_params(gen: torch.Generator, cfg: SwinIRConfig = SWINIR_M) -> Dict:
    d, nf = cfg.embed_dim, cfg.num_feat
    layers = [{"blocks": [_init_block(gen, cfg, cfg.num_heads[li]) for _ in range(cfg.depths[li])],
               "conv": _init_resi_conv(gen, cfg)} for li in range(len(cfg.depths))]
    return {
        "conv_first": _conv_init(gen, cfg.in_chans, d),
        "patch_norm": _ln_init(d, gen.device),
        "layers": layers,
        "norm": _ln_init(d, gen.device),
        "conv_after_body": _init_resi_conv(gen, cfg),
        "conv_before_upsample": _conv_init(gen, d, nf),
        "conv_up1": _conv_init(gen, nf, nf),
        "conv_up2": _conv_init(gen, nf, nf),
        "conv_hr": _conv_init(gen, nf, nf),
        "conv_last": _conv_init(gen, nf, cfg.in_chans),
    }


# ------------------------------------------------------ static tables
@functools.lru_cache(maxsize=None)
def _rel_pos_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # 2, N, N
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws^2, ws^2) additive attention mask of the shifted windows."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] != win[:, :, None]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


# ------------------------------------------------------------ forward
def _ln(p, x):
    """LayerNorm over the last axis in f32, eps 1e-5."""
    return F.layer_norm(x.float(), x.shape[-1:], p["g"].float(), p["b"].float(), eps=1e-5).to(x.dtype)


def _linear(p, x):
    return F.linear(x, p["w"].to(x.dtype), p["b"].to(x.dtype))


def _windows(x, ws):
    """(B, H, W, C) -> (B*nW, ws*ws, C)"""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _unwindows(x, ws, b, h, w):
    c = x.shape[-1]
    x = x.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _attention(p, x, heads: int, index: torch.Tensor, mask):
    """x: (B*nW, N, C) with N = ws^2; index: the flat relative-position index;
    mask: (nW, N, N) or None."""
    bnw, n, c = x.shape
    hd = c // heads
    qkv = _linear(p["qkv"], x).reshape(bnw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = torch.matmul(q * (hd**-0.5), k.transpose(-2, -1)).float()
    bias = p["rpb"][index].reshape(n, n, heads)
    attn = attn + bias.permute(2, 0, 1)[None].float()
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(bnw // nw, nw, heads, n, n) + mask[None, :, None]).reshape(bnw, heads, n, n)
    attn = torch.softmax(attn, dim=-1).to(x.dtype)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(bnw, n, c)
    return _linear(p["proj"], out)


def _swin_block(p, x, heads: int, ws: int, shift: int, index, mask):
    b, h, w, c = x.shape
    shortcut = x
    x = _ln(p["norm1"], x)
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    x = _unwindows(_attention(p, _windows(x, ws), heads, index, mask if shift else None), ws, b, h, w)
    if shift:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = shortcut + x
    y = _ln(p["norm2"], x)
    return x + _linear(p["fc2"], F.gelu(_linear(p["fc1"], y)))


def _resi_conv(p, x, cfg: SwinIRConfig):
    """A residual connection's conv(s) on (B, C, H, W)."""
    if cfg.resi_connection == "1conv":
        return conv(p["conv"], x)
    y = F.leaky_relu(conv(p["conv0"], x), 0.2)
    y = F.leaky_relu(conv(p["conv1"], y, padding=0), 0.2)
    return conv(p["conv2"], y)


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def forward(params: Dict, img: torch.Tensor, cfg: SwinIRConfig = SWINIR_M) -> torch.Tensor:
    """img (B, 3, H, W) in [0, 1], H and W multiples of window_size -> (B, 3,
    upscale*H, upscale*W), f32. The `Upscaler` mirror-pads to the window
    multiple."""
    b, _, h, w = img.shape
    ws = cfg.window_size
    if h % ws or w % ws:
        raise ValueError(f"H, W must be multiples of {ws} (pad in the caller), got {h}x{w}")
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    lrelu = lambda v: F.leaky_relu(v, 0.2)  # noqa: E731
    index = torch.from_numpy(_rel_pos_index(ws).reshape(-1)).to(img.device)
    mask = torch.from_numpy(_shift_mask(h, w, ws, ws // 2)).to(img.device)

    mean = torch.tensor(_RGB_MEAN, device=img.device)[None, :, None, None]
    x = ((img.float() - mean) * cfg.img_range).to(dtype)
    feat = conv(params["conv_first"], x)

    # patch norm -> residual Swin groups -> norm, on (B, H, W, C) tokens
    y = _ln(params["patch_norm"], feat.permute(0, 2, 3, 1))
    for li, layer in enumerate(params["layers"]):
        y_in = y
        for bi, blk in enumerate(layer["blocks"]):
            y = _swin_block(blk, y, cfg.num_heads[li], ws, (ws // 2) if bi % 2 else 0, index, mask)
        y = _resi_conv(layer["conv"], y.permute(0, 3, 1, 2), cfg).permute(0, 2, 3, 1) + y_in
    y = _ln(params["norm"], y).permute(0, 3, 1, 2)

    feat = _resi_conv(params["conv_after_body"], y, cfg) + feat
    feat = lrelu(conv(params["conv_before_upsample"], feat))
    feat = lrelu(conv(params["conv_up1"], _up2(feat)))
    if cfg.upscale == 4:
        feat = lrelu(conv(params["conv_up2"], _up2(feat)))
    out = conv(params["conv_last"], lrelu(conv(params["conv_hr"], feat)))
    return out.float() / cfg.img_range + mean


# --------------------------------------------------------- conversion
def params_from_torch(sd: Dict, cfg: SwinIRConfig = SWINIR_M) -> Dict:
    """Official SwinIR state dict -> the port's tree (torch layouts kept)."""

    def wb(name):
        return {"w": as_f32(sd[f"{name}.weight"]), "b": as_f32(sd[f"{name}.bias"])}

    def ln(name):
        return {"g": as_f32(sd[f"{name}.weight"]), "b": as_f32(sd[f"{name}.bias"])}

    def resi(base):
        if cfg.resi_connection == "1conv":
            return {"conv": wb(base)}
        return {"conv0": wb(f"{base}.0"), "conv1": wb(f"{base}.2"), "conv2": wb(f"{base}.4")}

    layers = []
    for li in range(len(cfg.depths)):
        blocks = []
        for bi in range(cfg.depths[li]):
            base = f"layers.{li}.residual_group.blocks.{bi}"
            blocks.append({
                "norm1": ln(f"{base}.norm1"),
                "qkv": wb(f"{base}.attn.qkv"),
                "proj": wb(f"{base}.attn.proj"),
                "rpb": as_f32(sd[f"{base}.attn.relative_position_bias_table"]),
                "norm2": ln(f"{base}.norm2"),
                "fc1": wb(f"{base}.mlp.fc1"),
                "fc2": wb(f"{base}.mlp.fc2"),
            })
        layers.append({"blocks": blocks, "conv": resi(f"layers.{li}.conv")})
    return {
        "conv_first": wb("conv_first"),
        "patch_norm": ln("patch_embed.norm"),
        "layers": layers,
        "norm": ln("norm"),
        "conv_after_body": resi("conv_after_body"),
        "conv_before_upsample": wb("conv_before_upsample.0"),
        "conv_up1": wb("conv_up1"),
        "conv_up2": wb("conv_up2"),
        "conv_hr": wb("conv_hr"),
        "conv_last": wb("conv_last"),
    }
