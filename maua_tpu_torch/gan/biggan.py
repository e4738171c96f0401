"""BigGAN generator with instance conditioning (the IC-GAN backbone).

Port of `maua_tpu/gan/biggan.py`: hierarchical z (per-block z chunks
concatenated onto the conditioning vector), class-conditional BatchNorm with
stored statistics (`ccbn`: normalized, scaled by 1 + gain(y), shifted by
bias(y)), G blocks (bn-relu-upsample-conv twice and an upsampled 1x1 skip),
SA-GAN self-attention with 2x2 max-pooled phi and g at one resolution, and a
BN-ReLU-conv-tanh head. NCHW activations; conv weights OIHW and linear
weights (out, in) (`bridge.biggan_params_to_torch` carries maua_tpu's
pytree over). Instance conditioning embeds a 2048-d SwAV feature in place of
(or beside) the class embedding.

`params_from_torch` reads a BigGAN-PyTorch / ic_gan state dict and folds
spectral norm: the inference weight is `weight / sigma`, sigma from the
stored `sv0`, else from five power iterations from `u0`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utility import resolve_device, to_device


@dataclasses.dataclass(frozen=True)
class BigGANConfig:
    resolution: int = 256
    ch: int = 96
    dim_z: int = 120
    shared_dim: int = 128
    n_classes: int = 0  # 0 = pure instance conditioning
    instance_cond: bool = True
    feature_dim: int = 2048  # SwAV ResNet-50 features
    attention_res: int = 64
    bn_eps: float = 1e-4

    @property
    def arch(self):
        """(in_mult, out_mult) per block, 4x4 -> resolution."""
        mults = {
            32: ([4, 4, 4], [4, 4, 4]),
            64: ([16, 16, 8, 4], [16, 8, 4, 2]),
            128: ([16, 16, 8, 4, 2], [16, 8, 4, 2, 1]),
            256: ([16, 16, 8, 8, 4, 2], [16, 8, 8, 4, 2, 1]),
        }
        return mults[self.resolution]

    @property
    def num_blocks(self) -> int:
        return len(self.arch[0])

    @property
    def z_chunk(self) -> int:
        return self.dim_z // (self.num_blocks + 1)

    @property
    def cond_dim(self) -> int:
        base = self.shared_dim if (self.n_classes > 0 or self.instance_cond) else 0
        return base + self.z_chunk

    @property
    def attention_channels(self) -> int:
        return self.arch[1][int(math.log2(self.attention_res)) - 3] * self.ch


def _linear(gen, ci, co, bias=True):
    p = {"w": torch.randn(co, ci, generator=gen, device=gen.device) / math.sqrt(ci)}
    if bias:
        p["b"] = torch.zeros(co, device=gen.device)
    return p


def _conv(gen, k, ci, co, bias=True):
    p = {"w": torch.randn(co, ci, k, k, generator=gen, device=gen.device) * math.sqrt(2.0 / (ci * k * k))}
    if bias:
        p["b"] = torch.zeros(co, device=gen.device)
    return p


def _ccbn(gen, ch, cond_dim):
    return {"gain": _linear(gen, cond_dim, ch, bias=False), "bias": _linear(gen, cond_dim, ch, bias=False),
            "mean": torch.zeros(ch, device=gen.device), "var": torch.ones(ch, device=gen.device)}


def init_params(cfg: BigGANConfig, gen: torch.Generator) -> Dict:
    """Random parameters with maua_tpu's init distributions, drawn from `gen`."""
    in_m, out_m = cfg.arch
    dev = gen.device
    p: Dict = {"linear": _linear(gen, cfg.z_chunk, 4 * 4 * in_m[0] * cfg.ch)}
    if cfg.n_classes > 0:
        p["shared"] = torch.randn(cfg.n_classes, cfg.shared_dim, generator=gen, device=dev) * 0.02
    if cfg.instance_cond:
        p["embed_features"] = _linear(gen, cfg.feature_dim, cfg.shared_dim, bias=False)
    blocks: List[Dict] = []
    for i in range(cfg.num_blocks):
        ci, co = in_m[i] * cfg.ch, out_m[i] * cfg.ch
        blocks.append({"bn1": _ccbn(gen, ci, cfg.cond_dim), "conv1": _conv(gen, 3, ci, co),
                       "bn2": _ccbn(gen, co, cfg.cond_dim), "conv2": _conv(gen, 3, co, co),
                       "conv_sc": _conv(gen, 1, ci, co)})
    p["blocks"] = blocks
    c = cfg.attention_channels
    p["attention"] = {"theta": _conv(gen, 1, c, c // 8, bias=False), "phi": _conv(gen, 1, c, c // 8, bias=False),
                      "g": _conv(gen, 1, c, c // 2, bias=False), "o": _conv(gen, 1, c // 2, c, bias=False),
                      "gamma": torch.zeros((), device=dev)}
    co = out_m[-1] * cfg.ch
    p["output"] = {"bn": {"scale": torch.ones(co, device=dev), "bias": torch.zeros(co, device=dev),
                          "mean": torch.zeros(co, device=dev), "var": torch.ones(co, device=dev)},
                   "conv": _conv(gen, 3, co, 3)}
    return p


# ----------------------------------------------------------- forward
def _apply_conv(p, x):
    return F.conv2d(x, p["w"], p.get("b"), padding=p["w"].shape[-1] // 2)


def _apply_ccbn(p, x, y, eps):
    gain = 1.0 + y @ p["gain"]["w"].T
    bias = y @ p["bias"]["w"].T
    xn = (x - p["mean"][:, None, None]) * torch.rsqrt(p["var"] + eps)[:, None, None]
    return xn * gain[:, :, None, None] + bias[:, :, None, None]


def _upsample(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _attention(p, x):
    """SA-GAN attention (BigGAN-PyTorch's Attention) with 2x2 max-pooled phi and g."""
    b, c, h, w = x.shape
    theta = _apply_conv(p["theta"], x).reshape(b, c // 8, h * w)
    phi = F.max_pool2d(_apply_conv(p["phi"], x), 2).reshape(b, c // 8, h * w // 4)
    g = F.max_pool2d(_apply_conv(p["g"], x), 2).reshape(b, c // 2, h * w // 4)
    beta = torch.softmax(theta.transpose(1, 2) @ phi, dim=-1)  # (b, hw, hw/4)
    o = (g @ beta.transpose(1, 2)).reshape(b, c // 2, h, w)
    return x + p["gamma"] * _apply_conv(p["o"], o)


def generator(params: Dict, z: torch.Tensor, cfg: BigGANConfig, labels: Optional[torch.Tensor] = None,
              features: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z (B, dim_z), optional class ids (B,) and instance features (B, feature_dim) -> (B, 3, R, R) in
    [-1, 1]."""
    n = cfg.num_blocks
    zs = torch.split(z[:, : cfg.z_chunk * (n + 1)], cfg.z_chunk, dim=1)
    cond = []
    if cfg.instance_cond and features is not None:
        cond.append(features @ params["embed_features"]["w"].T)
    if cfg.n_classes > 0 and labels is not None:
        cond.append(params["shared"][labels])
    base = sum(cond) if cond else None

    h = F.linear(zs[0], params["linear"]["w"], params["linear"]["b"])
    h = h.reshape(z.shape[0], 4, 4, -1).permute(0, 3, 1, 2)  # maua_tpu's (4, 4, C) reshape
    res = 4
    for i, blk in enumerate(params["blocks"]):
        y = zs[i + 1] if base is None else torch.cat([base, zs[i + 1]], dim=1)
        x = _upsample(F.relu(_apply_ccbn(blk["bn1"], h, y, cfg.bn_eps)))
        x = _apply_conv(blk["conv1"], x)
        x = _apply_conv(blk["conv2"], F.relu(_apply_ccbn(blk["bn2"], x, y, cfg.bn_eps)))
        h = x + _apply_conv(blk["conv_sc"], _upsample(h))
        res *= 2
        if res == cfg.attention_res:
            h = _attention(params["attention"], h)
    ob = params["output"]["bn"]
    h = (h - ob["mean"][:, None, None]) * torch.rsqrt(ob["var"] + cfg.bn_eps)[:, None, None] \
        * ob["scale"][:, None, None] + ob["bias"][:, None, None]
    return torch.tanh(_apply_conv(params["output"]["conv"], F.relu(h)))


# ---------------------------------------------------------- converter
def _sn_fold(sd, prefix: str) -> np.ndarray:
    """Fold spectral norm: weight / sigma, sigma from the stored `sv0` buffer or from five power
    iterations from `u0` (a seed-0 normal draw where the state dict has none)."""
    w = np.asarray(sd[f"{prefix}.weight"], np.float32)
    if f"{prefix}.sv0" in sd:
        sigma = float(np.asarray(sd[f"{prefix}.sv0"]).reshape(-1)[0])
    else:
        mat = w.reshape(w.shape[0], -1)
        u = np.asarray(sd.get(f"{prefix}.u0", np.random.default_rng(0).standard_normal((1, mat.shape[0])))).reshape(-1)
        for _ in range(5):
            v = mat.T @ u
            v /= np.linalg.norm(v) + 1e-12
            u = mat @ v
            u /= np.linalg.norm(u) + 1e-12
        sigma = float(u @ mat @ v)
    return w / max(sigma, 1e-12)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _layer_from(sd, prefix) -> Dict:
    """A conv (OIHW) or linear ((out, in)) layer: the folded weight and the bias where there is one."""
    p = {"w": _t(_sn_fold(sd, prefix))}
    if f"{prefix}.bias" in sd:
        p["b"] = _t(sd[f"{prefix}.bias"])
    return p


def params_from_torch(sd, cfg: BigGANConfig, device=None) -> Dict:
    """A BigGAN-PyTorch / ic_gan generator state dict -> params. Blocks are `blocks.{i}.0` GBlocks, the
    attention `blocks.{j}.1`; ccbn statistics are `stored_mean` / `stored_var`."""
    sd = {k: np.asarray(v.float().cpu() if isinstance(v, torch.Tensor) else v) for k, v in sd.items()}

    def ccbn_from(prefix):
        return {"gain": {"w": _t(_sn_fold(sd, f"{prefix}.gain"))}, "bias": {"w": _t(_sn_fold(sd, f"{prefix}.bias"))},
                "mean": _t(sd[f"{prefix}.stored_mean"]), "var": _t(sd[f"{prefix}.stored_var"])}

    p: Dict = {"linear": _layer_from(sd, "linear")}
    if any(k.startswith("shared.") for k in sd):
        p["shared"] = _t(sd["shared.weight"])
    for cand in ("embed_features", "feature_embed", "shared_features"):
        if f"{cand}.weight" in sd:
            p["embed_features"] = {"w": _t(_sn_fold(sd, cand))}
            break
    blocks, attn, i = [], None, 0
    while f"blocks.{i}.0.conv1.weight" in sd:
        pre = f"blocks.{i}.0"
        blocks.append({"bn1": ccbn_from(f"{pre}.bn1"), "conv1": _layer_from(sd, f"{pre}.conv1"),
                       "bn2": ccbn_from(f"{pre}.bn2"), "conv2": _layer_from(sd, f"{pre}.conv2"),
                       "conv_sc": _layer_from(sd, f"{pre}.conv_sc")})
        if f"blocks.{i}.1.theta.weight" in sd:
            apre = f"blocks.{i}.1"
            attn = {k: _layer_from(sd, f"{apre}.{k}") for k in ("theta", "phi", "g", "o")}
            attn["gamma"] = _t(sd[f"{apre}.gamma"]).reshape(())
        i += 1
    p["blocks"] = blocks
    if attn is not None:
        p["attention"] = attn
    scale = sd["output_layer.0.gain"] if "output_layer.0.gain" in sd else sd.get("output_layer.0.weight", np.ones(1))
    p["output"] = {"bn": {"scale": _t(scale).reshape(-1),
                          "bias": _t(sd.get("output_layer.0.bias", np.zeros(1))).reshape(-1),
                          "mean": _t(sd["output_layer.0.stored_mean"]), "var": _t(sd["output_layer.0.stored_var"])},
                   "conv": _layer_from(sd, "output_layer.2")}
    return p if device is None else to_device(p, resolve_device(device))
