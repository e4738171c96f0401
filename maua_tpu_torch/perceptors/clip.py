"""CLIP perceptor: the ViT image tower, the text tower and their joint embedding.

Port of `maua_tpu/perceptors/clip.py` (CLIPVisionConfig,
init_vision_params, encode_image, CLIPPerceptor, AestheticPerceptor,
NIMAPerceptor). The text tower is `maua_tpu_torch.text.clip_text`. The
image tower's attention is plain softmax attention, as in maua_tpu (not
the dispatcher). Images are NHWC in [-1, 1].

Parameters: `patch_embed` OIHW (width, 3, p, p), linear weights (out,
in), `proj` (width, embed_dim) and `text_proj` (text width, embed_dim)
as right-hand factors; `maua_tpu_torch.bridge.clip_vision_params_to_torch`
converts maua_tpu's tree. Without parameters the towers are drawn from
a torch.Generator seeded with `seed` on `device`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..diffusion.models.unet import _linear, _norm_init, layer_norm, linear
from ..ops.warp import resize
from ..text import clip_text
from ..utility import resolve_device, to_device
from . import Perceptor

_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512


def init_vision_params(cfg: CLIPVisionConfig, gen: torch.Generator) -> Dict:
    """Random parameters with maua_tpu's init distributions, drawn from `gen`."""
    w, dev = cfg.width, gen.device
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    p = {
        "patch_embed": torch.randn(w, 3, cfg.patch_size, cfg.patch_size, generator=gen, device=dev) * 0.02,
        "class_embedding": torch.randn(w, generator=gen, device=dev) * 0.02,
        "positional_embedding": torch.randn(n_patches + 1, w, generator=gen, device=dev) * 0.01,
        "ln_pre": _norm_init(w, dev),
        "ln_post": _norm_init(w, dev),
        "proj": torch.randn(w, cfg.embed_dim, generator=gen, device=dev) / math.sqrt(w),
        "blocks": [],
    }
    for _ in range(cfg.layers):
        p["blocks"].append({
            "ln1": _norm_init(w, dev),
            **{k: _linear(gen, w, w) for k in ("q", "k", "v", "out")},
            "ln2": _norm_init(w, dev),
            "fc1": _linear(gen, w, w * 4),
            "fc2": _linear(gen, w * 4, w),
        })
    return p


def _mha(blk, x, heads):
    n, length, w = x.shape
    hd = w // heads
    q, k, v = (linear(blk[name], x).reshape(n, length, heads, hd).transpose(1, 2) for name in "qkv")
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    return linear(blk["out"], torch.matmul(probs, v).transpose(1, 2).reshape(n, length, w))


def encode_image(params: Dict, img: torch.Tensor, cfg: CLIPVisionConfig) -> torch.Tensor:
    """img (B, S, S, 3) in [-1, 1] -> unit-norm embeddings (B, embed_dim)."""
    mean = torch.tensor(_CLIP_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(_CLIP_STD, dtype=img.dtype, device=img.device)
    x = (((img + 1.0) / 2.0 - mean) / std).permute(0, 3, 1, 2)
    x = F.conv2d(x, params["patch_embed"].to(x.dtype), stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2)  # (B, gh * gw, width), row-major patches
    cls = params["class_embedding"].to(x.dtype).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1)
    x = x + params["positional_embedding"][: x.shape[1]].to(x.dtype)
    x = layer_norm(params["ln_pre"], x)
    for blk in params["blocks"]:
        x = x + _mha(blk, layer_norm(blk["ln1"], x), cfg.heads)
        x = x + linear(blk["fc2"], F.gelu(linear(blk["fc1"], layer_norm(blk["ln2"], x)), approximate="tanh"))
    x = layer_norm(params["ln_post"], x[:, 0])
    emb = x @ params["proj"].to(x.dtype)
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


def resize_to(img: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC img bilinearly resized to size x size (antialiased when shrinking, as jax.image.resize)."""
    if img.shape[1:3] == (size, size):
        return img
    return resize(img.permute(0, 3, 1, 2), (size, size), "bilinear").permute(0, 2, 3, 1)


class CLIPPerceptor(Perceptor):
    """Dual-tower CLIP with unit-norm joint embeddings (ViT-B/32 image tower,
    a 512-wide, 6-layer text tower by default). Random towers are drawn in
    the order vision, text, text_proj."""

    def __init__(self, vision_params: Optional[Dict] = None, vision_cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 text_params: Optional[Dict] = None, text_cfg: Optional[clip_text.CLIPTextConfig] = None,
                 text_proj: Optional[torch.Tensor] = None, device=None, seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.vision_cfg = vision_cfg
        self.text_cfg = text_cfg or clip_text.CLIPTextConfig(width=512, layers=6, heads=8)
        self.vision_params = to_device(vision_params, self.device) if vision_params is not None \
            else init_vision_params(vision_cfg, gen)
        self.text_params = to_device(text_params, self.device) if text_params is not None \
            else clip_text.init_params(self.text_cfg, gen)
        if text_proj is None:
            text_proj = torch.randn(self.text_cfg.width, vision_cfg.embed_dim, generator=gen,
                                    device=self.device) / math.sqrt(self.text_cfg.width)
        self.text_proj = torch.as_tensor(np.asarray(text_proj) if not isinstance(text_proj, torch.Tensor)
                                         else text_proj, dtype=torch.float32).to(self.device)
        self.image_size = vision_cfg.image_size

    def encode_image(self, img) -> torch.Tensor:
        """NHWC images in [-1, 1], resized to image_size -> (B, embed_dim)."""
        return encode_image(self.vision_params, resize_to(img, self.image_size), self.vision_cfg)

    def encode_text(self, texts) -> torch.Tensor:
        """Texts -> (N, embed_dim): the text tower's state at the end token (the largest id), projected."""
        tokens = clip_text.tokenize(texts, self.text_cfg.context_length)
        hidden = clip_text.encode_text(self.text_params, tokens, self.text_cfg)
        eot = torch.as_tensor(np.argmax(tokens, axis=-1), device=hidden.device)
        emb = hidden[torch.arange(hidden.shape[0], device=hidden.device), eot] @ self.text_proj
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)

    def get_features(self, img) -> List[torch.Tensor]:
        return [self.encode_image(img)]


class AestheticPerceptor(CLIPPerceptor):
    """A linear aesthetic score on the image embedding; `head` = {"w": (embed_dim, 1), "b": (1,)}."""

    def __init__(self, head: Optional[Dict] = None, **kw):
        super().__init__(**kw)
        if head is None:
            gen = torch.Generator(device=self.device).manual_seed(42)
            head = {"w": torch.randn(self.vision_cfg.embed_dim, 1, generator=gen, device=self.device) * 0.02,
                    "b": torch.zeros(1, device=self.device)}
        self.head = to_device(head, self.device)

    def score(self, img) -> torch.Tensor:
        return (self.encode_image(img) @ self.head["w"] + self.head["b"]).squeeze(-1)


class NIMAPerceptor(CLIPPerceptor):
    """Neural image assessment: a 10-bucket quality distribution on the image
    embedding; `head` = {"w": (embed_dim, 10), "b": (10,)}."""

    def __init__(self, head: Optional[Dict] = None, **kw):
        super().__init__(**kw)
        if head is None:
            gen = torch.Generator(device=self.device).manual_seed(7)
            head = {"w": torch.randn(self.vision_cfg.embed_dim, 10, generator=gen, device=self.device) * 0.02,
                    "b": torch.zeros(10, device=self.device)}
        self.head = to_device(head, self.device)

    def distribution(self, img) -> torch.Tensor:
        return torch.softmax(self.encode_image(img) @ self.head["w"] + self.head["b"], dim=-1)

    def score(self, img) -> torch.Tensor:
        """Mean opinion score in [1, 10]."""
        return self.distribution(img) @ (torch.arange(10, dtype=torch.float32, device=self.device) + 1.0)
