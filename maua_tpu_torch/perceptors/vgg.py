"""VGG16 / VGG19 feature extractor.

Port of `maua_tpu/perceptors/vgg.py` (init_params, params_from_torch,
features, VGGPerceptor): the conv stack with a feature after every relu,
max, avg (x2) or l2 (x0.78) pooling between blocks. Images are NHWC in
[-1, 1] and features NHWC; the convs run NCHW. Parameters are a list of
{"w": OIHW, "b"} in conv order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..utility import resolve_device, to_device
from . import Perceptor

VGG16_LAYOUT = (2, 2, 3, 3, 3)
VGG19_LAYOUT = (2, 2, 4, 4, 4)
CHANNELS = (64, 128, 256, 512, 512)

# style and content layers as relu indices (the kbc convention)
DEFAULT_CONTENT = (8,)
DEFAULT_STYLE = (1, 3, 6, 10, 14)  # vgg19 (16 relus)
DEFAULT_STYLE_16 = (1, 3, 6, 9, 12)  # vgg16 (13 relus)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _layout(arch: str):
    return VGG19_LAYOUT if "19" in arch else VGG16_LAYOUT


def init_params(gen: torch.Generator, arch: str = "vgg19") -> List[Dict]:
    """He-normal convs and zero biases, drawn from `gen`."""
    params, ci = [], 3
    for block, n_convs in enumerate(_layout(arch)):
        co = CHANNELS[block]
        for _ in range(n_convs):
            w = torch.randn(co, ci, 3, 3, generator=gen, device=gen.device) * math.sqrt(2.0 / (ci * 9))
            params.append({"w": w, "b": torch.zeros(co, device=gen.device)})
            ci = co
    return params


def params_from_torch(sd: Dict, arch: str = "vgg19") -> List[Dict]:
    """A torchvision `features.{idx}.weight` / `.bias` state dict -> the parameter list."""
    convs = sorted(int(k.split(".")[1]) for k in sd if k.startswith("features.") and k.endswith(".weight"))
    return [{"w": torch.as_tensor(sd[f"features.{i}.weight"]).float(), "b": torch.as_tensor(sd[f"features.{i}.bias"]).float()}
            for i in convs]


def conv_relu(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return F.relu(F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), padding=1))


def pool2(x: torch.Tensor, kind: str = "max") -> torch.Tensor:
    """2x2 pooling of NCHW maps; avg and l2 rescaled for the activation scale max pooling gives."""
    if kind == "avg":
        return F.avg_pool2d(x, 2) * 2.0
    if kind == "l2":
        return torch.sqrt(F.avg_pool2d(x.square(), 2) * 4.0) * 0.78
    return F.max_pool2d(x, 2)


def features(params: List[Dict], img: torch.Tensor, arch: str = "vgg19", pool: str = "max") -> List[torch.Tensor]:
    """img (B, H, W, 3) in [-1, 1] -> the relu features, NHWC."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(_IMAGENET_STD, dtype=img.dtype, device=img.device)
    x = (((img + 1.0) / 2.0 - mean) / std).permute(0, 3, 1, 2)
    feats, i = [], 0
    layout = _layout(arch)
    for block, n_convs in enumerate(layout):
        for _ in range(n_convs):
            x = conv_relu(params[i], x)
            feats.append(x.permute(0, 2, 3, 1))
            i += 1
        if block < len(layout) - 1:
            x = pool2(x, pool)
    return feats


class VGGPerceptor(Perceptor):
    """VGG features with content and style layers; random weights from `seed` on `device` unless given."""

    def __init__(self, arch: str = "vgg19", params: Optional[List[Dict]] = None,
                 content_layers: Optional[Sequence[int]] = None, style_layers: Optional[Sequence[int]] = None,
                 pool: str = "max", pooling: Optional[str] = None, content_strength: float = 1.0,
                 style_strength: float = 1.0, device=None, seed: int = 0):
        if style_layers is None:
            style_layers = DEFAULT_STYLE if "19" in arch else DEFAULT_STYLE_16
        if content_layers is None:
            content_layers = DEFAULT_CONTENT
        super().__init__(content_layers, style_layers, content_strength, style_strength)
        self.arch = arch
        self.pool = pooling if pooling is not None else pool
        if self.pool not in ("max", "avg", "l2"):
            raise ValueError(f"unknown pooling {self.pool!r} (one of max/avg/l2)")
        self.device = resolve_device(device)
        self.params = to_device(params, self.device) if params is not None \
            else init_params(torch.Generator(device=self.device).manual_seed(seed), arch)

    def get_features(self, img):
        return features(self.params, img, self.arch, self.pool)
