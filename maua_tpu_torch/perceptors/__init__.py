"""Perceptors: feature extractors that drive style transfer and guidance.

Port of `maua_tpu/perceptors/__init__.py` (Perceptor, load_perceptor).
Features are lists of NHWC maps returned by functional extractors. The
CLIP, LPIPS and VGG perceptors are ported; the caffe model zoo
(`perceptors/pgg.py`) is not yet and raises.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence

import torch

from ..loss import feature_loss, gram_matrix, scaled_mse_loss


class Perceptor:
    """Content and style layers over `get_features`, with their targets and losses."""

    image_size: int = 224

    def __init__(self, content_layers: Optional[Sequence[int]] = None, style_layers: Optional[Sequence[int]] = None,
                 content_strength: float = 1.0, style_strength: float = 1.0):
        self.content_layers = list(content_layers or [])
        self.style_layers = list(style_layers or [])
        self.content_strength = content_strength
        self.style_strength = style_strength

    def get_features(self, img) -> List[torch.Tensor]:
        raise NotImplementedError

    def get_target_embeddings(self, img, content_weight: float = 1.0, style_weight: float = 1.0):
        feats = self.get_features(img)
        return [feats[i] for i in self.content_layers], [gram_matrix(feats[i]) for i in self.style_layers]

    def get_loss(self, img, targets) -> torch.Tensor:
        content_t, style_t = targets
        feats = self.get_features(img)
        loss = 0.0
        for i, t in zip(self.content_layers, content_t):
            loss = loss + self.content_strength * feature_loss(feats[i], t)
        for i, t in zip(self.style_layers, style_t):
            loss = loss + self.style_strength * scaled_mse_loss(gram_matrix(feats[i]), t)
        return loss


def load_perceptor(name: str):
    """The perceptor class (or partial) for a name, as maua_tpu resolves it."""
    name = name.lower()
    if name.startswith("clip"):
        from .clip import CLIPPerceptor

        return CLIPPerceptor
    if name.startswith("pgg") or name in ("nin", "sod", "fcn32s", "nyud", "prune", "pruned"):
        raise NotImplementedError("the caffe model-zoo perceptors are not ported yet (maua_tpu's perceptors/pgg.py)")
    if name.startswith("lpips"):
        from .lpips import LPIPSPerceptor

        return LPIPSPerceptor
    if "vgg" in name or name.split("-")[0] == "kbc":
        from .vgg import VGGPerceptor

        return partial(VGGPerceptor, arch="vgg16" if "16" in name else "vgg19")
    raise ValueError(f"unknown perceptor {name}")
