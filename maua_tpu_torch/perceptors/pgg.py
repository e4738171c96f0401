"""ProGamerGov's caffe perceptor zoo: caffe-VGG16/19, SOD, FCN32s, pruned
VGG16, NYUD and NIN.

Port of `maua_tpu/perceptors/pgg.py`. Caffe-trained nets take BGR input
scaled to [0, 255] with the caffe mean pixel subtracted; the pruned VGG16
has reduced channel counts; NIN is the 11x11 / 5x5 / 3x3 conv + 1x1 cccp
stack, its 3x3 stride-2 pools in ceil mode. Images are NHWC in [-1, 1]
and features NHWC (one per relu); the convs run NCHW. Parameters are a
list of {"w": OIHW, "b"} in conv order; `params_from_torch` reads
neural-style-pt's `features.N.{weight,bias}` state dicts.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utility import resolve_device, to_device
from . import Perceptor

# caffe mean pixel (BGR), /255 domain
_CAFFE_MEAN_BGR = tuple(np.array([103.939, 116.779, 123.68], np.float32) / np.float32(255.0))

# channel layouts; "P" = pool
VGG16_CHANNELS = (64, 64, "P", 128, 128, "P", 256, 256, 256, "P", 512, 512, 512, "P", 512, 512, 512)
VGG16P_CHANNELS = (24, 22, "P", 41, 51, "P", 108, 89, 111, "P", 184, 276, 228, "P", 512, 512, 512)
VGG19_CHANNELS = (
    64, 64, "P", 128, 128, "P", 256, 256, 256, 256, "P", 512, 512, 512, 512, "P", 512, 512, 512, 512,
)

# the zoo's default layers as relu indices
DEFAULT_LAYERS = {
    "vgg16": {"content": (9,), "style": (1, 3, 6, 9, 12)},
    "vgg19": {"content": (11,), "style": (1, 3, 7, 11, 15)},
    "sod": {"content": (9,), "style": (1, 3, 6, 9, 12)},
    "fcn32s": {"content": (9,), "style": (1, 3, 6, 9, 12)},
    "nyud": {"content": (9,), "style": (1, 3, 6, 9, 12)},
    "prune": {"content": (9,), "style": (1, 3, 6, 9, 12)},
    "nin": {"content": (8,), "style": (2, 5, 8, 11)},
}

# NIN convs: (out_ch, kernel, stride, pad, pool_after)
NIN_SPEC: Tuple[Tuple[int, int, int, int, bool], ...] = (
    (96, 11, 4, 0, False), (96, 1, 1, 0, False), (96, 1, 1, 0, True),
    (256, 5, 1, 2, False), (256, 1, 1, 0, False), (256, 1, 1, 0, True),
    (384, 3, 1, 1, False), (384, 1, 1, 0, False), (384, 1, 1, 0, True),
    (1024, 3, 1, 1, False), (1024, 1, 1, 0, False), (1000, 1, 1, 0, False),
)


def _channels(arch: str):
    if "19" in arch:
        return VGG19_CHANNELS
    if "prun" in arch:
        return VGG16P_CHANNELS
    return VGG16_CHANNELS


def caffe_preprocess(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] RGB NHWC -> the caffe domain: [0, 1], BGR, mean-subtracted, x255."""
    x = ((img + 1.0) / 2.0).flip(-1)
    return 255.0 * (x - torch.tensor(_CAFFE_MEAN_BGR, dtype=x.dtype, device=x.device))


def _he(gen, co, ci, k):
    scale = math.sqrt(2.0 / (ci * k * k)) / 255.0  # tame the x255 input domain
    return {"w": torch.randn(co, ci, k, k, generator=gen, device=gen.device) * scale,
            "b": torch.zeros(co, device=gen.device)}


def init_vgg_params(gen: torch.Generator, arch: str) -> List[Dict]:
    """He-normal convs (over 255) and zero biases, drawn from `gen`."""
    params, ci = [], 3
    for c in _channels(arch):
        if c != "P":
            params.append(_he(gen, c, ci, 3))
            ci = c
    return params


def init_nin_params(gen: torch.Generator) -> List[Dict]:
    params, ci = [], 3
    for co, ks, _, _, _ in NIN_SPEC:
        params.append(_he(gen, co, ci, ks))
        ci = co
    return params


def params_from_torch(sd: Dict) -> List[Dict]:
    """neural-style-pt `features.N.{weight,bias}` (OIHW) -> the parameter list (every zoo entry,
    NIN included)."""
    idxs = sorted(int(k.split(".")[1]) for k in sd if k.startswith("features.") and k.endswith(".weight"))
    return [{"w": torch.as_tensor(np.asarray(sd[f"features.{i}.weight"], np.float32)),
             "b": torch.as_tensor(np.asarray(sd[f"features.{i}.bias"], np.float32))} for i in idxs]


def _pool(x: torch.Tensor, pool: str, k: int, stride: int, ceil: bool) -> torch.Tensor:
    """k x k pooling of NCHW maps. In ceil mode the high side is padded so the last partial
    window counts, with zeros for avg (which then divides by k^2, as maua_tpu's reduce_window
    sum does; F.avg_pool2d(ceil_mode=True) would divide a clipped window by its clipped size)
    and -inf for max."""
    if ceil:
        ph, pw = (-(x.shape[2] - k)) % stride, (-(x.shape[3] - k)) % stride
        x = F.pad(x, (0, pw, 0, ph), value=0.0 if pool == "avg" else -math.inf)
    if pool == "avg":
        return F.avg_pool2d(x, k, stride)
    return F.max_pool2d(x, k, stride)


def _conv_relu(p, x, stride=1, pad=1):
    return F.relu(F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride=stride, padding=pad))


def vgg_features(params: List[Dict], img: torch.Tensor, arch: str, pool: str = "max") -> List[torch.Tensor]:
    """Caffe-domain VGG features, one per relu, NHWC."""
    x = caffe_preprocess(img).permute(0, 3, 1, 2)
    feats, i = [], 0
    for c in _channels(arch):
        if c == "P":
            x = _pool(x, pool, 2, 2, ceil=False)
            continue
        x = _conv_relu(params[i], x)
        feats.append(x.permute(0, 2, 3, 1))
        i += 1
    return feats


def nin_features(params: List[Dict], img: torch.Tensor, pool: str = "max") -> List[torch.Tensor]:
    x = caffe_preprocess(img).permute(0, 3, 1, 2)
    feats = []
    for p, (_, _, stride, pad, pool_after) in zip(params, NIN_SPEC):
        x = _conv_relu(p, x, stride, pad)
        feats.append(x.permute(0, 2, 3, 1))
        if pool_after:
            x = _pool(x, pool, 3, 2, ceil=True)
    return feats


class PGGPerceptor(Perceptor):
    """model_name in {vgg16, vgg19, sod, fcn32s, nyud, prune, nin}. Weights: `params` (already
    converted), a neural-style-pt `.pth` at `checkpoint`, or seed-`seed` draws on `device`
    (cuda unless told otherwise)."""

    def __init__(self, model_name: str = "vgg19", params: Optional[List[Dict]] = None,
                 checkpoint: Optional[str] = None, content_layers: Optional[Sequence[int]] = None,
                 style_layers: Optional[Sequence[int]] = None, pooling: str = "max", content_strength: float = 1.0,
                 style_strength: float = 1.0, device=None, seed: int = 0):
        name = model_name.lower()
        base = "nin" if "nin" in name else ("prune" if "prun" in name else name)
        defaults = DEFAULT_LAYERS.get(base, DEFAULT_LAYERS["vgg16"])
        super().__init__(content_layers or defaults["content"], style_layers or defaults["style"], content_strength,
                         style_strength)
        self.model_name = base
        self.pooling = pooling
        self.device = resolve_device(device)
        if params is None and checkpoint is not None:
            sd = torch.load(checkpoint, map_location="cpu", weights_only=False)
            params = params_from_torch({k: v.numpy() for k, v in sd.items()})
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_nin_params(gen) if base == "nin" else init_vgg_params(gen, base)
        self.params = to_device(params, self.device)

    def get_features(self, img):
        if self.model_name == "nin":
            return nin_features(self.params, img, self.pooling)
        return vgg_features(self.params, img, self.model_name, self.pooling)
