"""Metric feature extractors: FID Inception-v3 and SwAV ResNet-50, in PyTorch.

Port of `maua_tpu/gan/extractors.py`. Both nets are built from
torch-layout state dicts (pytorch-fid / torchvision Inception-v3; SwAV /
torchvision ResNet-50) with each eval-mode BatchNorm folded into the
conv before it, as maua_tpu folds it: w' = w g / sqrt(v + eps),
b' = beta - m g / sqrt(v + eps). The forward is conv + bias + relu,
NCHW, OIHW weights. Without a checkpoint `random_state_dict_*` builds a
state dict of the published shapes from a numpy seed (the same numbers
as maua_tpu's), so random-init runs share the conversion and forward of
a real checkpoint. Both emit 2048-d features for `gan/metrics.py`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utility import resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]


# --------------------------------------------------------------- helpers
def _fold_bn(w: np.ndarray, gamma, beta, mean, var, eps: float) -> Tuple[np.ndarray, np.ndarray]:
    """An eval-mode BatchNorm folded into the bias-free OIHW conv before it: (w', bias')."""
    scale = gamma / np.sqrt(var + eps)
    return (w * scale[:, None, None, None]).astype(np.float32), (beta - mean * scale).astype(np.float32)


def _conv_bn_from_sd(sd, conv_key: str, bn_key: str, eps: float, device) -> Dict[str, torch.Tensor]:
    w, b = _fold_bn(*(np.asarray(sd[k], np.float32) for k in (
        f"{conv_key}.weight", f"{bn_key}.weight", f"{bn_key}.bias", f"{bn_key}.running_mean",
        f"{bn_key}.running_var")), eps)
    return {"w": torch.from_numpy(np.array(w, order="C")).to(device), "b": torch.from_numpy(b).to(device)}


def _conv(p: Dict[str, torch.Tensor], x: torch.Tensor, stride: int = 1, padding=0) -> torch.Tensor:
    """Conv + bias; `padding` an int or (ph, pw)."""
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=padding)


def _crelu(p, x, stride=1, padding=0):
    return F.relu(_conv(p, x, stride, padding))


def _avg_pool_exclude_pad(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


# ------------------------------------------------- random torch state dicts
def _rand_sd_conv_bn(rng, sd, conv_key, bn_key, co, ci, kh, kw):
    # gamma < 1 keeps deep residual stacks at O(1) activations, like a trained checkpoint
    sd[f"{conv_key}.weight"] = (rng.standard_normal((co, ci, kh, kw)) * math.sqrt(2.0 / (ci * kh * kw))).astype(
        np.float32)
    sd[f"{bn_key}.weight"] = rng.uniform(0.2, 0.5, co).astype(np.float32)
    sd[f"{bn_key}.bias"] = (rng.standard_normal(co) * 0.05).astype(np.float32)
    sd[f"{bn_key}.running_mean"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
    sd[f"{bn_key}.running_var"] = rng.uniform(0.8, 1.2, co).astype(np.float32)


# ======================================================================
# FID Inception-v3 (pytorch-fid's: count_include_pad=False average pools,
# Mixed_7c's pool branch a max pool)
# ======================================================================
_BN_EPS_INCEPTION = 1e-3


def _inception_units() -> List[Tuple[str, int, int, Tuple[int, int]]]:
    """(name, out_ch, in_ch, (kh, kw)) of every conv + bn unit, in torch naming."""
    units: List[Tuple[str, int, int, Tuple[int, int]]] = [
        ("Conv2d_1a_3x3", 32, 3, (3, 3)),
        ("Conv2d_2a_3x3", 32, 32, (3, 3)),
        ("Conv2d_2b_3x3", 64, 32, (3, 3)),
        ("Conv2d_3b_1x1", 80, 64, (1, 1)),
        ("Conv2d_4a_3x3", 192, 80, (3, 3)),
    ]

    def a(block, ci, pool_features):
        units.extend([
            (f"{block}.branch1x1", 64, ci, (1, 1)),
            (f"{block}.branch5x5_1", 48, ci, (1, 1)),
            (f"{block}.branch5x5_2", 64, 48, (5, 5)),
            (f"{block}.branch3x3dbl_1", 64, ci, (1, 1)),
            (f"{block}.branch3x3dbl_2", 96, 64, (3, 3)),
            (f"{block}.branch3x3dbl_3", 96, 96, (3, 3)),
            (f"{block}.branch_pool", pool_features, ci, (1, 1)),
        ])

    a("Mixed_5b", 192, 32)
    a("Mixed_5c", 256, 64)
    a("Mixed_5d", 288, 64)
    units.extend([
        ("Mixed_6a.branch3x3", 384, 288, (3, 3)),
        ("Mixed_6a.branch3x3dbl_1", 64, 288, (1, 1)),
        ("Mixed_6a.branch3x3dbl_2", 96, 64, (3, 3)),
        ("Mixed_6a.branch3x3dbl_3", 96, 96, (3, 3)),
    ])

    def c(block, c7):
        units.extend([
            (f"{block}.branch1x1", 192, 768, (1, 1)),
            (f"{block}.branch7x7_1", c7, 768, (1, 1)),
            (f"{block}.branch7x7_2", c7, c7, (1, 7)),
            (f"{block}.branch7x7_3", 192, c7, (7, 1)),
            (f"{block}.branch7x7dbl_1", c7, 768, (1, 1)),
            (f"{block}.branch7x7dbl_2", c7, c7, (7, 1)),
            (f"{block}.branch7x7dbl_3", c7, c7, (1, 7)),
            (f"{block}.branch7x7dbl_4", c7, c7, (7, 1)),
            (f"{block}.branch7x7dbl_5", 192, c7, (1, 7)),
            (f"{block}.branch_pool", 192, 768, (1, 1)),
        ])

    c("Mixed_6b", 128)
    c("Mixed_6c", 160)
    c("Mixed_6d", 160)
    c("Mixed_6e", 192)
    units.extend([
        ("Mixed_7a.branch3x3_1", 192, 768, (1, 1)),
        ("Mixed_7a.branch3x3_2", 320, 192, (3, 3)),
        ("Mixed_7a.branch7x7x3_1", 192, 768, (1, 1)),
        ("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7)),
        ("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1)),
        ("Mixed_7a.branch7x7x3_4", 192, 192, (3, 3)),
    ])

    def e(block, ci):
        units.extend([
            (f"{block}.branch1x1", 320, ci, (1, 1)),
            (f"{block}.branch3x3_1", 384, ci, (1, 1)),
            (f"{block}.branch3x3_2a", 384, 384, (1, 3)),
            (f"{block}.branch3x3_2b", 384, 384, (3, 1)),
            (f"{block}.branch3x3dbl_1", 448, ci, (1, 1)),
            (f"{block}.branch3x3dbl_2", 384, 448, (3, 3)),
            (f"{block}.branch3x3dbl_3a", 384, 384, (1, 3)),
            (f"{block}.branch3x3dbl_3b", 384, 384, (3, 1)),
            (f"{block}.branch_pool", 192, ci, (1, 1)),
        ])

    e("Mixed_7b", 1280)
    e("Mixed_7c", 2048)
    return units


def inception_params_from_torch(sd, device=None) -> Params:
    """A pytorch-fid / torchvision `inception_v3` state dict (`<unit>.conv.weight`,
    `<unit>.bn.{weight,bias,running_*}`) -> folded params."""
    return {name: _conv_bn_from_sd(sd, f"{name}.conv", f"{name}.bn", _BN_EPS_INCEPTION, device)
            for name, _, _, _ in _inception_units()}


def random_state_dict_inception(seed: int = 0):
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for name, co, ci, (kh, kw) in _inception_units():
        _rand_sd_conv_bn(rng, sd, f"{name}.conv", f"{name}.bn", co, ci, kh, kw)
    return sd


def _inception_a(p: Params, b: str, x: torch.Tensor) -> torch.Tensor:
    b1 = _crelu(p[f"{b}.branch1x1"], x)
    b5 = _crelu(p[f"{b}.branch5x5_2"], _crelu(p[f"{b}.branch5x5_1"], x), padding=2)
    b3 = _crelu(p[f"{b}.branch3x3dbl_1"], x)
    b3 = _crelu(p[f"{b}.branch3x3dbl_2"], b3, padding=1)
    b3 = _crelu(p[f"{b}.branch3x3dbl_3"], b3, padding=1)
    bp = _crelu(p[f"{b}.branch_pool"], _avg_pool_exclude_pad(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(p: Params, b: str, x: torch.Tensor) -> torch.Tensor:
    b3 = _crelu(p[f"{b}.branch3x3"], x, stride=2)
    bd = _crelu(p[f"{b}.branch3x3dbl_1"], x)
    bd = _crelu(p[f"{b}.branch3x3dbl_2"], bd, padding=1)
    bd = _crelu(p[f"{b}.branch3x3dbl_3"], bd, stride=2)
    return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)


def _inception_c(p: Params, b: str, x: torch.Tensor) -> torch.Tensor:
    b1 = _crelu(p[f"{b}.branch1x1"], x)
    b7 = _crelu(p[f"{b}.branch7x7_1"], x)
    b7 = _crelu(p[f"{b}.branch7x7_2"], b7, padding=(0, 3))
    b7 = _crelu(p[f"{b}.branch7x7_3"], b7, padding=(3, 0))
    bd = _crelu(p[f"{b}.branch7x7dbl_1"], x)
    bd = _crelu(p[f"{b}.branch7x7dbl_2"], bd, padding=(3, 0))
    bd = _crelu(p[f"{b}.branch7x7dbl_3"], bd, padding=(0, 3))
    bd = _crelu(p[f"{b}.branch7x7dbl_4"], bd, padding=(3, 0))
    bd = _crelu(p[f"{b}.branch7x7dbl_5"], bd, padding=(0, 3))
    bp = _crelu(p[f"{b}.branch_pool"], _avg_pool_exclude_pad(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(p: Params, b: str, x: torch.Tensor) -> torch.Tensor:
    b3 = _crelu(p[f"{b}.branch3x3_2"], _crelu(p[f"{b}.branch3x3_1"], x), stride=2)
    b7 = _crelu(p[f"{b}.branch7x7x3_1"], x)
    b7 = _crelu(p[f"{b}.branch7x7x3_2"], b7, padding=(0, 3))
    b7 = _crelu(p[f"{b}.branch7x7x3_3"], b7, padding=(3, 0))
    b7 = _crelu(p[f"{b}.branch7x7x3_4"], b7, stride=2)
    return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


def _inception_e(p: Params, b: str, x: torch.Tensor, pool: str) -> torch.Tensor:
    b1 = _crelu(p[f"{b}.branch1x1"], x)
    b3 = _crelu(p[f"{b}.branch3x3_1"], x)
    b3 = torch.cat([_crelu(p[f"{b}.branch3x3_2a"], b3, padding=(0, 1)),
                    _crelu(p[f"{b}.branch3x3_2b"], b3, padding=(1, 0))], dim=1)
    bd = _crelu(p[f"{b}.branch3x3dbl_1"], x)
    bd = _crelu(p[f"{b}.branch3x3dbl_2"], bd, padding=1)
    bd = torch.cat([_crelu(p[f"{b}.branch3x3dbl_3a"], bd, padding=(0, 1)),
                    _crelu(p[f"{b}.branch3x3dbl_3b"], bd, padding=(1, 0))], dim=1)
    # FIDInceptionE_2 (Mixed_7c) max-pools its pool branch; FIDInceptionE_1 averages without the padding
    pooled = F.max_pool2d(x, 3, 1, 1) if pool == "max" else _avg_pool_exclude_pad(x)
    return torch.cat([b1, b3, bd, _crelu(p[f"{b}.branch_pool"], pooled)], dim=1)


def inception_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, 3, 299, 299) in [-1, 1] -> (B, 2048) pool3 features."""
    x = _crelu(params["Conv2d_1a_3x3"], x, stride=2)
    x = _crelu(params["Conv2d_2a_3x3"], x)
    x = _crelu(params["Conv2d_2b_3x3"], x, padding=1)
    x = F.max_pool2d(x, 3, 2)
    x = _crelu(params["Conv2d_3b_1x1"], x)
    x = _crelu(params["Conv2d_4a_3x3"], x)
    x = F.max_pool2d(x, 3, 2)
    for b in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _inception_a(params, b, x)
    x = _inception_b(params, "Mixed_6a", x)
    for b in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _inception_c(params, b, x)
    x = _inception_d(params, "Mixed_7a", x)
    x = _inception_e(params, "Mixed_7b", x, pool="avg")
    x = _inception_e(params, "Mixed_7c", x, pool="max")
    return x.mean(dim=(2, 3))


# ======================================================================
# SwAV ResNet-50 backbone (Bottleneck [3, 4, 6, 3])
# ======================================================================
_BN_EPS_RESNET = 1e-5
_R50_LAYERS = (3, 4, 6, 3)


def _resnet_units() -> List[Tuple[str, str, int, int, Tuple[int, int]]]:
    """(conv_key, bn_key, out_ch, in_ch, (kh, kw)) of ResNet-50."""
    units = [("conv1", "bn1", 64, 3, (7, 7))]
    ci = 64
    for stage, n_blocks in enumerate(_R50_LAYERS):
        planes = 64 * 2**stage
        for i in range(n_blocks):
            pre = f"layer{stage + 1}.{i}"
            units.append((f"{pre}.conv1", f"{pre}.bn1", planes, ci, (1, 1)))
            units.append((f"{pre}.conv2", f"{pre}.bn2", planes, planes, (3, 3)))
            units.append((f"{pre}.conv3", f"{pre}.bn3", planes * 4, planes, (1, 1)))
            if i == 0:
                units.append((f"{pre}.downsample.0", f"{pre}.downsample.1", planes * 4, ci, (1, 1)))
            ci = planes * 4
    return units


def swav_params_from_torch(sd, device=None) -> Params:
    """A SwAV / torchvision ResNet-50 state dict (a DDP `module.` prefix stripped) -> folded params;
    the projection head and prototypes are ignored (the metric features are the backbone's)."""
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    return {ck: _conv_bn_from_sd(sd, ck, bk, _BN_EPS_RESNET, device) for ck, bk, _, _, _ in _resnet_units()}


def random_state_dict_swav(seed: int = 0):
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for ck, bk, co, ci, (kh, kw) in _resnet_units():
        _rand_sd_conv_bn(rng, sd, ck, bk, co, ci, kh, kw)
    return sd


def swav_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, 3, 224, 224) -> (B, 2048) backbone avgpool features (SwAV's ConstantPad2d(1) + a 7x7/s2/p2
    conv: padding 3 in all)."""
    x = _crelu(params["conv1"], x, stride=2, padding=3)
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, n_blocks in enumerate(_R50_LAYERS):
        for i in range(n_blocks):
            pre = f"layer{stage + 1}.{i}"
            stride = 2 if (i == 0 and stage > 0) else 1
            y = _crelu(params[f"{pre}.conv1"], x)
            y = _crelu(params[f"{pre}.conv2"], y, stride=stride, padding=1)
            y = _conv(params[f"{pre}.conv3"], y)
            identity = _conv(params[f"{pre}.downsample.0"], x, stride=stride) if i == 0 else x
            x = F.relu(y + identity)
    return x.mean(dim=(2, 3))


# ======================================================================
# Extractor objects for gan/metrics.compute_metrics
# ======================================================================
class _Extractor:
    def __init__(self, params: Params, forward, size: int):
        self.params = params
        self.size = size
        self.feat_dim = 2048
        self._forward = forward

    @torch.no_grad()
    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, 3, H, W) in [-1, 1] -> (B, 2048)."""
        from .metrics import clean_resize

        return self._forward(self.params, clean_resize(img.float(), self.size))


def _checkpoint_state_dict(checkpoint: str):
    sd = torch.load(checkpoint, map_location="cpu", weights_only=False)
    sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
    return {k: np.asarray(v.float().numpy()) for k, v in sd.items() if hasattr(v, "numpy")}


def load_inception(checkpoint: Optional[str] = None, seed: int = 0, device=None) -> _Extractor:
    """FID Inception-v3 at 299 px on `device` (cuda unless told otherwise). Without a checkpoint the
    features are those of a random state dict (a warning says so): not comparable to published FIDs."""
    if checkpoint is not None:
        sd = _checkpoint_state_dict(checkpoint)
    else:
        print("warning: no Inception checkpoint — random-init features, FID/KID not comparable")
        sd = random_state_dict_inception(seed)
    return _Extractor(inception_params_from_torch(sd, resolve_device(device)), inception_forward, 299)


def load_swav(checkpoint: Optional[str] = None, seed: int = 0, device=None) -> _Extractor:
    """SwAV ResNet-50 at 224 px on `device` (cuda unless told otherwise)."""
    if checkpoint is not None:
        sd = _checkpoint_state_dict(checkpoint)
    else:
        print("warning: no SwAV checkpoint — random-init features, FID/KID not comparable")
        sd = random_state_dict_swav(seed)
    return _Extractor(swav_params_from_torch(sd, resolve_device(device)), swav_forward, 224)


def get_extractor(name: str, checkpoint: Optional[str] = None, device=None):
    name = name.lower()
    if name == "swav":
        return load_swav(checkpoint, device=device)
    if name == "inception":
        return load_inception(checkpoint, device=device)
    raise ValueError(f"Unknown extractor {name}")
