"""LPIPS perceptual distance with its learned linear calibration.

Port of `maua_tpu/perceptors/lpips.py` (init_params, params_from_torch,
lpips, LPIPSPerceptor): VGG16 features at relu1_2, 2_2, 3_3, 4_3 and
5_3 of lpips' scaling layer's input, unit-normalized over channels,
squared differences weighted by the non-negative "lin" weights, the
spatial mean, summed over the stages. Images are NHWC in [-1, 1].
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utility import resolve_device, to_device
from . import vgg as vgg_mod

# VGG16 relu indices of the five LPIPS stages (relu{1_2,2_2,3_3,4_3,5_3})
LPIPS_STAGES = (1, 3, 6, 9, 12)
STAGE_CHANNELS = (64, 128, 256, 512, 512)

# lpips' ScalingLayer: maps the [-1, 1] input to the net's domain
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def init_params(gen: torch.Generator, seed: int = 0) -> Dict:
    """Random VGG16 weights from `gen`; the lin weights |N(0, 1)| / C from numpy's default_rng(seed), as maua_tpu."""
    rng = np.random.default_rng(seed)
    return {"vgg": vgg_mod.init_params(gen, "vgg16"),
            "lins": [torch.from_numpy(np.abs(rng.standard_normal(c)).astype(np.float32) / c).to(gen.device)
                     for c in STAGE_CHANNELS]}


def params_from_torch(lin_sd: Dict, vgg_sd: Dict) -> Dict:
    """lpips' lin checkpoint (`lin{k}.model.1.weight`, (1, C, 1, 1)) and a torchvision vgg16 state dict -> params."""
    lins = []
    for k in range(5):
        for name in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
            if name in lin_sd:
                lins.append(torch.as_tensor(lin_sd[name]).float().reshape(-1))
                break
        else:
            raise KeyError(f"missing lin weights for stage {k}")
    return {"vgg": vgg_mod.params_from_torch(vgg_sd, "vgg16"), "lins": lins}


def _normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return feat / torch.sqrt(feat.square().sum(dim=1, keepdim=True) + eps)


def _stage_features(params: Dict, img: torch.Tensor) -> List[torch.Tensor]:
    """img (B, H, W, 3) in [-1, 1] -> the five stage maps, NCHW (lpips' scaling, not torchvision's mean and std)."""
    shift = torch.tensor(_SHIFT, dtype=img.dtype, device=img.device)
    scale = torch.tensor(_SCALE, dtype=img.dtype, device=img.device)
    x = ((img - shift) / scale).permute(0, 3, 1, 2)
    feats, i = [], 0
    for block, n_convs in enumerate(vgg_mod.VGG16_LAYOUT):
        for _ in range(n_convs):
            x = vgg_mod.conv_relu(params["vgg"][i], x)
            if i in LPIPS_STAGES:
                feats.append(x)
            i += 1
        if block < len(vgg_mod.VGG16_LAYOUT) - 1:
            x = F.max_pool2d(x, 2)
    return feats


def lpips(params: Dict, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """The perceptual distance of each pair, images (B, H, W, 3) in [-1, 1] -> (B,)."""
    total = 0.0
    for a, b, lin in zip(_stage_features(params, img0), _stage_features(params, img1), params["lins"]):
        d = (_normalize(a) - _normalize(b)).square()
        total = total + (d * F.relu(lin)[:, None, None]).sum(dim=1).mean(dim=(1, 2))
    return total


class LPIPSPerceptor:
    def __init__(self, params: Optional[Dict] = None, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.params = to_device(params, self.device) if params is not None \
            else init_params(torch.Generator(device=self.device).manual_seed(seed), seed)

    def __call__(self, img0, img1):
        return lpips(self.params, img0, img1)
