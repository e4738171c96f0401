"""SpyNet optical flow: a pyramid whose every level runs the same five 7x7
convs on [im1, warp(im2, flow), flow] and adds the predicted residual.

Port of `maua_tpu/flow/spynet.py`. NCHW, OIHW; the parameters are a list of
{"convs": [{"w", "b"} x 5]}, one per level, in the published checkpoint's
order: level 0 runs at the coarsest scale. `params_from_torch` reads the
sniklaus `pytorch-spynet` state dicts (`netBasic.{L}.netBasic.{2k}.*`, the
`basic_module.*` and `moduleBasic.*` variants, bare `{L}.{2k}.*`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.warp import resize
from ..utility import resolve_device
from .layers import conv, frame, randn_conv, scale_flow, tensor, warp

N_LEVELS = 6
# per-level unit: channels 8 -> 32 -> 64 -> 32 -> 16 -> 2, all 7x7
_CHANNELS = [8, 32, 64, 32, 16, 2]
# ImageNet normalization (sniklaus preprocessing)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def init_params(gen: torch.Generator, n_levels: int = N_LEVELS) -> List[Dict]:
    """Random parameters with maua_tpu's distributions, drawn from `gen`."""
    return [{"convs": [randn_conv(gen, 7, 7, ci, co) for ci, co in zip(_CHANNELS[:-1], _CHANNELS[1:])]}
            for _ in range(n_levels)]


def params_from_torch(sd: Dict, n_levels: int = N_LEVELS) -> List[Dict]:
    """A pytorch-spynet state dict (numpy arrays or tensors) -> the parameter list."""
    def find(level, idx, leaf):
        for fmt in (f"netBasic.{level}.netBasic.{idx}.{leaf}", f"basic_module.{level}.basic_module.{idx}.{leaf}",
                    f"moduleBasic.{level}.moduleBasic.{idx}.{leaf}", f"{level}.{idx}.{leaf}"):
            if fmt in sd:
                return tensor(sd[fmt])
        raise KeyError(f"spynet level {level} conv {idx} {leaf} not found")

    return [{"convs": [{"w": find(lvl, 2 * k, "weight"), "b": find(lvl, 2 * k, "bias")} for k in range(5)]}
            for lvl in range(n_levels)]


def _basic_unit(unit: Dict, x: torch.Tensor) -> torch.Tensor:
    for i, p in enumerate(unit["convs"]):
        x = conv(x, p)
        if i < len(unit["convs"]) - 1:
            x = F.relu(x)
    return x


def spynet_forward(params: List[Dict], im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) normalized image pairs (H, W multiples of 2^levels) -> (B, 2, H, W) pixel flow."""
    n = len(params)
    pyr1, pyr2 = [im1], [im2]
    for _ in range(n - 1):
        pyr1.append(F.avg_pool2d(pyr1[-1], 2))
        pyr2.append(F.avg_pool2d(pyr2[-1], 2))
    b = im1.shape[0]
    flow = torch.zeros((b, 2) + tuple(pyr1[-1].shape[-2:]), dtype=im1.dtype, device=im1.device)
    for lvl in range(n - 1, -1, -1):
        p1, p2 = pyr1[lvl], pyr2[lvl]
        if flow.shape[-2:] != p1.shape[-2:]:
            flow = resize(flow, tuple(p1.shape[-2:]), "bilinear") * 2.0
        inp = torch.cat([p1, warp(p2, flow, "border"), flow], dim=1)
        # the unit for pyramid level `lvl` (0 = finest) is params[n - 1 - lvl]: the checkpoint's
        # module 0 runs at the coarsest level
        flow = flow + _basic_unit(params[n - 1 - lvl], inp)
    return flow


def spynet_flow(frame1, frame2, params: Optional[List[Dict]] = None, device=None) -> np.ndarray:
    """(H, W, 3) [0, 1] frame pair -> (H, W, 2) numpy pixel flow, on `device` (cuda unless told
    otherwise; seed-0 random weights there when `params` is None). The frames are resized to the
    nearest multiple of 32 and the flow scaled back."""
    device = resolve_device(device)
    if params is None:
        params = init_params(torch.Generator(device=device).manual_seed(0))
    f1, f2 = frame(frame1, device), frame(frame2, device)
    h, w = f1.shape[-2:]
    mult = 2 ** (len(params) - 1)
    hp, wp = max(int(np.ceil(h / mult)) * mult, mult), max(int(np.ceil(w / mult)) * mult, mult)
    mean = torch.tensor(_MEAN, device=device)[:, None, None]
    std = torch.tensor(_STD, device=device)[:, None, None]
    with torch.no_grad():
        f1, f2 = (resize((f - mean) / std, (hp, wp), "bilinear") for f in (f1, f2))
        flow = spynet_forward(params, f1, f2)
        if (hp, wp) != (h, w):
            flow = scale_flow(resize(flow, (h, w), "bilinear"), w / wp, h / hp)
    return flow[0].permute(1, 2, 0).cpu().numpy()
