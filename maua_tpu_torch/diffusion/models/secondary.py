"""The secondary v-objective diffusion UNet (Crowson's SecondaryDiffusionImageNet2).

Port of `maua_tpu/diffusion/models/secondary.py` (t_to_alpha_sigma,
init_params, params_from_torch, forward): a 6-scale conv UNet with
skip concatenations, Fourier time features and v-prediction outputs (v,
pred, eps), the cheap x0 predictor of guided diffusion's "fast"
guidance. NCHW activations; parameters {"timestep_embed": (8, 1),
"convs": {torch module name: {"w": OIHW, "b"}}}, the names those of the
published state dict.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ...ops.warp import resize

CS = (64, 128, 128, 256, 256, 512)


def t_to_alpha_sigma(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.cos(t * math.pi / 2), torch.sin(t * math.pi / 2)


def _conv_names() -> List[Tuple[str, int, int]]:
    """(name, c_in, c_out) of every conv in forward order, as the published nested Sequentials name them."""
    names = [("net.0.0", 3 + 16, CS[0]), ("net.1.0", CS[0], CS[0])]
    prefix = "net.2"
    for lvl in range(1, 5):
        names.append((f"{prefix}.main.1.0", CS[lvl - 1], CS[lvl]))
        names.append((f"{prefix}.main.2.0", CS[lvl], CS[lvl]))
        prefix = f"{prefix}.main.3"
    names.append((f"{prefix}.main.1.0", CS[4], CS[5]))
    names.append((f"{prefix}.main.2.0", CS[5], CS[5]))
    names.append((f"{prefix}.main.3.0", CS[5], CS[5]))
    names.append((f"{prefix}.main.4.0", CS[5], CS[4]))
    for lvl in range(4, 0, -1):
        prefix = prefix.rsplit(".main.3", 1)[0]
        names.append((f"{prefix}.main.4.0", CS[lvl] * 2, CS[lvl]))
        names.append((f"{prefix}.main.5.0", CS[lvl], CS[lvl - 1]))
    names.append(("net.3.0", CS[0] * 2, CS[0]))
    names.append(("net.4", CS[0], 3))
    return names


def init_params(gen: torch.Generator) -> Dict:
    """Random parameters with maua_tpu's init distributions, drawn from `gen`."""
    dev = gen.device
    params = {"timestep_embed": torch.randn(8, 1, generator=gen, device=dev), "convs": {}}
    for name, ci, co in _conv_names():
        scale = 1.0 / math.sqrt(ci * 9)
        params["convs"][name] = {"w": (torch.rand(co, ci, 3, 3, generator=gen, device=dev) * 2 - 1) * scale,
                                 "b": torch.zeros(co, device=dev)}
    return params


def params_from_torch(sd: Dict) -> Dict:
    """The published state dict (OIHW) -> parameters."""
    return {"timestep_embed": torch.as_tensor(sd["timestep_embed.weight"]).float(),
            "convs": {name: {"w": torch.as_tensor(sd[f"{name}.weight"]).float(),
                             "b": torch.as_tensor(sd[f"{name}.bias"]).float()} for name, _, _ in _conv_names()}}


def _conv(p, x, relu=True):
    y = F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), padding=1)
    return F.relu(y) if relu else y


def _up(x):
    return resize(x, (x.shape[2] * 2, x.shape[3] * 2), "bilinear")


def forward(params: Dict, x: torch.Tensor, t: torch.Tensor) -> Dict[str, torch.Tensor]:
    """x (B, 3, H, W) in [-1, 1], t (B,) in [0, 1] -> {"v", "pred", "eps"}, each (B, 3, H, W)."""
    convs = params["convs"]
    f = 2 * math.pi * t[:, None] @ params["timestep_embed"].T  # (B, 8)
    te = torch.cat([torch.cos(f), torch.sin(f)], dim=-1)
    h = torch.cat([x, te[:, :, None, None].expand(-1, -1, x.shape[2], x.shape[3]).to(x.dtype)], dim=1)
    h = _conv(convs["net.0.0"], h)
    h = _conv(convs["net.1.0"], h)

    prefix = "net.2"
    skips = [h]
    for _ in range(1, 5):
        h = F.avg_pool2d(h, 2)
        h = _conv(convs[f"{prefix}.main.1.0"], h)
        h = _conv(convs[f"{prefix}.main.2.0"], h)
        skips.append(h)
        prefix = f"{prefix}.main.3"

    inner_skip = h
    h = F.avg_pool2d(h, 2)
    for i in range(1, 5):
        h = _conv(convs[f"{prefix}.main.{i}.0"], h)
    h = torch.cat([_up(h), inner_skip], dim=1)

    for lvl in range(4, 0, -1):
        prefix = prefix.rsplit(".main.3", 1)[0]
        h = _conv(convs[f"{prefix}.main.4.0"], h)
        h = _conv(convs[f"{prefix}.main.5.0"], h)
        h = torch.cat([_up(h), skips[lvl - 1]], dim=1)

    h = _conv(convs["net.3.0"], h)
    v = _conv(convs["net.4"], h, relu=False)
    alphas, sigmas = t_to_alpha_sigma(t)
    a, s = alphas[:, None, None, None], sigmas[:, None, None, None]
    return {"v": v, "pred": x * a - v * s, "eps": x * s + v * a}
