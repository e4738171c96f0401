"""waifu2x's UpConv_7 and CARN, the 2x anime / photo upscalers.

Port of `maua_tpu/super/models/waifu.py`. UpConv_7: six valid 3x3 convs
with lrelu 0.1 over a 7px edge-padded input, then a 4x4 stride-2
transposed conv to RGB, exactly 2H x 2W. maua_tpu computes that transposed
conv as a convolution of the lhs-dilated input with the flipped kernel;
here it is `F.conv_transpose2d(stride=2, padding=3)` on the torch layout
(in, out, kh, kw), which flips the kernel itself, so no parameter is
flipped. CARN: three cascading groups of three residual-E blocks with
squeeze-excitation, lrelu 0.1, and a pixel-shuffle x2 tail. Parameters
convert from the waifu2x JSON checkpoint or a torch-port state dict.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .rrdbnet import _conv_init, as_f32, conv

UPCONV7_CHANNELS = (3, 16, 32, 64, 128, 128, 256)


@dataclasses.dataclass(frozen=True)
class UpConv7Config:
    scale: int = 2
    offset: int = 7  # edge pre-pad consumed by the valid convs


def init_upconv7_params(gen: torch.Generator) -> Dict:
    p = {f"conv{i}": _conv_init(gen, UPCONV7_CHANNELS[i], UPCONV7_CHANNELS[i + 1]) for i in range(6)}
    # transposed conv 256 -> 3, kernel 4, stride 2, padding 3; weight (in, out, kh, kw)
    p["deconv"] = {"w": torch.randn((256, 3, 4, 4), generator=gen, device=gen.device) * 0.01,
                   "b": torch.zeros((3,), device=gen.device)}
    return p


def upconv7_forward(params: Dict, img: torch.Tensor, cfg: UpConv7Config = UpConv7Config()) -> torch.Tensor:
    """img (B, 3, H, W) in [0, 1] -> (B, 3, 2H, 2W)."""
    x = F.pad(img.float(), (cfg.offset,) * 4, mode="replicate")
    for i in range(6):
        x = F.leaky_relu(conv(params[f"conv{i}"], x, padding=0), 0.1)
    d = params["deconv"]
    return F.conv_transpose2d(x, d["w"].to(x.dtype), d["b"].to(x.dtype), stride=2, padding=3)


def upconv7_params_from_json(obj) -> Dict:
    """waifu2x JSON checkpoint (a list of layers, each with a nested-list
    'weight' and a 'bias'; convs (out, in, kh, kw), the last layer's
    transposed conv (in, out, kh, kw)) -> the port's tree."""
    if isinstance(obj, str):
        with open(obj) as f:
            obj = json.load(f)
    params = {f"conv{i}": {"w": as_f32(np.asarray(layer["weight"], np.float32)),
                           "b": as_f32(np.asarray(layer["bias"], np.float32))} for i, layer in enumerate(obj[:6])}
    d = obj[6]
    params["deconv"] = {"w": as_f32(np.asarray(d["weight"], np.float32)),
                        "b": as_f32(np.asarray(d["bias"], np.float32))}
    return params


def upconv7_params_from_torch(sd: Dict) -> Dict:
    """Torch-port state dict (Sequential conv indices) -> the port's tree."""
    convs = [k[: -len(".weight")] for k in sd if k.endswith(".weight")]
    convs.sort(key=lambda n: [int(t) if t.isdigit() else t for t in n.split(".")])
    params = {f"conv{i}": {"w": as_f32(sd[f"{name}.weight"]), "b": as_f32(sd[f"{name}.bias"])}
              for i, name in enumerate(convs[:6])}
    params["deconv"] = {"w": as_f32(sd[f"{convs[6]}.weight"]), "b": as_f32(sd[f"{convs[6]}.bias"])}
    return params


# ------------------------------------------------------------- CARN
@dataclasses.dataclass(frozen=True)
class CARNConfig:
    mid: int = 64
    n_groups: int = 3
    n_blocks: int = 3
    scale: int = 2
    se_reduction: int = 16


def _se_init(gen, c, r):
    return {"fc1": _conv_init(gen, c, max(c // r, 4), k=1), "fc2": _conv_init(gen, max(c // r, 4), c, k=1)}


def _se(p, x):
    s = x.mean(dim=(2, 3), keepdim=True)
    s = F.relu(conv(p["fc1"], s, padding=0))
    return x * torch.sigmoid(conv(p["fc2"], s, padding=0))


def init_carn_params(gen: torch.Generator, cfg: CARNConfig = CARNConfig()) -> Dict:
    m = cfg.mid
    groups = []
    for _ in range(cfg.n_groups):
        blocks = [{"conv1": _conv_init(gen, m, m), "conv2": _conv_init(gen, m, m),
                   "se": _se_init(gen, m, cfg.se_reduction)} for _ in range(cfg.n_blocks)]
        cascades = [_conv_init(gen, m * (i + 2), m, k=1) for i in range(cfg.n_blocks)]
        groups.append({"blocks": blocks, "cascades": cascades})
    return {
        "entry": _conv_init(gen, 3, m),
        "groups": groups,
        "net_cascades": [_conv_init(gen, m * (i + 2), m, k=1) for i in range(cfg.n_groups)],
        "up": _conv_init(gen, m, m * cfg.scale**2),
        "exit": _conv_init(gen, m, 3),
    }


def carn_forward(params: Dict, img: torch.Tensor, cfg: CARNConfig = CARNConfig()) -> torch.Tensor:
    """img (B, 3, H, W) in [0, 1] -> (B, 3, scale*H, scale*W)."""
    lrelu = lambda v: F.leaky_relu(v, 0.1)  # noqa: E731
    x = lrelu(conv(params["entry"], img.float()))
    feats = [x]
    for g in params["groups"]:
        y = x
        g_feats = [y]
        for blk, cas in zip(g["blocks"], g["cascades"]):
            r = _se(blk["se"], lrelu(conv(blk["conv2"], lrelu(conv(blk["conv1"], y)))))
            y = lrelu(r + y)
            g_feats.append(y)
            y = lrelu(conv(cas, torch.cat(g_feats, dim=1), padding=0))
        x = y
        feats.append(x)
        x = lrelu(conv(params["net_cascades"][len(feats) - 2], torch.cat(feats, dim=1), padding=0))
    x = F.pixel_shuffle(lrelu(conv(params["up"], x)), cfg.scale)
    return conv(params["exit"], x)
