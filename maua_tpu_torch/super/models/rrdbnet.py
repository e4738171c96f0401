"""RRDBNet (the Real-ESRGAN generator) and the SRVGG compact net.

Port of `maua_tpu/super/models/rrdbnet.py`. Parameters are nested dicts
of tensors in the torch layout (conv weights OIHW), activations NCHW, and
the convolutions are `F.conv2d` (cuDNN on the card), as maua_tpu computes
them outside any Pallas kernel. The residual dense block runs in
maua_tpu's default, input-grouped form (`_rdb`): each new feature map is
convolved once with the weight slices of every later stage that reads
it, stacked along the output channels. `_rdb_concat`, the form that
convolves the growing concat, is the plain form the tests compare it
with; chip_smoke's `super` phase times both in turns, and on an H100 the
grouped form is the faster (PERF.md). `forward` runs on a tree from
`prepare`, which stacks the grouped weights once. The x4 upsampling is nearest x2 then a conv, twice.
`params_from_torch` reads basicsr / realesrgan state dicts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class RRDBConfig:
    num_in_ch: int = 3
    num_out_ch: int = 3
    num_feat: int = 64
    num_block: int = 23
    num_grow_ch: int = 32
    scale: int = 4
    dtype: str = "float32"


def as_f32(v) -> torch.Tensor:
    """A state-dict value (tensor or array) as an f32 tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().float()
    return torch.from_numpy(np.array(v, np.float32))


def _conv_init(gen: torch.Generator, ci: int, co: int, k: int = 3, scale: float = 1.0) -> Dict:
    s = scale / math.sqrt(ci * k * k)
    return {"w": torch.randn((co, ci, k, k), generator=gen, device=gen.device) * s,
            "b": torch.zeros((co,), device=gen.device)}


def conv(p, x: torch.Tensor, padding: int = 1) -> torch.Tensor:
    return F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), padding=padding)


def _lrelu(v):
    return F.leaky_relu(v, 0.2)


def _init_rdb(gen, nf, gc):
    return {f"conv{i + 1}": _conv_init(gen, nf + i * gc, gc if i < 4 else nf, scale=0.1) for i in range(5)}


def _rdb_concat(p, x):
    """Residual dense block as basicsr computes it: each stage convolves the
    materialised concat of the block input and every earlier stage."""
    feats = [x]
    for i in range(1, 6):
        acc = conv(p[f"conv{i}"], torch.cat(feats, dim=1) if len(feats) > 1 else feats[0])
        if i < 5:
            feats.append(_lrelu(acc))
    return acc * 0.2 + x


def group_rdb_weights(p) -> list:
    """The grouped form's five weights of one block: for input i (the block
    input, then each stage's output), the slices of conv{j+1} (j >= i) that
    read it, stacked along the output channels."""
    nf, gc = p["conv1"]["w"].shape[1], p["conv1"]["w"].shape[0]
    out = []
    for i in range(5):
        off, ci = (0, nf) if i == 0 else (nf + (i - 1) * gc, gc)
        out.append(torch.cat([p[f"conv{j + 1}"]["w"][:, off : off + ci] for j in range(i, 5)], dim=0))
    return out


def _rdb(p, x):
    """Residual dense block, input-grouped (maua_tpu's default form): the same
    linear map as `_rdb_concat`, regrouped by the tensor each partial conv
    reads; a stage's output is the sum of its slices plus its bias. Takes the
    stacked weights from p["grouped"] (see `prepare`)."""
    wcats = p["grouped"]
    widths = [p[f"conv{j}"]["w"].shape[0] for j in range(1, 6)]  # gc, gc, gc, gc, nf
    feats = [x]
    partial = [None] * 5
    for i in range(5):  # feats[i] has just become available
        y = F.conv2d(feats[i], wcats[i].to(x.dtype), padding=1)
        o = 0
        for j in range(i, 5):
            part = y[:, o : o + widths[j]]
            partial[j] = part if partial[j] is None else partial[j] + part
            o += widths[j]
        acc = partial[i] + p[f"conv{i + 1}"]["b"].to(y.dtype)[None, :, None, None]
        if i < 4:
            feats.append(_lrelu(acc))
    return acc * 0.2 + x


def _init_rrdb(gen, nf, gc):
    return {f"rdb{i + 1}": _init_rdb(gen, nf, gc) for i in range(3)}


def _rrdb(p, x):
    out = _rdb(p["rdb1"], x)
    out = _rdb(p["rdb2"], out)
    out = _rdb(p["rdb3"], out)
    return out * 0.2 + x


def init_params(gen: torch.Generator, cfg: RRDBConfig = RRDBConfig()) -> Dict:
    """Random parameters on gen's device (maua_tpu's scales: 1/sqrt(fan-in),
    0.1 of that inside the dense blocks, zero biases)."""
    nf, gc = cfg.num_feat, cfg.num_grow_ch
    return {
        "conv_first": _conv_init(gen, cfg.num_in_ch, nf),
        "body": [_init_rrdb(gen, nf, gc) for _ in range(cfg.num_block)],
        "conv_body": _conv_init(gen, nf, nf),
        "conv_up1": _conv_init(gen, nf, nf),
        "conv_up2": _conv_init(gen, nf, nf),
        "conv_hr": _conv_init(gen, nf, nf),
        "conv_last": _conv_init(gen, nf, cfg.num_out_ch),
    }


def prepare(params: Dict, cfg: RRDBConfig = RRDBConfig()) -> Dict:
    """The tree `forward` runs fastest from: every tensor in the compute dtype,
    and each dense block's grouped weights stacked once."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        return tree.to(dtype)

    out = cast(params)
    for blk in out["body"]:
        for rdb in blk.values():
            rdb["grouped"] = group_rdb_weights(rdb)
    return out


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def forward(params: Dict, img: torch.Tensor, cfg: RRDBConfig = RRDBConfig()) -> torch.Tensor:
    """img (B, C, H, W) in [0, 1] -> (B, C, scale*H, scale*W), f32. `params`
    is a tree from `prepare`."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    x = img.to(dtype)
    feat = conv(params["conv_first"], x)
    body = feat
    for blk in params["body"]:
        body = _rrdb(blk, body)
    feat = feat + conv(params["conv_body"], body)
    feat = _lrelu(conv(params["conv_up1"], _up2(feat)))
    if cfg.scale >= 4:
        feat = _lrelu(conv(params["conv_up2"], _up2(feat)))
    out = conv(params["conv_last"], _lrelu(conv(params["conv_hr"], feat)))
    return out.float()


def params_from_torch(sd: Dict, cfg: RRDBConfig = RRDBConfig()) -> Dict:
    """basicsr RRDBNet state dict (the params / params_ema container opened
    by the caller) -> the port's tree."""

    def cv(name):
        return {"w": as_f32(sd[f"{name}.weight"]), "b": as_f32(sd[f"{name}.bias"])}

    body = []
    for b in range(cfg.num_block):
        body.append({f"rdb{r}": {f"conv{c}": cv(f"body.{b}.rdb{r}.conv{c}") for c in range(1, 6)}
                     for r in range(1, 4)})
    return {
        "conv_first": cv("conv_first"),
        "body": body,
        "conv_body": cv("conv_body"),
        "conv_up1": cv("conv_up1"),
        "conv_up2": cv("conv_up2"),
        "conv_hr": cv("conv_hr"),
        "conv_last": cv("conv_last"),
    }


# --------------------------------------------------------- SRVGG compact
@dataclasses.dataclass(frozen=True)
class SRVGGConfig:
    num_in_ch: int = 3
    num_out_ch: int = 3
    num_feat: int = 64
    num_conv: int = 16
    upscale: int = 4


def init_srvgg_params(gen: torch.Generator, cfg: SRVGGConfig = SRVGGConfig()) -> Dict:
    p = {"convs": [_conv_init(gen, cfg.num_in_ch, cfg.num_feat)],
         "prelu": [torch.full((cfg.num_feat,), 0.25, device=gen.device)]}
    for _ in range(cfg.num_conv):
        p["convs"].append(_conv_init(gen, cfg.num_feat, cfg.num_feat))
        p["prelu"].append(torch.full((cfg.num_feat,), 0.25, device=gen.device))
    p["conv_last"] = _conv_init(gen, cfg.num_feat, cfg.num_out_ch * cfg.upscale**2)
    return p


def srvgg_forward(params: Dict, img: torch.Tensor, cfg: SRVGGConfig = SRVGGConfig()) -> torch.Tensor:
    """img (B, C, H, W) in [0, 1] -> (B, C, upscale*H, upscale*W): convs with
    per-channel PReLU, a pixel shuffle, plus the nearest upscale of the input."""
    x = img
    for p, a in zip(params["convs"], params["prelu"]):
        x = conv(p, x)
        x = torch.where(x >= 0, x, a.to(x.dtype)[None, :, None, None] * x)
    x = F.pixel_shuffle(conv(params["conv_last"], x), cfg.upscale)
    return x + F.interpolate(img, scale_factor=cfg.upscale, mode="nearest")


def srvgg_params_from_torch(sd: Dict, cfg: SRVGGConfig = SRVGGConfig()) -> Dict:
    """realesrgan SRVGGNetCompact state dict -> the port's tree. The torch body
    is a flat Sequential of alternating conv / prelu with a final conv (to
    out_ch * scale^2) before the parameter-free pixel shuffle."""
    idxs = sorted({int(k.split(".")[1]) for k in sd if k.startswith("body.")})
    convs, prelus = [], []
    for i in idxs:
        w = as_f32(sd[f"body.{i}.weight"])
        if w.ndim == 4:
            convs.append({"w": w, "b": as_f32(sd[f"body.{i}.bias"])})
        else:  # prelu slope
            prelus.append(w)
    last = convs.pop()  # the final conv is conv_last, not part of the pairs
    if len(convs) != len(prelus):
        raise ValueError(f"unexpected SRVGG body layout: {len(convs)} convs vs {len(prelus)} prelus")
    return {"convs": convs, "prelu": prelus, "conv_last": last}
