"""RAFT optical flow (Teed & Deng 2020) and GMA (Jiang et al. 2021).

Port of `maua_tpu/flow/raft.py`: feature and context encoders to 1/8
resolution, the all-pairs correlation divided by sqrt(D) and average-pooled
into a pyramid, a lookup of (2r+1)^2 bilinear samples a level around the
current coordinates (align_corners=False), the motion encoder and the
separable ConvGRU iterated `iters` times, and convex x8 upsampling (a
softmax over the 9 neighbours, sub-pixels in (8, 8) row order). GMA adds an
attention over the context features, computed once, through which each
iteration aggregates the motion features. NCHW, OIHW; norms are {"g", "b"}
(instance norm), or folded frozen batch norms marked "frozen". The
converters read torchvision's `raft_large` and zacjiang's GMA checkpoints.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.warp import grid_sample
from ..utility import resolve_device
from .layers import conv, frame, tensor


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    feat_dims: Tuple[int, int, int] = (64, 96, 128)
    feat_out: int = 256
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 12
    dtype: str = "float32"


# ------------------------------------------------------------- params
def _conv_init(gen, ci, co, k, kw=None, scale=None):
    kw = k if kw is None else kw
    s = 1.0 / math.sqrt(ci * k * kw) if scale is None else scale
    return {"w": torch.randn(co, ci, k, kw, generator=gen, device=gen.device) * s,
            "b": torch.zeros(co, device=gen.device)}


def _norm_init(c, device):
    return {"g": torch.ones(c, device=device), "b": torch.zeros(c, device=device)}


def _init_resblock(gen, ci, co, stride):
    p = {"conv1": _conv_init(gen, ci, co, 3), "norm1": _norm_init(co, gen.device),
         "conv2": _conv_init(gen, co, co, 3), "norm2": _norm_init(co, gen.device)}
    if stride != 1 or ci != co:
        p["down"] = _conv_init(gen, ci, co, 1)
        p["dnorm"] = _norm_init(co, gen.device)
    return p


def _init_encoder(gen, cfg: RAFTConfig, out_dim: int):
    d1, d2, d3 = cfg.feat_dims
    return {"conv1": _conv_init(gen, 3, d1, 7), "norm1": _norm_init(d1, gen.device),
            "layer1": [_init_resblock(gen, d1, d1, 1), _init_resblock(gen, d1, d1, 1)],
            "layer2": [_init_resblock(gen, d1, d2, 2), _init_resblock(gen, d2, d2, 1)],
            "layer3": [_init_resblock(gen, d2, d3, 2), _init_resblock(gen, d3, d3, 1)],
            "conv2": _conv_init(gen, d3, out_dim, 1)}


def init_params(gen: torch.Generator, cfg: RAFTConfig = RAFTConfig(), gma: bool = False) -> Dict:
    """Random parameters with maua_tpu's distributions and tree, drawn from `gen`."""
    ncorr = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
    hd, cd = cfg.hidden_dim, cfg.context_dim
    gin = hd + 128 + cd + (128 if gma else 0)  # hidden, motion, context (and aggregated motion for GMA)
    gru = {}
    for g in ("z", "r", "q"):  # horizontal (1x5) then vertical (5x1) passes
        gru[f"{g}1"] = _conv_init(gen, gin, hd, 1, 5, scale=0.01)
        gru[f"{g}2"] = _conv_init(gen, gin, hd, 5, 1, scale=0.01)
    params = {
        "fnet": _init_encoder(gen, cfg, cfg.feat_out),
        "cnet": _init_encoder(gen, cfg, hd + cd),
        "motion": {"convc1": _conv_init(gen, ncorr, 256, 1), "convc2": _conv_init(gen, 256, 192, 3),
                   "convf1": _conv_init(gen, 2, 128, 7), "convf2": _conv_init(gen, 128, 64, 3),
                   "conv": _conv_init(gen, 192 + 64, 128 - 2, 3)},
        "gru": gru,
        "flow_head": {"conv1": _conv_init(gen, hd, 256, 3), "conv2": _conv_init(gen, 256, 2, 3)},
        "mask": {"conv1": _conv_init(gen, hd, 256, 3), "conv2": _conv_init(gen, 256, 64 * 9, 1)},
    }
    if gma:
        params["gma"] = {"to_qk": _conv_init(gen, cd, 2 * 128, 1), "to_v": _conv_init(gen, 128, 128, 1),
                         "gamma": torch.zeros((), device=gen.device)}
    return params


# ------------------------------------------------------------- layers
def _instance_norm(p: Dict, x: torch.Tensor) -> torch.Tensor:
    g, b = p["g"][:, None, None], p["b"][:, None, None]
    if "frozen" in p:  # a folded frozen BatchNorm: a pure affine
        return x * g + b
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + 1e-5) * g + b


def _resblock(p, x, stride):
    y = F.relu(_instance_norm(p["norm1"], conv(x, p["conv1"], stride)))
    y = F.relu(_instance_norm(p["norm2"], conv(y, p["conv2"])))
    if "down" in p:
        x = _instance_norm(p["dnorm"], conv(x, p["down"], stride))
    return F.relu(x + y)


def _encoder(p, x):
    y = F.relu(_instance_norm(p["norm1"], conv(x, p["conv1"], 2)))
    for blk, stride in ((p["layer1"][0], 1), (p["layer1"][1], 1), (p["layer2"][0], 2), (p["layer2"][1], 1),
                        (p["layer3"][0], 2), (p["layer3"][1], 1)):
        y = _resblock(blk, y, stride)
    return conv(y, p["conv2"])


def _corr_pyramid(f1: torch.Tensor, f2: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """All-pairs correlation of (B, D, H8, W8) features -> [(B*H8*W8, 1, h_l, w_l)] a level."""
    b, d, h, w = f1.shape
    corr = torch.einsum("bdn,bdm->bnm", f1.reshape(b, d, h * w), f2.reshape(b, d, h * w))
    corr = (corr / math.sqrt(d)).reshape(b * h * w, 1, h, w)
    pyr = [corr]
    for _ in range(levels - 1):
        pyr.append(F.avg_pool2d(pyr[-1], 2))
    return pyr


def _lookup(pyr: List[torch.Tensor], coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Sample the pyramid around coords (B, H8, W8, 2), pixels (x, y) at 1/8 resolution ->
    (B, levels*(2r+1)^2, H8, W8): per level, dy outer and dx inner."""
    b, h, w, _ = coords.shape
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    dgrid = torch.stack([dx, dy], dim=-1)  # (2r+1, 2r+1, 2): x varies along the last axis
    outs = []
    for lvl, corr in enumerate(pyr):
        hl, wl = corr.shape[-2:]
        c = coords.reshape(b * h * w, 1, 1, 2) / (2.0 ** lvl) + dgrid[None]
        cn = torch.stack([(c[..., 0] + 0.5) * (2.0 / wl) - 1.0, (c[..., 1] + 0.5) * (2.0 / hl) - 1.0], dim=-1)
        sampled = grid_sample(corr, cn, padding_mode="zeros")  # (BHW, 1, 2r+1, 2r+1)
        outs.append(sampled.reshape(b, h, w, -1))
    return torch.cat(outs, dim=-1).permute(0, 3, 1, 2)


def _motion_encoder(p, flow, corr):
    c = F.relu(conv(corr, p["convc1"]))
    c = F.relu(conv(c, p["convc2"]))
    f = F.relu(conv(flow, p["convf1"]))
    f = F.relu(conv(f, p["convf2"]))
    return torch.cat([F.relu(conv(torch.cat([c, f], dim=1), p["conv"])), flow], dim=1)  # 128


def _sep_gru(p, h, x):
    for ax in ("1", "2"):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(conv(hx, p[f"z{ax}"]))
        r = torch.sigmoid(conv(hx, p[f"r{ax}"]))
        q = torch.tanh(conv(torch.cat([r * h, x], dim=1), p[f"q{ax}"]))
        h = (1 - z) * h + z * q
    return h


def _upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex x8 upsampling: flow (B, 2, H, W), mask (B, 576, H, W) -> (B, 2, 8H, 8W)."""
    b, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(b, 9, 64, h, w), dim=1)
    fp = F.pad(flow * 8.0, (1, 1, 1, 1))
    neigh = torch.stack([fp[:, :, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], dim=1)  # (B,9,2,H,W)
    up = torch.einsum("bnuhw,bnchw->bcuhw", m, neigh)  # (B, 2, 64, H, W)
    return up.reshape(b, 2, 8, 8, h, w).permute(0, 1, 4, 2, 5, 3).reshape(b, 2, 8 * h, 8 * w)


def forward(params: Dict, image1: torch.Tensor, image2: torch.Tensor, cfg: RAFTConfig = RAFTConfig(),
            iters: Optional[int] = None) -> torch.Tensor:
    """images (B, 3, H, W) in [0, 1], H and W multiples of 8 -> flow (B, 2, H, W) in pixels."""
    iters = iters if iters is not None else cfg.iters
    x1, x2 = image1 * 2.0 - 1.0, image2 * 2.0 - 1.0
    f1, f2 = _encoder(params["fnet"], x1), _encoder(params["fnet"], x2)
    pyr = _corr_pyramid(f1, f2, cfg.corr_levels)
    cnet = _encoder(params["cnet"], x1)
    hidden = torch.tanh(cnet[:, :cfg.hidden_dim])
    context = F.relu(cnet[:, cfg.hidden_dim:])

    b, _, h8, w8 = f1.shape
    gy, gx = torch.meshgrid(torch.arange(h8, dtype=torch.float32, device=f1.device),
                            torch.arange(w8, dtype=torch.float32, device=f1.device), indexing="ij")
    coords0 = torch.stack([gx, gy], dim=-1)[None].expand(b, h8, w8, 2)

    # GMA: attention over the context features, computed once; each iteration aggregates the
    # motion features globally through it
    attn = None
    gma = params.get("gma")
    if gma is not None:
        qk = conv(context, gma["to_qk"]).flatten(2).transpose(1, 2)  # (B, HW, 256)
        attn = torch.softmax(torch.einsum("bnd,bmd->bnm", qk[..., :128], qk[..., 128:]) * (128 ** -0.5), dim=-1)

    flow = torch.zeros((b, 2, h8, w8), dtype=x1.dtype, device=x1.device)
    for _ in range(iters):
        corr = _lookup(pyr, coords0 + flow.permute(0, 2, 3, 1), cfg.corr_radius)
        motion = _motion_encoder(params["motion"], flow, corr)
        # the GRU input's channel order is that of the converted checkpoints: torchvision cats
        # [context, motion], GMA [context, motion, aggregated motion]
        if attn is not None:
            v = conv(motion, gma["to_v"]).flatten(2).transpose(1, 2)
            agg = torch.einsum("bnm,bmd->bnd", attn, v).transpose(1, 2).reshape(b, 128, h8, w8)
            inp = torch.cat([context, motion, motion + gma["gamma"] * agg], dim=1)
        else:
            inp = torch.cat([context, motion], dim=1)
        hidden = _sep_gru(params["gru"], hidden, inp)
        flow = flow + conv(F.relu(conv(hidden, params["flow_head"]["conv1"])), params["flow_head"]["conv2"])

    mask = conv(F.relu(conv(hidden, params["mask"]["conv1"])), params["mask"]["conv2"]) * 0.25
    return _upsample_flow(flow, mask)


# ------------------------------------------------------------- converters
def _converters(sd: Dict):
    def cv(name):
        w = tensor(sd[f"{name}.weight"])
        return {"w": w, "b": tensor(sd[f"{name}.bias"]) if f"{name}.bias" in sd else torch.zeros(w.shape[0])}

    def nrm(name, c):
        if f"{name}.running_mean" in sd:  # frozen BatchNorm2d: fold the running stats into an affine (numpy f32)
            w, b, mean, var = (tensor(sd[f"{name}.{k}"]).numpy() for k in ("weight", "bias", "running_mean",
                                                                        "running_var"))
            g = w / np.sqrt(var + np.float32(1e-5))
            return {"g": torch.from_numpy(g), "b": torch.from_numpy(b - mean * g), "frozen": torch.ones(())}
        if f"{name}.weight" in sd:
            return {"g": tensor(sd[f"{name}.weight"]), "b": tensor(sd[f"{name}.bias"])}
        return {"g": torch.ones(c), "b": torch.zeros(c)}

    return cv, nrm


def _encoder_from(sd, cv, nrm, base, cfg, names):
    d1, d2, d3 = cfg.feat_dims
    conv1, norm1, conv2, bconv1, bnorm1, bconv2, bnorm2 = names
    p = {"conv1": cv(f"{base}.{conv1}"), "norm1": nrm(f"{base}.{norm1}", d1), "conv2": cv(f"{base}.{conv2}")}
    for co, layer in ((d1, "layer1"), (d2, "layer2"), (d3, "layer3")):
        p[layer] = []
        for bi in range(2):
            bb = f"{base}.{layer}.{bi}"
            blk = {"conv1": cv(f"{bb}.{bconv1}"), "norm1": nrm(f"{bb}.{bnorm1}", co),
                   "conv2": cv(f"{bb}.{bconv2}"), "norm2": nrm(f"{bb}.{bnorm2}", co)}
            if f"{bb}.downsample.0.weight" in sd:
                blk["down"], blk["dnorm"] = cv(f"{bb}.downsample.0"), nrm(f"{bb}.downsample.1", co)
            p[layer].append(blk)
    return p


def params_from_torch(sd: Dict, cfg: RAFTConfig = RAFTConfig()) -> Dict:
    """A torchvision `raft_large` state dict (numpy arrays or tensors) -> the parameter tree."""
    cv, nrm = _converters(sd)
    names = ("convnormrelu.0", "convnormrelu.1", "conv", "convnormrelu1.0", "convnormrelu1.1", "convnormrelu2.0",
             "convnormrelu2.1")
    mb, gb, fb = "update_block.motion_encoder", "update_block.recurrent_block", "update_block.flow_head"
    gru = {}
    for g, tv in (("z", "convz"), ("r", "convr"), ("q", "convq")):
        gru[f"{g}1"], gru[f"{g}2"] = cv(f"{gb}.convgru1.{tv}"), cv(f"{gb}.convgru2.{tv}")
    return {
        "fnet": _encoder_from(sd, cv, nrm, "feature_encoder", cfg, names),
        "cnet": _encoder_from(sd, cv, nrm, "context_encoder", cfg, names),
        "motion": {"convc1": cv(f"{mb}.convcorr1.0"), "convc2": cv(f"{mb}.convcorr2.0"),
                   "convf1": cv(f"{mb}.convflow1.0"), "convf2": cv(f"{mb}.convflow2.0"), "conv": cv(f"{mb}.conv.0")},
        "gru": gru,
        "flow_head": {"conv1": cv(f"{fb}.conv1"), "conv2": cv(f"{fb}.conv2")},
        "mask": {"conv1": cv("mask_predictor.convrelu.0"), "conv2": cv("mask_predictor.conv")},
    }


def params_from_torch_gma(sd: Dict, cfg: RAFTConfig = RAFTConfig()) -> Dict:
    """A published GMA checkpoint (zacjiang/GMA, princeton-RAFT naming, an optional `module.` prefix)
    -> the parameter tree with the GMA attention block."""
    sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
    cv, nrm = _converters(sd)
    names = ("conv1", "norm1", "conv2", "conv1", "norm1", "conv2", "norm2")
    ub = "update_block"
    gru = {}
    for g in ("z", "r", "q"):
        gru[f"{g}1"], gru[f"{g}2"] = cv(f"{ub}.gru.conv{g}1"), cv(f"{ub}.gru.conv{g}2")
    return {
        "fnet": _encoder_from(sd, cv, nrm, "fnet", cfg, names),
        "cnet": _encoder_from(sd, cv, nrm, "cnet", cfg, names),
        "motion": {k: cv(f"{ub}.encoder.{k}") for k in ("convc1", "convc2", "convf1", "convf2", "conv")},
        "gru": gru,
        "flow_head": {"conv1": cv(f"{ub}.flow_head.conv1"), "conv2": cv(f"{ub}.flow_head.conv2")},
        "mask": {"conv1": cv(f"{ub}.mask.0"), "conv2": cv(f"{ub}.mask.2")},
        "gma": {"to_qk": cv("att.to_qk"), "to_v": cv(f"{ub}.aggregator.to_v"),
                "gamma": tensor(sd[f"{ub}.aggregator.gamma"]).reshape(())},
    }


def raft_flow(frame1, frame2, params: Optional[Dict] = None, cfg: RAFTConfig = RAFTConfig(),
              device=None) -> np.ndarray:
    """(H, W, 3) [0, 1] frame pair -> (H, W, 2) numpy pixel flow, on `device` (cuda unless told
    otherwise; seed-0 random weights there when `params` is None). The frames are edge-padded to
    multiples of 8 and the flow cropped back."""
    device = resolve_device(device)
    if params is None:
        params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    f1, f2 = frame(frame1, device), frame(frame2, device)
    h, w = f1.shape[-2:]
    hp, wp = -h % 8, -w % 8
    if hp or wp:
        f1, f2 = (F.pad(f, (0, wp, 0, hp), mode="replicate") for f in (f1, f2))
    with torch.no_grad():
        out = forward(params, f1, f2, cfg)
    return out[0, :, :h, :w].permute(1, 2, 0).cpu().numpy()
