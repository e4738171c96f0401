"""LiteFlowNet optical flow (cascaded matching, subpixel and regularization
units), the sniklaus `pytorch-liteflownet` architecture.

Port of `maua_tpu/flow/liteflownet.py`: a shared 6-level feature pyramid;
per level, coarse (6) to fine (2), three units:
- matching: a leaky-relu'd channel-mean cost volume over a 7x7 window on the
  flow-warped features -> convs -> a flow residual; at levels 2 and 3 the
  volume is taken on a stride-2 lattice and lifted back by a grouped 4x4
  stride-2 transposed conv (`upcorr`, one channel a group);
- subpixel: [feat1, warp(feat2, flow), flow] -> convs -> a flow residual;
- regularization: convs on [brightness error, mean-centred flow, features]
  predict negative-square-distance logits over a k x k window whose
  softmax re-averages the flow locally (the unfold order: dy outer, dx
  inner).
Grouped transposed convs (`upflow`) carry the flow between levels. The
input is BGR with the caffe means subtracted inside. NCHW, OIHW; the
grouped transposed convs keep the published (C, 1, 4, 4) weights.
`params_from_torch` reads `network-default.pytorch` (ModuleList index i is
level i + 2).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.warp import resize
from ..utility import resolve_device
from .layers import conv, correlation, deconv, frame, lrelu, randn_conv, scale_flow, tensor, warp

LEVELS = (2, 3, 4, 5, 6)  # decoder levels, run coarse (6) -> fine (2)

# per-level constants (sniklaus tables, by level number)
_FLOW_SCALE = {2: 10.0, 3: 5.0, 4: 2.5, 5: 1.25, 6: 0.625}
_FLOW_KERNEL = {2: 7, 3: 5, 4: 5, 5: 3, 6: 3}  # final flow-conv size
_UNFOLD = {2: 7, 3: 5, 4: 5, 5: 3, 6: 3}  # regularization window
_FEAT_CH = {1: 32, 2: 32, 3: 64, 4: 96, 5: 128, 6: 192}
_CORR_RADIUS = 3  # 7x7 window -> 49 channels

# BGR means subtracted inside the network (caffe-trained checkpoints), per frame
_MEAN_ONE = (0.411618, 0.434631, 0.454253)
_MEAN_TWO = (0.410782, 0.433645, 0.452793)


def _feature_specs():
    return {"one": [(7, 7, 3, 32)], "two": [(3, 3, 32, 32)] * 3, "thr": [(3, 3, 32, 64), (3, 3, 64, 64)],
            "fou": [(3, 3, 64, 96), (3, 3, 96, 96)], "fiv": [(3, 3, 96, 128)], "six": [(3, 3, 128, 192)]}


def _matching_specs(lvl: int):
    k = _FLOW_KERNEL[lvl]
    return {"feat": [(1, 1, 32, 64)] if lvl == 2 else [],
            "main": [(3, 3, 49, 128), (3, 3, 128, 64), (3, 3, 64, 32), (k, k, 32, 2)],
            "upflow": lvl != 6, "upcorr": lvl < 4}


def _subpixel_specs(lvl: int):
    k = _FLOW_KERNEL[lvl]
    c = (64 if lvl == 2 else _FEAT_CH[lvl]) * 2 + 2
    return {"feat": [(1, 1, 32, 64)] if lvl == 2 else [],
            "main": [(3, 3, c, 128), (3, 3, 128, 64), (3, 3, 64, 32), (k, k, 32, 2)]}


def _regularization_specs(lvl: int):
    u = _UNFOLD[lvl]
    cm = 1 + 2 + (128 if lvl < 5 else _FEAT_CH[lvl])
    spec = {"feat": [(1, 1, _FEAT_CH[lvl], 128)] if lvl < 5 else [],
            "main": [(3, 3, cm, 128), (3, 3, 128, 128), (3, 3, 128, 64), (3, 3, 64, 64), (3, 3, 64, 32),
                     (3, 3, 32, 32)],
            "scale_x": [(1, 1, u * u, 1)], "scale_y": [(1, 1, u * u, 1)]}
    # netDist: one 3x3 conv at levels 5 and 6, else a separable k x 1 then 1 x k pair
    spec["dist"] = [(3, 3, 32, u * u)] if lvl >= 5 else [(u, 1, 32, u * u), (1, u, u * u, u * u)]
    return spec


def init_params(gen: torch.Generator) -> Dict:
    """Random parameters with maua_tpu's distributions and tree, drawn from `gen`."""
    def convs(specs):
        return [randn_conv(gen, *s) for s in specs]

    params: Dict = {"features": {k: convs(v) for k, v in _feature_specs().items()}}
    for lvl in LEVELS:
        ms, ss, rs = _matching_specs(lvl), _subpixel_specs(lvl), _regularization_specs(lvl)
        m = {"feat": convs(ms["feat"]), "main": convs(ms["main"])}
        for name, c in (("upflow", 2), ("upcorr", 49)):
            if ms[name]:
                m[name] = torch.randn(c, 1, 4, 4, generator=gen, device=gen.device) * 0.25
        params[f"matching{lvl}"] = m
        params[f"subpixel{lvl}"] = {"feat": convs(ss["feat"]), "main": convs(ss["main"])}
        params[f"regularization{lvl}"] = {k: convs(rs[k]) for k in ("feat", "main", "dist", "scale_x", "scale_y")}
    return params


def params_from_torch(sd: Dict) -> Dict:
    """A sniklaus pytorch-liteflownet state dict (numpy arrays or tensors) -> the parameter tree.
    Sequential conv indices skip the LeakyReLU slots (0, 2, 4, ...)."""
    def seq(prefix, n):
        return [{"w": tensor(sd[f"{prefix}.{2 * i}.weight"]), "b": tensor(sd[f"{prefix}.{2 * i}.bias"])}
                for i in range(n)]

    params: Dict = {"features": {name: seq(f"netFeatures.net{name.capitalize()}", len(specs))
                                 for name, specs in _feature_specs().items()}}
    for i, lvl in enumerate(LEVELS):
        ms = _matching_specs(lvl)
        m = {"feat": seq(f"netMatching.{i}.netFeat", len(ms["feat"])),
             "main": seq(f"netMatching.{i}.netMain", len(ms["main"]))}
        for name, key in (("upflow", "netUpflow"), ("upcorr", "netUpcorr")):
            if ms[name]:
                m[name] = tensor(sd[f"netMatching.{i}.{key}.weight"])
        params[f"matching{lvl}"] = m
        ss, rs = _subpixel_specs(lvl), _regularization_specs(lvl)
        params[f"subpixel{lvl}"] = {"feat": seq(f"netSubpixel.{i}.netFeat", len(ss["feat"])),
                                    "main": seq(f"netSubpixel.{i}.netMain", len(ss["main"]))}
        params[f"regularization{lvl}"] = {
            "feat": seq(f"netRegularization.{i}.netFeat", len(rs["feat"])),
            "main": seq(f"netRegularization.{i}.netMain", len(rs["main"])),
            "dist": seq(f"netRegularization.{i}.netDist", len(rs["dist"])),
            "scale_x": seq(f"netRegularization.{i}.netScaleX", 1),
            "scale_y": seq(f"netRegularization.{i}.netScaleY", 1),
        }
    return params


def _run_convs(x, convs, final_plain: bool = False, stride_first: int = 1):
    for i, p in enumerate(convs):
        x = conv(x, p, stride=stride_first if i == 0 else 1)
        if not (final_plain and i == len(convs) - 1):
            x = lrelu(x)
    return x


def _features(params, x):
    f = _run_convs(x, params["features"]["one"])
    outs = [f]
    for name in ("two", "thr", "fou", "fiv", "six"):
        f = _run_convs(f, params["features"][name], stride_first=2)
        outs.append(f)
    return outs  # levels 1..6 at scales 1, 1/2, ..., 1/32


def _matching(p, lvl, feat1, feat2, flow):
    if p["feat"]:
        feat1, feat2 = _run_convs(feat1, p["feat"]), _run_convs(feat2, p["feat"])
    if flow is not None:
        # learned x2 upsampling; the per-level _FLOW_SCALE doubles instead of the values
        flow = deconv(flow, p["upflow"], groups=2)
        feat2 = warp(feat2, flow * _FLOW_SCALE[lvl])
    if "upcorr" in p:
        corr = deconv(correlation(feat1, feat2, _CORR_RADIUS, stride=2), p["upcorr"], groups=49)
    else:
        corr = correlation(feat1, feat2, _CORR_RADIUS)
    res = _run_convs(corr, p["main"], final_plain=True)
    return res if flow is None else flow + res


def _subpixel(p, lvl, feat1, feat2, flow):
    if p["feat"]:
        feat1, feat2 = _run_convs(feat1, p["feat"]), _run_convs(feat2, p["feat"])
    inp = torch.cat([feat1, warp(feat2, flow * _FLOW_SCALE[lvl]), flow], dim=1)
    return flow + _run_convs(inp, p["main"], final_plain=True)


def _shifts(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, 1, H, W) -> (B, (2r+1)^2, H, W) of zero-padded shifted copies, dy outer, dx inner."""
    h, w = x.shape[-2:]
    pad = torch.nn.functional.pad(x, (radius, radius, radius, radius))
    return torch.cat([pad[:, :, dy:dy + h, dx:dx + w] for dy in range(2 * radius + 1)
                      for dx in range(2 * radius + 1)], dim=1)


def _regularization(p, lvl, im1, im2, feat1, flow):
    diff = (im1 - warp(im2, flow * _FLOW_SCALE[lvl])).square().sum(dim=1, keepdim=True).sqrt()
    centred = flow - flow.mean(dim=(2, 3), keepdim=True)
    feat = _run_convs(feat1, p["feat"]) if p["feat"] else feat1
    x = _run_convs(torch.cat([diff, centred, feat], dim=1), p["main"])
    for q in p["dist"]:  # no activations between or after
        x = conv(x, q)
    logits = -x.square()
    w = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    div = 1.0 / w.sum(dim=1, keepdim=True)
    r = (_UNFOLD[lvl] - 1) // 2
    sx = conv(w * _shifts(flow[:, :1], r), p["scale_x"][0]) * div
    sy = conv(w * _shifts(flow[:, 1:], r), p["scale_y"][0]) * div
    return torch.cat([sx, sy], dim=1)


def liteflownet_forward(params: Dict, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) BGR [0, 1] pairs (H, W multiples of 32) -> (B, 2, H/2, W/2) flow in
    full-resolution pixels (the x20 output scale applied)."""
    im1 = im1 - torch.tensor(_MEAN_ONE, device=im1.device)[:, None, None]
    im2 = im2 - torch.tensor(_MEAN_TWO, device=im2.device)[:, None, None]
    feats1, feats2 = _features(params, im1), _features(params, im2)
    ims1, ims2 = [im1], [im2]
    for _ in range(5):
        h, w = ims1[-1].shape[-2:]
        ims1.append(resize(ims1[-1], (h // 2, w // 2), "bilinear"))
        ims2.append(resize(ims2[-1], (h // 2, w // 2), "bilinear"))
    flow = None
    for lvl in (6, 5, 4, 3, 2):
        i = lvl - 1  # pyramid index (level 1 = index 0)
        flow = _matching(params[f"matching{lvl}"], lvl, feats1[i], feats2[i], flow)
        flow = _subpixel(params[f"subpixel{lvl}"], lvl, feats1[i], feats2[i], flow)
        flow = _regularization(params[f"regularization{lvl}"], lvl, ims1[i], ims2[i], feats1[i], flow)
    return flow * 20.0


def liteflownet_flow(frame1, frame2, params: Optional[Dict] = None, device=None) -> np.ndarray:
    """(H, W, 3) RGB [0, 1] frame pair -> (H, W, 2) numpy pixel flow, on `device` (cuda unless told
    otherwise; seed-0 random weights there when `params` is None). BGR in, resized to the nearest
    multiple of 32, the half-resolution flow resized and scaled back."""
    device = resolve_device(device)
    if params is None:
        params = init_params(torch.Generator(device=device).manual_seed(0))
    f1, f2 = (frame(f, device).flip(1) for f in (frame1, frame2))
    h, w = f1.shape[-2:]
    hp, wp = max(int(np.ceil(h / 32)) * 32, 32), max(int(np.ceil(w / 32)) * 32, 32)
    with torch.no_grad():
        f1, f2 = resize(f1, (hp, wp), "bilinear"), resize(f2, (hp, wp), "bilinear")
        flow = resize(liteflownet_forward(params, f1, f2), (h, w), "bilinear")
        flow = scale_flow(flow, w / wp, h / hp)
    return flow[0].permute(1, 2, 0).cpu().numpy()
