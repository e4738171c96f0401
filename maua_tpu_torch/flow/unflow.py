"""UnFlow optical flow: the CSS stack, FlowNetC followed by two FlowNetS
refiners.

Port of `maua_tpu/flow/unflow.py`. Stage 1 (FlowNetC): a siamese 3-conv
encoder to 1/8 resolution, a leaky-relu'd channel-mean correlation over a
21x21 displacement grid sampled every 2 px (441 channels), a 1x1
"redirect" of the first image's features, then the FlowNet encoder and
decoder with 4x4 stride-2 transposed convs between the scales. Stages 2
and 3 (FlowNetS) re-estimate the flow from [im1, im2, warp(im2, flow) -
mean, flow / 20, brightness error]; each stage's 1/4-resolution output is
resized to full resolution and scaled by 20. NCHW, OIHW; the transposed
convs keep the published (in, out, kh, kw) weights. `params_from_torch`
reads the `network-css.pytorch` layout (`netFlownets.{i}`, stage 0 the
FlowNetC).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.warp import resize
from ..utility import resolve_device
from .layers import conv, correlation, deconv, frame, lrelu, randn_conv, scale_flow, tensor, warp

_CORR_RADIUS = 20  # max displacement, sampled every 2 px -> 21x21 = 441
_CORR_STEP = 2

# encoder convs shared by the C and S stages from conv4 down: (name, k, ci, co, stride)
_TAIL = [("fou", 3, 256, 512, 2), ("fou_1", 3, 512, 512, 1), ("fiv", 3, 512, 512, 2), ("fiv_1", 3, 512, 512, 1),
         ("six", 3, 512, 1024, 2), ("six_1", 3, 1024, 1024, 1)]
# decoder: (name, output channels, input channels) of each upconv
_DEC = [("fiv", 512, 1024), ("fou", 256, 512 + 512 + 2), ("thr", 128, 512 + 256 + 2), ("two", 64, 256 + 128 + 2)]
_FLOW_IN = {"fiv": 512 + 512 + 2, "fou": 512 + 256 + 2, "thr": 256 + 128 + 2, "two": 128 + 64 + 2}


def _stage_specs(complex_: bool):
    if complex_:
        enc = [("one", 7, 3, 64, 2), ("two", 5, 64, 128, 2), ("thr", 5, 128, 256, 2),
               ("redir", 1, 256, 32, 1), ("combined", 3, 441 + 32, 256, 1)]
    else:
        enc = [("one", 7, 12, 64, 2), ("two", 5, 64, 128, 2), ("thr", 5, 128, 256, 2), ("thr_1", 3, 256, 256, 1)]
    return enc + _TAIL


def init_params(gen: torch.Generator, stages: int = 3) -> List[Dict]:
    """Random parameters ([FlowNetC, FlowNetS, ...]) with maua_tpu's distributions, drawn from `gen`."""
    nets = []
    for s in range(stages):
        p: Dict = {name: randn_conv(gen, k, k, ci, co) for name, k, ci, co, _ in _stage_specs(complex_=(s == 0))}
        p["flow_six"] = randn_conv(gen, 3, 3, 1024, 2)
        for name, co, cin in _DEC:
            for key, (ci_, co_) in ((f"up_{name}", (cin, co)), (f"upflow_{name}", (2, 2))):
                q = randn_conv(gen, 4, 4, ci_, co_)
                p[key] = {"w": q["w"].transpose(0, 1).contiguous(), "b": q["b"]}
        for name, cin in _FLOW_IN.items():
            p[f"flow_{name}"] = randn_conv(gen, 3, 3, cin, 2)
        nets.append(p)
    return nets


def params_from_torch(sd: Dict, stages: int = 3) -> List[Dict]:
    """A pytorch-unflow CSS state dict (numpy arrays or tensors) -> the per-stage parameter list."""
    def cv(name):
        return {"w": tensor(sd[f"{name}.weight"]), "b": tensor(sd[f"{name}.bias"])}

    nets = []
    for s in range(stages):
        pre = f"netFlownets.{s}"
        # sequential modules carry the conv at index 0 (the LeakyReLU at 1)
        p: Dict = {name: cv(f"{pre}.net{name.title().replace('_', '')}.0") for name, *_ in _stage_specs(s == 0)}
        p["flow_six"] = cv(f"{pre}.netUpconv.netSixOut.0")
        for name, _co, _cin in _DEC:
            p[f"up_{name}"] = cv(f"{pre}.netUpconv.net{name.title()}Next.0")
            p[f"upflow_{name}"] = cv(f"{pre}.netUpconv.net{name.title()}Up.0")
        for name in ("fiv", "fou", "thr", "two"):
            p[f"flow_{name}"] = cv(f"{pre}.netUpconv.net{name.title()}Out.0")
        nets.append(p)
    return nets


def _up(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return deconv(x, p["w"], p["b"])


def _decoder(p: Dict, feats: Dict) -> torch.Tensor:
    """FlowNet refinement from the encoder activations -> flow at 1/4 resolution (network units)."""
    x = feats["six_1"]
    flow = conv(x, p["flow_six"])
    for name, skip in (("fiv", "fiv_1"), ("fou", "fou_1"), ("thr", "thr_out"), ("two", "two_out")):
        x = torch.cat([feats[skip], lrelu(_up(p[f"up_{name}"], x)), _up(p[f"upflow_{name}"], flow)], dim=1)
        flow = conv(x, p[f"flow_{name}"])
    return flow


def _encoder_tail(p: Dict, x: torch.Tensor, feats: Dict) -> Dict:
    for name in ("fou", "fiv", "six"):
        x = lrelu(conv(x, p[name], stride=2))
        x = lrelu(conv(x, p[f"{name}_1"]))
        feats[f"{name}_1"] = x
    return feats


def _flownet_c(p: Dict, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
    a, b = lrelu(conv(im1, p["one"], stride=2)), lrelu(conv(im2, p["one"], stride=2))
    a2, b2 = lrelu(conv(a, p["two"], stride=2)), lrelu(conv(b, p["two"], stride=2))
    a3, b3 = lrelu(conv(a2, p["thr"], stride=2)), lrelu(conv(b2, p["thr"], stride=2))
    corr = correlation(a3, b3, _CORR_RADIUS, step=_CORR_STEP)
    x = lrelu(conv(torch.cat([corr, lrelu(conv(a3, p["redir"]))], dim=1), p["combined"]))
    return _decoder(p, _encoder_tail(p, x, {"two_out": a2, "thr_out": x}))


def _flownet_s(p: Dict, inp: torch.Tensor) -> torch.Tensor:
    x = lrelu(conv(inp, p["one"], stride=2))
    two = x = lrelu(conv(x, p["two"], stride=2))
    x = lrelu(conv(x, p["thr"], stride=2))
    x = lrelu(conv(x, p["thr_1"]))
    return _decoder(p, _encoder_tail(p, x, {"two_out": two, "thr_out": x}))


def unflow_forward(params: List[Dict], im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) [0, 1] RGB pairs (H, W multiples of 64) -> (B, 2, H, W) pixel flow."""
    h, w = im1.shape[-2:]
    mean2 = im2.mean(dim=(2, 3), keepdim=True)
    n1, n2 = im1 - im1.mean(dim=(2, 3), keepdim=True), im2 - mean2  # per-image channel-mean centering
    flow = None
    for i, p in enumerate(params):
        if i == 0:
            q = _flownet_c(p, n1, n2)
        else:
            warped = warp(im2, flow)
            err = (im1 - warped).square().sum(dim=1, keepdim=True).sqrt()
            q = _flownet_s(p, torch.cat([n1, n2, warped - mean2, flow / 20.0, err], dim=1))
        flow = resize(q, (h, w), "bilinear") * 20.0
    return flow


def unflow_flow(frame1, frame2, params: Optional[List[Dict]] = None, device=None) -> np.ndarray:
    """(H, W, 3) RGB [0, 1] frame pair -> (H, W, 2) numpy pixel flow, on `device` (cuda unless told
    otherwise; seed-0 random weights there when `params` is None). Resized to the nearest multiple
    of 64 and the flow scaled back."""
    device = resolve_device(device)
    if params is None:
        params = init_params(torch.Generator(device=device).manual_seed(0))
    f1, f2 = frame(frame1, device), frame(frame2, device)
    h, w = f1.shape[-2:]
    hp, wp = max(int(np.ceil(h / 64)) * 64, 64), max(int(np.ceil(w / 64)) * 64, 64)
    with torch.no_grad():
        f1, f2 = resize(f1, (hp, wp), "bilinear"), resize(f2, (hp, wp), "bilinear")
        flow = unflow_forward(params, f1, f2)
        if (hp, wp) != (h, w):
            flow = scale_flow(resize(flow, (h, w), "bilinear"), w / wp, h / hp)
    return flow[0].permute(1, 2, 0).cpu().numpy()
