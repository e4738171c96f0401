"""PWC-Net optical flow (pyramid, warping, cost volume), the sniklaus
`pytorch-pwc` architecture.

Port of `maua_tpu/flow/pwc.py`: a 6-level feature pyramid (3 convs a level,
the first of stride 2), a leaky-relu'd channel-mean correlation over a 9x9
displacement window at each level, DenseNet decoders on [corr, feat1,
upflow, upfeat] from level 6 down to 2 with 4x4 stride-2 transposed convs
carrying flow and features up, and a dilated context refiner. NCHW, OIHW;
the transposed convs keep the published (in, out, kh, kw) weights (maua_tpu
flips them into HWIO for an lhs-dilated conv, the bridge flips them back).
`params_from_torch` reads the published `network-default.pytorch` state dict.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.warp import resize
from ..utility import resolve_device
from .layers import conv, correlation, deconv, frame, lrelu, randn_conv, scale_flow, tensor, warp

# feature pyramid channels per level (level 1..6)
_FEAT_CH = [16, 32, 64, 96, 128, 196]
# feat1 channels concatenated at each decoder level (none at level 6)
_DEC_FEAT = {6: 0, 5: 128, 4: 96, 3: 64, 2: 32}
# warped-feature flow scaling per level (sniklaus backwarp constants)
_FLOW_SCALE = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
_DENSE = [128, 128, 96, 64, 32]  # dense decoder widths; a final conv -> 2
_REFINER_DIL = (1, 2, 4, 8, 16, 1, 1)


def _corr_in(level: int) -> int:
    base = 81 + _DEC_FEAT[level]
    return base if level == 6 else base + 2 + 2  # + upflow + upfeat


def init_params(gen: torch.Generator) -> Dict:
    """Random parameters with maua_tpu's distributions and tree, drawn from `gen`."""
    extractor, ci = [], 3
    for co in _FEAT_CH:
        extractor.append([randn_conv(gen, 3, 3, ci, co), randn_conv(gen, 3, 3, co, co), randn_conv(gen, 3, 3, co, co)])
        ci = co
    decoders = {}
    for lvl in (6, 5, 4, 3, 2):
        convs, c = [], _corr_in(lvl)
        for width in _DENSE:
            convs.append(randn_conv(gen, 3, 3, c, width))
            c += width
        convs.append(randn_conv(gen, 3, 3, c, 2))
        dec = {"convs": convs}
        if lvl != 6:  # upsamples the coarser level's flow and features
            for name, cin in (("upflow", 2), ("upfeat", _corr_in(lvl + 1) + sum(_DENSE))):
                p = randn_conv(gen, 4, 4, cin, 2)
                dec[name] = {"w": p["w"].transpose(0, 1).contiguous(), "b": p["b"]}
        decoders[lvl] = dec
    rch = [(_corr_in(2) + sum(_DENSE), 128), (128, 128), (128, 128), (128, 96), (96, 64), (64, 32), (32, 2)]
    refiner = [randn_conv(gen, 3, 3, ci_, co_) for ci_, co_ in rch]
    return {"extractor": extractor, "decoders": decoders, "refiner": refiner, "refiner_dil": _REFINER_DIL}


def params_from_torch(sd: Dict) -> Dict:
    """A sniklaus pytorch-pwc state dict (numpy arrays or tensors) -> the parameter tree: extractor
    `netExtractor.net{One..Six}.{0,2,4}.*`, decoders `net{Two..Six}.net{One..Six}.0.*` with
    `netUpflow` / `netUpfeat`, refiner `netRefiner.netMain.{0,2,...,12}.*`."""
    names = ["netOne", "netTwo", "netThr", "netFou", "netFiv", "netSix"]

    def cv(prefix):
        return {"w": tensor(sd[f"{prefix}.weight"]), "b": tensor(sd[f"{prefix}.bias"])}

    decoders = {}
    for lvl, nm in ((6, "netSix"), (5, "netFiv"), (4, "netFou"), (3, "netThr"), (2, "netTwo")):
        dec = {"convs": [cv(f"{nm}.{sub}.0") for sub in names]}
        if lvl != 6:
            dec["upflow"], dec["upfeat"] = cv(f"{nm}.netUpflow"), cv(f"{nm}.netUpfeat")
        decoders[lvl] = dec
    return {"extractor": [[cv(f"netExtractor.{nm}.{i}") for i in (0, 2, 4)] for nm in names],
            "decoders": decoders, "refiner": [cv(f"netRefiner.netMain.{i}") for i in (0, 2, 4, 6, 8, 10, 12)],
            "refiner_dil": _REFINER_DIL}


def _decode_level(dec: Dict, x: torch.Tensor):
    feats = x
    for p in dec["convs"][:-1]:
        feats = torch.cat([lrelu(conv(feats, p)), feats], dim=1)
    return conv(feats, dec["convs"][-1]), feats


def pwc_forward(params: Dict, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) images in [0, 1] (H, W multiples of 64) -> (B, 2, H/4, W/4) flow in the
    checkpoint's 1/20 units."""
    feats1, feats2 = [], []
    x1, x2 = im1, im2
    for level in params["extractor"]:
        for i, p in enumerate(level):
            s = 2 if i == 0 else 1
            x1, x2 = lrelu(conv(x1, p, stride=s)), lrelu(conv(x2, p, stride=s))
        feats1.append(x1)
        feats2.append(x2)

    flow = feat = None
    for lvl in (6, 5, 4, 3, 2):
        f1, f2 = feats1[lvl - 1], feats2[lvl - 1]
        dec = params["decoders"][lvl]
        if lvl == 6:
            inp = correlation(f1, f2, 4)
        else:
            upflow = deconv(flow, dec["upflow"]["w"], dec["upflow"]["b"])
            upfeat = deconv(feat, dec["upfeat"]["w"], dec["upfeat"]["b"])
            corr = correlation(f1, warp(f2, upflow * _FLOW_SCALE[lvl]), 4)
            inp = torch.cat([corr, f1, upflow, upfeat], dim=1)
        flow, feat = _decode_level(dec, inp)

    x = feat
    for p, dil in zip(params["refiner"][:-1], params["refiner_dil"][:-1]):
        x = lrelu(conv(x, p, dilation=dil))
    return flow + conv(x, params["refiner"][-1])


def pwc_flow(frame1, frame2, params: Optional[Dict] = None, device=None) -> np.ndarray:
    """(H, W, 3) RGB [0, 1] frame pair -> (H, W, 2) numpy pixel flow, on `device` (cuda unless told
    otherwise; seed-0 random weights there when `params` is None). The published weights take BGR;
    the frames are resized to the nearest multiple of 64, the flow scaled by 20 and back."""
    device = resolve_device(device)
    if params is None:
        params = init_params(torch.Generator(device=device).manual_seed(0))
    f1, f2 = (frame(f, device).flip(1) for f in (frame1, frame2))
    h, w = f1.shape[-2:]
    hp, wp = max(int(np.ceil(h / 64)) * 64, 64), max(int(np.ceil(w / 64)) * 64, 64)
    with torch.no_grad():
        f1, f2 = resize(f1, (hp, wp), "bilinear"), resize(f2, (hp, wp), "bilinear")
        flow = resize(pwc_forward(params, f1, f2) * 20.0, (h, w), "bilinear")
        flow = scale_flow(flow, w / wp, h / hp)
    return flow[0].permute(1, 2, 0).cpu().numpy()
