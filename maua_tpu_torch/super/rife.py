"""RIFE-style frame interpolation (IFNet).

Port of `maua_tpu/super/rife.py` (RIFEConfig, init_params, midpoint,
recursive_inference, interpolate): a coarse-to-fine IFNet predicts two
flows and a fusion mask, applied recursively for 2^n x the frame rate.
Frames are NCHW inside and NHWC at `interpolate`. The downsamples to 1/4
and 1/2 are jax.image.resize's antialiased bilinear and the flows' x2
upsamples its bilinear (`ops/warp.resize`); warping is the port's
`ops/warp.grid_sample` with border padding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.video import rgb_to_yuv420
from ..ops.warp import grid_sample, identity_grid, resize
from ..utility import resolve_device, to_device


@dataclasses.dataclass(frozen=True)
class RIFEConfig:
    base_channels: int = 32
    scales: int = 3  # coarse-to-fine IFBlocks at 1/4, 1/2, 1/1


def _conv_init(gen, ci, co, k=3):
    s = math.sqrt(2.0 / (ci * k * k))
    return {"w": torch.randn((co, ci, k, k), generator=gen, device=gen.device) * s,
            "b": torch.zeros((co,), device=gen.device)}


def _conv(p, x, stride=1):
    return F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride=stride, padding=p["w"].shape[-1] // 2)


def _init_ifblock(gen, c_in, c):
    # 4 flow channels (two flows) + 1 mask
    return {"conv0": _conv_init(gen, c_in, c), "conv1": _conv_init(gen, c, c), "conv2": _conv_init(gen, c, c),
            "conv3": _conv_init(gen, c, c), "head": _conv_init(gen, c, 5)}


def _ifblock(p, x):
    h = F.leaky_relu(_conv(p["conv0"], x, stride=2), 0.2)
    for name in ("conv1", "conv2", "conv3"):
        h = F.leaky_relu(_conv(p[name], h), 0.2)
    out = _conv(p["head"], h)
    return resize(out, (out.shape[2] * 2, out.shape[3] * 2), "bilinear")


def init_params(gen: torch.Generator, cfg: RIFEConfig = RIFEConfig()) -> Dict:
    blocks = []
    for i in range(cfg.scales):
        c_in = 6 if i == 0 else 6 + 5  # the frames (+ the previous flow / mask estimate)
        blocks.append(_init_ifblock(gen, c_in, cfg.base_channels * (2 ** (cfg.scales - 1 - i))))
    return {"blocks": blocks}


def _warp(img, flow):
    """Backward-warp img (B, C, H, W) by flow (B, 2, H, W) in pixels."""
    b, _, h, w = img.shape
    norm = torch.tensor([2.0 / w, 2.0 / h], device=img.device)
    grid = identity_grid(b, h, w, img.device) + flow.permute(0, 2, 3, 1) * norm
    return grid_sample(img, grid, padding_mode="border")


def midpoint(params: Dict, frame0: torch.Tensor, frame1: torch.Tensor, cfg: RIFEConfig = RIFEConfig()) -> torch.Tensor:
    """The temporal midpoint of two frames (B, 3, H, W) in [0, 1], H and W
    divisible by 2^(scales+1)."""
    b, _, h, w = frame0.shape
    est = None
    for i, blk in enumerate(params["blocks"]):
        scale = 2 ** (cfg.scales - 1 - i)
        size = (h // scale, w // scale)
        f0 = resize(frame0, size, "bilinear")
        f1 = resize(frame1, size, "bilinear")
        if est is None:
            inp = torch.cat([f0, f1], dim=1)
        else:
            est_up = resize(est, size, "bilinear")
            est_up = torch.cat([est_up[:, :4] * 2.0, est_up[:, 4:]], dim=1)  # flows scale with resolution
            inp = torch.cat([_warp(f0, est_up[:, 0:2]), _warp(f1, est_up[:, 2:4]), est_up], dim=1)
            est = est_up
        delta = _ifblock(blk, inp)
        est = delta if est is None else est + delta
    mask = torch.sigmoid(est[:, 4:5])
    w0 = _warp(frame0, est[:, 0:2])
    w1 = _warp(frame1, est[:, 2:4])
    return torch.clamp(w0 * mask + w1 * (1 - mask), 0.0, 1.0)


def recursive_inference(params, frame0, frame1, n: int, cfg: RIFEConfig = RIFEConfig(),
                        mid_fn=None) -> List[torch.Tensor]:
    """2^n - 1 intermediate frames between frame0 and frame1, in order."""
    if n == 0:
        return []
    fn = mid_fn if mid_fn is not None else (lambda p, a, b: midpoint(p, a, b, cfg))
    mid = fn(params, frame0, frame1)
    return (recursive_inference(params, frame0, mid, n - 1, cfg, fn) + [mid]
            + recursive_inference(params, mid, frame1, n - 1, cfg, fn))


@torch.no_grad()
def interpolate(frames: np.ndarray, factor: int = 2, params=None, cfg: RIFEConfig = RIFEConfig(), seed: int = 0,
                pix_fmt: str = "rgb24", device=None) -> Iterator[np.ndarray]:
    """Yield the frame stream at `factor` x the rate, (T - 1) * factor + 1
    frames. frames: (T, H, W, 3) in [0, 1]. Without `params` the net is
    drawn from `seed`. Each pair's frames are fetched after the next
    pair's midpoints are queued. pix_fmt="rgb24" yields (H, W, 3) f32 in
    [0, 1]; "yuv420p" converts to planar I420 uint8 on the device, (3H/2, W)."""
    device = resolve_device(device)
    params = init_params(torch.Generator(device=device).manual_seed(seed), cfg) if params is None \
        else to_device(params, device)
    n = int(math.log2(factor))

    def conv(x):
        x = x.permute(0, 2, 3, 1)
        if pix_fmt == "yuv420p":
            return rgb_to_yuv420(torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8))[0]
        return x[0]

    def frame(i):
        return torch.as_tensor(np.asarray(frames[i : i + 1], np.float32), device=device).permute(0, 3, 1, 2)

    pending: List = []
    for i in range(len(frames) - 1):
        f0, f1 = frame(i), frame(i + 1)
        cur = [conv(f0)] + [conv(m) for m in recursive_inference(params, f0, f1, n, cfg)]
        for m in pending:  # fetch pair i-1 once pair i is queued
            yield m.cpu().numpy()
        pending = cur
    pending.append(conv(frame(len(frames) - 1)))
    for m in pending:
        yield m.cpu().numpy()
