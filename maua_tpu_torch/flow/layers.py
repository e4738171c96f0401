"""Layers shared by the neural flow estimators (spynet, pwc, liteflownet,
unflow, raft): convolutions padded as JAX's "SAME", the transposed convs,
backward warps by a pixel flow and channel-mean correlation volumes. NCHW
activations, OIHW conv weights, transposed-conv weights as
`F.conv_transpose2d` takes them ((in, out / groups, kh, kw)), flows
(B, 2, H, W) in pixels with x first.

JAX's "SAME" pads (lo, hi) = (t // 2, t - t // 2) of the total t, so a
stride-2 convolution of an even input is padded one more at the bottom
and right than at the top and left; PyTorch's symmetric `padding=` would
shift the output by a pixel, so the pads are explicit.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.warp import grid_sample, identity_grid


def same_pads(size: int, k: int, stride: int = 1, dilation: int = 1):
    """(lo, hi) padding of one axis as JAX's "SAME" pads it."""
    k_eff = (k - 1) * dilation + 1
    total = max((math.ceil(size / stride) - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, p: Dict, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """A "SAME" convolution of NCHW x by p["w"] (OIHW) plus p["b"]."""
    w = p["w"]
    top, bottom = same_pads(x.shape[-2], w.shape[-2], stride, dilation)
    left, right = same_pads(x.shape[-1], w.shape[-1], stride, dilation)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, p.get("b"), stride=stride, dilation=dilation)


def deconv(x: torch.Tensor, w: torch.Tensor, b=None, groups: int = 1) -> torch.Tensor:
    """The 4x4 stride-2 pad-1 transposed conv that doubles H and W."""
    return F.conv_transpose2d(x, w, b, stride=2, padding=1, groups=groups)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def warp(img: torch.Tensor, flow: torch.Tensor, padding_mode: str = "zeros") -> torch.Tensor:
    """img (B, C, H, W) sampled at each pixel plus flow (B, 2, H, W), bilinear."""
    b, _, h, w = img.shape
    norm = torch.tensor([2.0 / w, 2.0 / h], dtype=flow.dtype, device=flow.device)
    grid = identity_grid(b, h, w, img.device) + flow.permute(0, 2, 3, 1) * norm
    return grid_sample(img, grid, padding_mode=padding_mode)


def correlation(f1: torch.Tensor, f2: torch.Tensor, radius: int, step: int = 1, stride: int = 1) -> torch.Tensor:
    """Channel-mean products of f1 with f2 shifted by every displacement (dy, dx) in
    range(-radius, radius + 1, step), dy outer, dx inner (zero padded), leaky-relu'd:
    (B, C, H, W) x 2 -> (B, n^2, H', W'). stride 2 evaluates on the lattice f1[::2, ::2]."""
    f1 = f1[:, :, ::stride, ::stride]
    h, w = f1.shape[-2:]
    pad = F.pad(f2, (radius, radius, radius, radius))
    span_h, span_w = stride * (h - 1) + 1, stride * (w - 1) + 1
    outs: List[torch.Tensor] = []
    for dy in range(0, 2 * radius + 1, step):
        for dx in range(0, 2 * radius + 1, step):
            shifted = pad[:, :, dy:dy + span_h:stride, dx:dx + span_w:stride]
            outs.append((f1 * shifted).mean(dim=1))
    return lrelu(torch.stack(outs, dim=1))


def scale_flow(flow: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """flow (B, 2, H, W) with x scaled by sx and y by sy."""
    return flow * torch.tensor([sx, sy], dtype=flow.dtype, device=flow.device)[:, None, None]


def frame(f, device) -> torch.Tensor:
    """An (H, W, 3) frame in [0, 1] (numpy or tensor) -> (1, 3, H, W) f32 on `device`."""
    t = f if isinstance(f, torch.Tensor) else torch.from_numpy(np.asarray(f, np.float32))
    return t.to(device=device, dtype=torch.float32).permute(2, 0, 1)[None]


def randn_conv(gen: torch.Generator, kh: int, kw: int, ci: int, co: int) -> Dict:
    """A conv drawn as maua_tpu's estimators draw theirs: normal / sqrt(kh kw ci), zero bias; OIHW."""
    w = torch.randn(co, ci, kh, kw, generator=gen, device=gen.device) * (1.0 / math.sqrt(kh * kw * ci))
    return {"w": w, "b": torch.zeros(co, device=gen.device)}


def tensor(a, device=None) -> torch.Tensor:
    """A state-dict entry (numpy array or tensor) as an f32 tensor."""
    return torch.as_tensor(a).detach().to(device=device, dtype=torch.float32).clone()
