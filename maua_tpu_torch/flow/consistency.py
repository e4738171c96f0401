"""Forward-backward optical flow consistency check (Ruder et al.).

Port of `maua_tpu/flow/consistency.py` (check_consistency,
check_consistency_np): motion boundaries, round trips that miss and warps
that leave the frame are marked unreliable (0, or -0.75 for a missed round
trip), then a 3x3 gaussian blur and a clip to [0, 1]. It runs on the
flows' device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.warp import grid_sample


def _conv2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Depthwise 'same' correlation of (H, W, C) with a 3x3 kernel, zero padded."""
    c = x.shape[-1]
    out = F.conv2d(x.permute(2, 0, 1)[None], k.expand(c, 1, 3, 3), padding=1, groups=c)
    return out[0].permute(1, 2, 0)


def _sample(field: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Sample the (H, W, C) field at pixel positions pos (H, W, 2) (align_corners=True), border padded."""
    h, w, _ = field.shape
    max_pos = torch.tensor([w - 1, h - 1], dtype=torch.float32, device=field.device)
    grid = (pos / (max_pos / 2.0) - 1.0) * (max_pos / torch.tensor([w, h], dtype=torch.float32, device=field.device))
    return grid_sample(field.permute(2, 0, 1)[None], grid[None], padding_mode="border")[0].permute(1, 2, 0)


def check_consistency(flow_forward, flow_backward) -> torch.Tensor:
    """(B, H, W, 2) or (H, W, 2) flows (the first of a batch is taken) ->
    (H, W) reliability mask in [0, 1]."""
    fwd, bwd = (torch.as_tensor(f if isinstance(f, torch.Tensor) else np.array(f, np.float32)).float()
                for f in (flow_forward, flow_backward))
    bwd = bwd.to(fwd.device)
    if fwd.dim() == 4:
        fwd, bwd = fwd[0], bwd[0]
    h, w, _ = fwd.shape
    dev = fwd.device

    dx_k = torch.tensor([[0, 0, 0], [1, 0, -1], [0, 0, 0]], dtype=torch.float32, device=dev) / 2.0
    dy_k = torch.tensor([[0, 1, 0], [0, 0, 0], [0, -1, 0]], dtype=torch.float32, device=dev) / 2.0
    f_x, f_y = _conv2(bwd, dx_k), _conv2(bwd, dy_k)
    motionedge = f_x.square().sum(-1) + f_y.square().sum(-1)

    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    p1 = torch.stack([xs, ys], dim=-1)
    p0 = p1 + bwd
    v0 = _sample(fwd, p0)
    p1_back = p0 + v0
    v1_back = bwd

    r1 = torch.floor(p0)
    r2 = r1 + 1
    overshoot = (r1[..., 0] < 0) | (r1[..., 1] < 0) | (r2[..., 0] > w - 1) | (r2[..., 1] > h - 1)
    roundtrip_err = (p1_back - p1).square().sum(-1)
    flow_mag = v1_back.square().sum(-1) + v0.square().sum(-1)
    missed = roundtrip_err >= flow_mag * 0.01 + 0.5
    motion_boundary = motionedge >= v1_back.square().sum(-1) * 0.01 + 0.002

    reliable = torch.ones((h, w), device=dev)
    reliable = torch.where(motion_boundary, 0.0, reliable)
    reliable = torch.where(missed, -0.75, reliable)
    reliable = torch.where(overshoot, 0.0, reliable)

    g = torch.tensor([0.25, 0.5, 0.25], dtype=torch.float32, device=dev)
    blurred = _conv2(reliable[..., None], torch.outer(g, g))[..., 0]
    return blurred.clamp(0.0, 1.0)


def check_consistency_np(flow_forward, flow_backward) -> np.ndarray:
    """numpy in, numpy out (on the CPU)."""
    return check_consistency(np.asarray(flow_forward, np.float32), np.asarray(flow_backward, np.float32)).numpy()
