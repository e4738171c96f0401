"""Optical flow estimators and their ensemble.

Port of `maua_tpu/flow/models.py`: OpenCV's Farneback on the host (the
reference's default estimator), a coarse-to-fine Horn-Schunck flow on the
device (`hs_flow`, the registry's "hs" or "jax"), and `get_flow_model`,
which averages the estimators it is given. The five neural estimators
(spynet, pwc, liteflownet, unflow, raft / gma) are not ported yet and
raise; an unknown name raises too (the reference prints a message and
substitutes Farneback).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.warp import grid_sample, identity_grid, resize
from ..utility import resolve_device

# the neural estimators' maua_tpu files, by registry name
_NEURAL = {"spynet": "spynet.py", "pwc": "pwc.py", "pwcnet": "pwc.py", "liteflownet": "liteflownet.py",
           "unflow": "unflow.py", "raft": "raft.py", "gma": "raft.py", "raft_large": "raft.py"}


def farneback_flow(frame1: np.ndarray, frame2: np.ndarray) -> np.ndarray:
    """OpenCV Farneback flow between two (H, W, 3) RGB frames in [0, 1]
    (float; uint8 frames are taken as already scaled to [0, 255]) ->
    (H, W, 2) float32 in pixels."""
    import cv2

    def gray(frame):
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            frame = (frame * 255).astype(np.uint8)
        return cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)

    return cv2.calcOpticalFlowFarneback(
        gray(frame1), gray(frame2), None, pyr_scale=0.5, levels=5, winsize=15, iterations=3, poly_n=5,
        poly_sigma=1.2, flags=0,
    ).astype(np.float32)


def _gray(x: torch.Tensor) -> torch.Tensor:
    return 0.2989 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def _hs_level(i1: torch.Tensor, i2: torch.Tensor, flow: torch.Tensor, n_iter: int = 40,
              alpha: float = 0.01) -> torch.Tensor:
    """Horn-Schunck refinement of flow (H, W, 2) between grey images (H, W) at one pyramid level: each
    iteration smooths the field, warps i2 by it, and takes a regularized step (clipped to a pixel) down
    the brightness constancy error."""
    h, w = i1.shape
    dev = i1.device
    ky = torch.tensor([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=torch.float32, device=dev) / 8.0
    kx = ky.t()
    avg_k = torch.tensor([[1, 2, 1], [2, 0, 2], [1, 2, 1]], dtype=torch.float32, device=dev) / 12.0

    def convolve(img, k):  # 'same' correlation, zero padded, of one or more (H, W) maps
        return F.conv2d(img[:, None], k[None, None], padding=1)[:, 0]

    grid = identity_grid(1, h, w, dev)
    norm = torch.tensor([2.0 / w, 2.0 / h], dtype=torch.float32, device=dev)
    i1x, i1y = convolve(i1[None], kx)[0], convolve(i1[None], ky)[0]
    for _ in range(n_iter):
        f_s = convolve(flow.permute(2, 0, 1), avg_k).permute(1, 2, 0)
        i2w = grid_sample(i2[None, None], grid + f_s[None] * norm, padding_mode="border")[0, 0]
        ix = 0.5 * (i1x + convolve(i2w[None], kx)[0])
        iy = 0.5 * (i1y + convolve(i2w[None], ky)[0])
        it = i2w - i1
        denom = alpha + ix**2 + iy**2
        step = torch.stack([-ix * it / denom, -iy * it / denom], dim=-1).clamp(-1.0, 1.0)
        flow = f_s + step
    return flow


def hs_flow(frame1, frame2, levels: int = 4, device=None) -> torch.Tensor:
    """Coarse-to-fine Horn-Schunck flow on `device` (the frames' device if
    they are tensors, else cuda unless told otherwise): frames (H, W, 3) in
    [0, 1] -> (H, W, 2) pixels, as a tensor on that device."""
    if device is None and isinstance(frame1, torch.Tensor):
        device = frame1.device
    device = resolve_device(device)
    i1, i2 = (_gray(torch.as_tensor(f if isinstance(f, torch.Tensor) else np.array(f, np.float32), dtype=torch.float32,
                                    device=device)) for f in (frame1, frame2))
    h, w = i1.shape
    flow = torch.zeros((h // 2 ** (levels - 1), w // 2 ** (levels - 1), 2), device=device)
    for lvl in range(levels - 1, -1, -1):
        hs, ws = h // 2**lvl, w // 2**lvl
        p1 = resize(i1[None, None], (hs, ws), "bilinear")[0, 0]
        p2 = resize(i2[None, None], (hs, ws), "bilinear")[0, 0]
        if tuple(flow.shape[:2]) != (hs, ws):
            flow = resize(flow.permute(2, 0, 1)[None], (hs, ws), "bilinear")[0].permute(1, 2, 0) * 2.0
        flow = _hs_level(p1, p2, flow)
    return flow


def get_flow_model(which: Sequence[str] = ("farneback",), allow_random: bool = False, device=None) -> Callable:
    """fn(frame1, frame2) -> (H, W, 2) numpy flow, the mean of the named
    estimators': "farneback" (on the host) and "hs" / "jax" (Horn-Schunck on
    `device`, cuda unless told otherwise). The neural estimators raise
    NotImplementedError (`allow_random`, their random-weight opt-in, waits
    for them) and an unknown name raises ValueError."""
    fns: List[Callable] = []
    for name in which:
        if name == "farneback":
            fns.append(farneback_flow)
        elif name in ("hs", "jax"):
            dev = resolve_device(device)
            fns.append(lambda a, b: hs_flow(a, b, device=dev).cpu().numpy())
        elif name in _NEURAL:
            raise NotImplementedError(f"the {name!r} flow estimator is not ported yet (maua_tpu/flow/{_NEURAL[name]})")
        else:
            raise ValueError(f"unknown flow model {name!r}: farneback, hs, jax or one of {sorted(_NEURAL)}")

    def model(frame1, frame2):
        return np.mean([np.asarray(fn(frame1, frame2)) for fn in fns], axis=0)

    return model
