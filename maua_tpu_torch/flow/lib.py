"""Flow utilities: the JPEG-safe mflo codec, warp maps, consistency maps and
the cached preprocessing of a video's flow.

Port of `maua_tpu/flow/lib.py` (encode_mflo, decode_mflo, flow_warp_map,
get_consistency_map, preprocess_optical_flow). Pixel flows are (.., H, W, 2)
(x, y); a warp map is the normalized (B, H, W, 2) grid of `ops.warp.grid_sample`.
`preprocess_optical_flow` indexes its arrays by transition i -> i + 1
(circular): `forward[i]` is the flow from frame i to frame i + 1 and
`backward[i]` the flow from i + 1 to i, the pull map that warps frame i
into frame i + 1.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .. import utility
from ..ops.warp import identity_grid
from .consistency import check_consistency


def encode_mflo(flow: np.ndarray) -> np.ndarray:
    """Pack float flow (H, W, 2) into a JPEG-safe uint8 image: u and v mapped
    to [0, 255] by the largest magnitude, whose four f32 bytes fill the third
    channel's quadrants."""
    absmax = np.max(np.abs(flow))
    if absmax == 0:
        absmax = 1e-8
    one, two, three, four = struct.pack("!f", np.float32(absmax))
    h, w, _ = flow.shape
    absmax_channel = np.zeros((h, w, 1), dtype=np.uint8)
    absmax_channel[: h // 2, : w // 2] = one
    absmax_channel[: h // 2, w // 2 :] = two
    absmax_channel[h // 2 :, : w // 2] = three
    absmax_channel[h // 2 :, w // 2 :] = four
    mflo = np.round((flow / absmax + 1) * 127.5).astype(np.uint8)
    return np.concatenate((mflo, absmax_channel), axis=2)


def decode_mflo(mflo: np.ndarray) -> np.ndarray:
    """The flow of an `encode_mflo` image (each quadrant's mean byte, rounded)."""
    h, w, _ = mflo.shape
    ac = mflo[..., 2].astype(np.float32)
    quads = (ac[: h // 2, : w // 2], ac[: h // 2, w // 2 :], ac[h // 2 :, : w // 2], ac[h // 2 :, w // 2 :])
    (absmax,) = struct.unpack("!f", bytes(int(np.uint8(np.round(np.mean(q)))) for q in quads))
    return (mflo[..., :2].astype(np.float32) / 127.5 - 1) * absmax


def flow_warp_map(flow) -> torch.Tensor:
    """Pixel flow (B, H, W, 2) or (H, W, 2) -> the normalized grid_sample map (B, H, W, 2)."""
    flow = torch.as_tensor(flow if isinstance(flow, torch.Tensor) else np.array(flow, np.float32)).float()
    if flow.dim() == 3:
        flow = flow[None]
    b, h, w, _ = flow.shape
    norm = torch.tensor([2.0 / w, 2.0 / h], dtype=torch.float32, device=flow.device)
    return identity_grid(b, h, w, flow.device) + flow * norm


def get_consistency_map(forward_flow, backward_flow, consistency: str = "full") -> torch.Tensor:
    """"magnitude": the forward flow's length; "full" or "numpy": the
    forward-backward check; anything else: ones."""
    forward_flow = torch.as_tensor(forward_flow if isinstance(forward_flow, torch.Tensor)
                                   else np.array(forward_flow, np.float32)).float()
    if consistency == "magnitude":
        return forward_flow.square().sum(-1).sqrt()
    if consistency in ("full", "numpy"):
        return check_consistency(forward_flow, backward_flow)
    shape = forward_flow.shape
    return torch.ones(shape[-3:-1] if len(shape) >= 3 else shape[:2], device=forward_flow.device)


def preprocess_optical_flow(video_file: str, flow_model, consistency: str = "full",
                            max_frames: Optional[int] = None) -> Tuple[np.ndarray, ...]:
    """Estimate and cache each transition's forward, backward and reliability
    flow of a video (read through `ops.video.read_video`). The arrays are
    `.npy` files in WORKSPACE named by the video's stem (and the frame count
    when `max_frames` is given), and are read back memory-mapped. Returns
    (frames NHWC in [0, 1], forward, backward, reliable)."""
    from ..ops.video import read_video

    stem = Path(video_file).stem
    if max_frames is not None:
        stem += f"_n{max_frames}"  # the cache is keyed on the frame count too
    ws = utility.WORKSPACE
    os.makedirs(ws, exist_ok=True)
    frf, fwf, bkf = (f"{ws}/{stem}_content.npy", f"{ws}/{stem}_forward_flow.npy", f"{ws}/{stem}_backward_flow.npy")
    rlf = f"{ws}/{stem}_reliable_{consistency}_flow.npy"

    if not (os.path.exists(frf) and os.path.exists(fwf) and os.path.exists(bkf)):
        frames, _ = read_video(video_file, max_frames=max_frames)
        n = len(frames)
        forward = np.stack([flow_model(frames[i], frames[(i + 1) % n]) for i in range(n)])
        backward = np.stack([flow_model(frames[(i + 1) % n], frames[i]) for i in range(n)])
        np.save(frf, frames)
        np.save(fwf, forward)
        np.save(bkf, backward)

    frames = np.load(frf, mmap_mode="r")
    forward = np.load(fwf, mmap_mode="r")
    backward = np.load(bkf, mmap_mode="r")
    if not os.path.exists(rlf):
        reliable = np.stack([get_consistency_map(np.asarray(f), np.asarray(b), consistency).cpu().numpy()
                             for f, b in zip(forward, backward)]).astype(np.float32)
        np.save(rlf, reliable)
    return frames, forward, backward, np.load(rlf, mmap_mode="r")
