"""Optical flow estimators and their ensemble.

Port of `maua_tpu/flow/models.py`: OpenCV's Farneback on the host (the
reference's default estimator), a coarse-to-fine Horn-Schunck flow on the
device (`hs_flow`, the registry's "hs" or "jax"), the five neural
estimators (spynet, pwc, liteflownet, unflow, raft / gma) from their
published checkpoints in `utility.MODELZOO` (`_neural_params`), and
`get_flow_model`, which averages the estimators it is given. An unknown
name raises (the reference prints a message and substitutes Farneback).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import utility
from ..ops.warp import grid_sample, identity_grid, resize
from ..utility import resolve_device, to_device

# the neural estimators by registry name: (module, flow function, converter, checkpoint file names)
_NEURAL = {
    "spynet": ("spynet", "spynet_flow", "params_from_torch",
               ("spynet.pth", "network-sintel-final.pytorch", "spynet_sintel_final.pth")),
    "pwc": ("pwc", "pwc_flow", "params_from_torch", ("pwc.pth", "network-default.pytorch", "pwc_default.pth")),
    "liteflownet": ("liteflownet", "liteflownet_flow", "params_from_torch",
                    ("liteflownet.pth", "network-default-lfn.pytorch", "liteflownet_default.pth")),
    "unflow": ("unflow", "unflow_flow", "params_from_torch", ("unflow.pth", "network-css.pytorch", "unflow_css.pth")),
    "raft": ("raft", "raft_flow", "params_from_torch", ("raft_large.pth",)),
    "gma": ("raft", "raft_flow", "params_from_torch_gma", ("gma-sintel.pth", "gma-things.pth", "gma.pth")),
}
_NEURAL["pwcnet"], _NEURAL["raft_large"] = _NEURAL["pwc"], _NEURAL["raft"]


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


def _neural_params(name: str, candidates: Sequence[str], convert: Callable, allow_random: bool) -> Optional[dict]:
    """The converted parameters of the first checkpoint of `candidates` present in
    `utility.MODELZOO` (a `{"model": state_dict}` training state is unwrapped). With none
    loadable, FileNotFoundError naming the paths, unless `allow_random` (then None: random
    weights, with the load errors printed). Random weights averaged into an ensemble would
    corrupt every warp downstream, so they are an explicit opt-in."""
    errs = []
    for fname in candidates:
        ckpt = os.path.join(utility.MODELZOO, fname)
        if os.path.exists(ckpt):
            try:
                sd = torch.load(ckpt, map_location="cpu", weights_only=True)
                if isinstance(sd, dict) and "model" in sd:
                    sd = sd["model"]  # training-state wrapper (raft / gma)
                return convert({k: torch.as_tensor(v).float() for k, v in sd.items()})
            except Exception as e:  # noqa: BLE001 - every failure is reported with its path
                errs.append(f"{ckpt}: {e}")
    if allow_random:
        if errs:
            print(f"{name} checkpoint load failed ({'; '.join(errs)}); using random init")
        return None
    paths = ", ".join(os.path.join(utility.MODELZOO, f) for f in candidates)
    raise FileNotFoundError(
        f"flow model {name!r} has no checkpoint (looked for: {paths})"
        + (f"; load errors: {'; '.join(errs)}" if errs else "")
        + " -- pass allow_random=True to get_flow_model to run it with random weights")


def _neural_flow(name: str, allow_random: bool, device) -> Callable:
    """fn(frame1, frame2) -> numpy flow of a neural estimator, its parameters on `device`."""
    import importlib

    module, flow_fn, converter, candidates = _NEURAL[name]
    mod = importlib.import_module(f"{__package__}.{module}")
    params = _neural_params(name, candidates, getattr(mod, converter), allow_random)
    if params is None:  # seed-0 random weights, drawn once
        gen = torch.Generator(device=device).manual_seed(0)
        params = mod.init_params(gen, gma=True) if name == "gma" else mod.init_params(gen)
    params = to_device(params, device)
    fn = getattr(mod, flow_fn)
    return lambda a, b: fn(a, b, params=params, device=device)


def get_flow_model(which: Sequence[str] = ("farneback",), allow_random: bool = False, device=None) -> Callable:
    """fn(frame1, frame2) -> (H, W, 2) numpy flow, the mean of the named
    estimators': "farneback" (on the host), "hs" / "jax" (Horn-Schunck) and
    the neural spynet, pwc (pwcnet), liteflownet, unflow, raft (raft_large)
    and gma, each on `device` (cuda unless told otherwise). A neural
    estimator loads its published checkpoint from `utility.MODELZOO` and
    raises FileNotFoundError without one, unless `allow_random` (seed-0
    random weights). An unknown name raises ValueError."""
    fns: List[Callable] = []
    for name in which:
        if name == "farneback":
            fns.append(farneback_flow)
        elif name in ("hs", "jax"):
            dev = resolve_device(device)
            fns.append(lambda a, b: hs_flow(a, b, device=dev).cpu().numpy())
        elif name in _NEURAL:
            fns.append(_neural_flow(name, allow_random, resolve_device(device)))
        else:
            raise ValueError(f"unknown flow model {name!r}: farneback, hs, jax or one of {sorted(_NEURAL)}")

    def model(frame1, frame2):
        return np.mean([np.asarray(fn(frame1, frame2)) for fn in fns], axis=0)

    return model
