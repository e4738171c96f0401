"""Seamless diffusion video loops from circularly smoothed noise.

Port of `maua_tpu/diffusion/loop.py` (looped_noise, loop_video): a noise
video smoothed along its wrapped time axis (so that the last frame flows
into the first) perturbs a shared starting point, each frame of which the
processor partially denoises; with a latent processor (one with `encode`)
in latent space, decoded afterwards. Every batch starts its processor from
the same draws (a generator seeded alike for each batch). A `cache_name`
keeps the frames in `WORKSPACE/{cache_name}_loop.npy` and returns them from
there on the next call.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .. import utility
from ..ops.signal import gaussian_filter
from ..prompt import TextPrompt


def looped_noise(n_frames: int, shape, sigma: float = 4.0, gen: Optional[torch.Generator] = None,
                 noise=None) -> torch.Tensor:
    """(n_frames, *shape) standard normal noise (`noise`, or a draw from `gen`),
    gaussian-filtered along the circular time axis and scaled to unit
    standard deviation per frame."""
    if noise is None:
        noise = torch.randn((n_frames,) + tuple(shape), generator=gen, device=gen.device if gen else None)
    noise = torch.as_tensor(np.asarray(noise) if not isinstance(noise, torch.Tensor) else noise).float()
    smooth = gaussian_filter(noise, sigma, mode="circular")
    std = smooth.std(dim=tuple(range(1, smooth.dim())), keepdim=True, unbiased=False)
    return smooth / std.clamp_min(1e-6)


def loop_video(
    diffusion,
    init_img,  # (1, H, W, 3) in [-1, 1]
    n_frames: int = 48,
    t_start: float = 0.6,
    text: Optional[str] = None,
    noise_sigma: float = 4.0,
    batch_size: int = 8,
    cache_name: Optional[str] = None,
    verbose: bool = True,
    seed: int = 0,
    noise=None,
    noises: Optional[Sequence] = None,
) -> np.ndarray:
    """Partially denoise each frame from the shared init plus 0.1 of the
    looped noise (drawn from a generator seeded with `seed`, or `noise`, the
    unsmoothed (n_frames, ...) draw); each batch's processor call draws from
    a generator seeded with seed + 1, or takes `noises` (one of the
    processor's `noise` per batch). Returns (n_frames, H, W, 3) in [-1, 1]."""
    dev = diffusion.device
    cache_path = None
    if cache_name:
        os.makedirs(utility.WORKSPACE, exist_ok=True)
        cache_path = os.path.join(utility.WORKSPACE, f"{cache_name}_loop.npy")
        if os.path.exists(cache_path):
            return np.load(cache_path)

    init_img = torch.as_tensor(np.asarray(init_img) if not isinstance(init_img, torch.Tensor) else init_img,
                               device=dev).float()
    prompts = [TextPrompt(text)] if text else []
    latent_mode = hasattr(diffusion, "encode")
    z0 = diffusion.encode(init_img.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) if latent_mode else init_img
    gen = torch.Generator(device=dev).manual_seed(seed)
    looped = looped_noise(n_frames, z0.shape[1:], sigma=noise_sigma, gen=gen, noise=noise).to(dev)

    frames = []
    for n, i in enumerate(range(0, n_frames, batch_size)):
        b = min(batch_size, n_frames - i)
        # the looped noise perturbs the shared starting point; the processor's own draws are alike per batch
        z_in = z0.repeat(b, 1, 1, 1) + 0.1 * looped[i : i + b]
        kw = {"latent": True} if latent_mode else {}
        out = diffusion(z_in if latent_mode else z_in.clamp(-1, 1), prompts, t_start, verbose=False,
                        gen=torch.Generator(device=dev).manual_seed(seed + 1),
                        noise=None if noises is None else noises[n], **kw)
        if latent_mode:
            out = diffusion.decode(out.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        frames.append(out.float().cpu().numpy())
        if verbose:
            print(f"loop frames {i + b}/{n_frames}")
    video = np.concatenate(frames)[:n_frames]
    if cache_path:
        np.save(cache_path, video)
    return video
