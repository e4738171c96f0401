"""Latent interpolation video: a spline or slerp path through the latents of
input images, optionally renoised and denoised, decoded in batches.

Port of `maua_tpu/diffusion/interpolate.py` (interpolate_latents, main).
The images are encoded by the processor's VAE; `loop` closes the path
through the first latent again (natural cubic spline or slerp loops, as
`audio/latent.py` makes them); otherwise the path runs open from the first
image to the last by slerp, segment after segment. With `renoise_t` each
batch of path latents is partially renoised and denoised by the processor
before decoding.

    python -m maua_tpu_torch diffusion interpolate a.png b.png --n_frames 64 --renoise_t 0.5
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..audio.latent import slerp, slerp_loops, spline_loops
from ..ops.io import load_image


def interpolate_latents(
    diffusion,
    images: List,
    n_frames: int = 64,
    method: str = "spline",
    loop: bool = True,
    batch_size: int = 8,
    renoise_t: Optional[float] = None,
    gen: Optional[torch.Generator] = None,
    noises: Optional[Sequence] = None,
) -> np.ndarray:
    """Encode the images (paths, PIL images or arrays in [0, 1]), interpolate
    their latents along the path, optionally renoise and denoise each batch
    (from `renoise_t`; the renoising draws come from `gen`, or from `noises`,
    one NHWC latent per batch), decode. Returns (n_frames, H, W, 3) in [-1, 1]."""
    dev = diffusion.device
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    latents = torch.cat([diffusion.encode(torch.as_tensor(load_image(im) * 2 - 1, device=dev).permute(0, 3, 1, 2))
                         for im in images]).permute(0, 2, 3, 1)  # (K, h, w, z)
    k, h, w, c = latents.shape
    flat = latents.reshape(k, 1, h * w * c)
    if loop:
        path = (spline_loops if method == "spline" else slerp_loops)(flat, n_frames, 1)
    else:  # open path A -> B -> ... -> K (no wrap back to the first image)
        n_seg = k - 1
        t = torch.linspace(0.0, n_seg, n_frames, device=dev)
        seg = t.int().clamp(0, n_seg - 1)
        frac = t - seg
        segments = [slerp(flat[i : i + 1], flat[i + 1 : i + 2], frac)[:, 0] for i in range(n_seg)]
        path = torch.stack([segments[int(s)][j] for j, s in enumerate(seg.tolist())])
    path = path.reshape(n_frames, h, w, c)

    frames = []
    for n, i in enumerate(range(0, n_frames, batch_size)):
        z = path[i : i + batch_size]
        if renoise_t is not None:
            z = diffusion(z, [], renoise_t, latent=True, gen=gen, noise=None if noises is None else noises[n])
        frames.append(diffusion.decode(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float().cpu().numpy())
    return np.concatenate(frames)


def main(args=None):
    from ..ops.video import write_video
    from .image import get_diffusion_model

    parser = argparse.ArgumentParser(description="latent interpolation video between input images")
    parser.add_argument("images", nargs="+", type=str)
    parser.add_argument("--n_frames", default=64, type=int)
    parser.add_argument("--method", default="spline", choices=["spline", "slerp"])
    parser.add_argument("--no_loop", action="store_true")
    parser.add_argument("--renoise_t", default=None, type=float,
                        help="partially renoise+denoise each interpolated latent")
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--fps", default=12, type=float)
    parser.add_argument("--timesteps", default=50, type=int)
    parser.add_argument("--seed", default=0, type=int, help="seed of the random weights and of the renoising")
    parser.add_argument("--device", default=None, type=str, help='default "cuda"; "cpu" runs the plain versions')
    parser.add_argument("--out_dir", default="output/", type=str)
    args = parser.parse_args(args)

    Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    diffusion = get_diffusion_model("stable", timesteps=args.timesteps, device=args.device, seed=args.seed)
    frames = interpolate_latents(
        diffusion, args.images, n_frames=args.n_frames, method=args.method, loop=not args.no_loop,
        batch_size=args.batch_size, renoise_t=args.renoise_t,
        gen=torch.Generator(device=diffusion.device).manual_seed(args.seed),
    )
    stem = "_".join(Path(im).stem for im in args.images[:3])
    out_file = f"{args.out_dir}/{stem}_interp.mp4"
    write_video(frames, out_file, fps=args.fps, value_range=(-1, 1))
    print(out_file)
    return 0


if __name__ == "__main__":
    main()
