"""Outpainting: extend an image's borders with colour-matched noise and
partially denoise the whole canvas.

Port of `maua_tpu/diffusion/outpaint.py` (sliced_optimal_transport,
outpaint, main). The border noise is matched to the image's colour
distribution by sliced optimal transport (1-D matching of sorted
projections along random unit directions); the processor then denoises the
canvas from `t_start`, and the original interior is kept verbatim.

    python -m maua_tpu_torch diffusion outpaint in.png "a lighthouse" --expand 64,64,64,64 --t_start 0.4
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..prompt import TextPrompt


def sliced_optimal_transport(source: torch.Tensor, target: torch.Tensor, n_slices: int = 32,
                             gen: Optional[torch.Generator] = None, directions=None) -> torch.Tensor:
    """Match the source's pixels (..., C) to the target's distribution along
    `n_slices` random directions in turn: each direction's sorted source
    projections move onto the target's sorted projections, linearly resampled
    to the source's count. The directions are standard normal draws from
    `gen`, or `directions` (n_slices, C), normalized here."""
    c = source.shape[-1]
    src = source.reshape(-1, c).float()
    tgt = target.reshape(-1, c).float().to(src.device)
    n, m = src.shape[0], tgt.shape[0]
    if directions is None:
        directions = torch.randn((n_slices, c), generator=gen, device=src.device)
    directions = torch.as_tensor(np.asarray(directions) if not isinstance(directions, torch.Tensor) else directions,
                                 dtype=torch.float32, device=src.device)
    pos = torch.linspace(0, m - 1, n, device=src.device)
    lo = pos.floor().long()
    hi = (lo + 1).clamp_max(m - 1)
    frac = pos - lo
    for d in directions:
        d = d / torch.linalg.norm(d)
        proj_s, proj_t = src @ d, tgt @ d
        sorted_s, idx_s = torch.sort(proj_s)
        sorted_t = torch.sort(proj_t).values
        interp_t = sorted_t[lo] * (1 - frac) + sorted_t[hi] * frac
        delta = torch.zeros(n, device=src.device).index_put((idx_s,), interp_t - sorted_s)
        src = src + delta[:, None] * d[None, :]
    return src.reshape(source.shape)


def outpaint(
    diffusion,
    img,  # (1, H, W, 3) in [-1, 1]
    expand: Tuple[int, int, int, int] = (64, 64, 64, 64),  # left, right, top, bottom
    text: Optional[str] = None,
    t_start: float = 0.4,
    noise_scale: float = 0.8,
    gen: Optional[torch.Generator] = None,
    border_noise=None,
    directions=None,
    **diffusion_kwargs,
) -> torch.Tensor:
    """Pad the borders with colour-matched noise (noise_scale times a standard
    normal canvas, `border_noise` (1, H', W', 3) or a draw from `gen`; the
    transport's directions as in `sliced_optimal_transport`), partially
    denoise the canvas (the processor's own keyword arguments pass through,
    such as `noise`), and keep the interior. Returns (1, H', W', 3) on the
    processor's device."""
    dev = diffusion.device
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    img = torch.as_tensor(np.asarray(img) if not isinstance(img, torch.Tensor) else img, device=dev).float()
    l, r, t, b = expand
    _, h, w, c = img.shape
    shape = (1, h + t + b, w + l + r, c)
    canvas = torch.zeros(shape, device=dev)
    canvas[:, t : t + h, l : l + w] = img
    noise = torch.randn(shape, generator=gen, device=dev) if border_noise is None else \
        torch.as_tensor(np.asarray(border_noise), dtype=torch.float32, device=dev)
    noise = sliced_optimal_transport(noise_scale * noise, img, gen=gen, directions=directions)
    mask = torch.zeros(shape[:3] + (1,), device=dev)
    mask[:, t : t + h, l : l + w] = 1.0
    canvas = canvas * mask + noise * (1 - mask)
    out = diffusion(canvas, [TextPrompt(text)] if text else [], t_start, gen=gen, **diffusion_kwargs)
    return out * (1 - mask) + canvas * mask


def main(args=None):
    from ..ops.io import save_image
    from ..prompt import ImagePrompt
    from .image import get_diffusion_model

    parser = argparse.ArgumentParser(description="diffusion outpainting")
    parser.add_argument("init", type=str, help='image path, or "none" to synthesize from the prompt')
    parser.add_argument("text", type=str)
    parser.add_argument("--t_start", default=0.4, type=float)
    parser.add_argument("--expand", default="64,64,64,64", type=str, help="left,right,top,bottom pixels")
    parser.add_argument("--size", default=512, type=int, help='seed image size when init is "none"')
    parser.add_argument("--sampler", default="euler_ancestral", type=str)
    parser.add_argument("--timesteps", default=50, type=int)
    parser.add_argument("--seed", default=0, type=int, help="seed of the random weights and of the draws")
    parser.add_argument("--device", default=None, type=str, help='default "cuda"; "cpu" runs the plain versions')
    parser.add_argument("--out_dir", default="output/", type=str)
    args = parser.parse_args(args)

    Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    diffusion = get_diffusion_model("stable", sampler=args.sampler, timesteps=args.timesteps, device=args.device,
                                    seed=args.seed)
    gen = torch.Generator(device=diffusion.device).manual_seed(args.seed)
    out_name = args.text.replace(" ", "_")
    if args.init == "none":
        img = diffusion(torch.zeros((1, args.size, args.size, 3)), [TextPrompt(args.text)], 0.0, gen=gen)
        save_image(img, f"{args.out_dir}/{out_name}.png")
    else:
        out_name = f"{Path(args.init).stem}_{out_name}"
        img = ImagePrompt(path=args.init).img
    expand = tuple(int(s) for s in args.expand.split(","))
    out = outpaint(diffusion, img, expand=expand, text=args.text, t_start=args.t_start, gen=gen)
    out_file = f"{args.out_dir}/outpainted_{out_name}.png"
    save_image(out, out_file)
    print(out_file)
    return 0


if __name__ == "__main__":
    main()
