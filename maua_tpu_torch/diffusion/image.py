"""Diffusion image pipeline and the `image_sample` entry point.

Port of `maua_tpu/diffusion/image.py` (round64, initialize_image,
get_diffusion_model, MultiResolutionDiffusionProcessor, get_output_name,
image_sample, main) for text-to-image with Stable Diffusion at one size.
Images are NHWC in [-1, 1]. Not ported yet, and raising: schedules of
more than one size (resample, super-resolution between sizes), tiling
(stitching), perlin and file inits, histogram matching, sharpening, the
guided / latent / GLIDE processors and gradient guidance.

    python -m maua_tpu_torch diffusion image --text "a lighthouse" --sizes 512,512 --timesteps 50 --sampler lms
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple, Union
from uuid import uuid4

import torch

from ..ops.io import save_image
from ..prompt import ContentPrompt, ImagePrompt, StylePrompt, TextPrompt
from .processors.base import BaseDiffusionProcessor
from .processors.stable import StableDiffusion


def round64(n: float) -> int:
    return round(n / 64) * 64


def initialize_image(init: Optional[str], shape: Tuple[int, int], gen: torch.Generator) -> torch.Tensor:
    """The starting image (1, H, W, 3) on gen's device: standard normal for "random"."""
    if init == "random":
        return torch.randn((1,) + tuple(shape) + (3,), generator=gen, device=gen.device)
    if init == "perlin" or init is not None:
        raise NotImplementedError(f"init {init!r} is not ported yet; use init='random'")
    raise Exception("init strategy not recognized!")


def get_diffusion_model(
    diffusion: Union[str, BaseDiffusionProcessor] = "stable",
    timesteps: int = 50,
    sampler: str = "lms",
    guidance_speed: str = "fast",
    clip_scale: float = 0.0,
    lpips_scale: float = 0.0,
    style_scale: float = 0.0,
    color_match_scale: float = 0.0,
    cfg_scale: float = 5.0,
    image: Optional[str] = None,
    **model_kwargs,
) -> BaseDiffusionProcessor:
    """The processor for `diffusion`: an instance passes through; "stable"
    builds Stable Diffusion (plms / ddim / p become lms, as in the reference)."""
    if isinstance(diffusion, BaseDiffusionProcessor):
        return diffusion
    if max(clip_scale, lpips_scale, style_scale, color_match_scale) > 0:
        raise NotImplementedError("gradient guidance (clip / lpips / style / color-match scales) is not ported yet")
    if diffusion in ("guided", "latent", "glide", "glid3xl"):
        raise NotImplementedError(f"the {diffusion!r} diffusion processor is not ported yet")
    if diffusion == "stable":
        smplr = sampler if sampler not in ("plms", "ddim", "p") else "lms"
        model_kwargs.setdefault("image_cond", image is not None)
        return StableDiffusion(cfg_scale=cfg_scale, sampler=smplr, timesteps=timesteps, **model_kwargs)
    raise Exception(f"Diffusion model not recognized: {diffusion}")


class MultiResolutionDiffusionProcessor:
    """Runs a diffusion processor over a schedule of sizes; here, one size."""

    def __call__(
        self,
        diffusion: BaseDiffusionProcessor,
        init: Optional[str] = "random",
        text: Optional[str] = None,
        image: Optional[str] = None,
        content: Optional[str] = None,
        style: Optional[str] = None,
        schedule: Optional[Dict[Tuple[int, int], float]] = None,
        pre_hook: Optional[Callable] = None,
        post_hook: Optional[Callable] = None,
        super_res_model: Optional[str] = None,
        tile_size: Optional[int] = None,
        stitch: bool = True,
        max_batch: int = 4,
        verbose: bool = True,
        gen: Optional[torch.Generator] = None,
        noise=None,
        stage_times: Optional[Dict] = None,
    ) -> torch.Tensor:
        schedule = schedule or {(512, 512): 0.5}
        shapes = [(round64(h), round64(w)) for h, w in schedule.keys()]
        t_starts = list(schedule.values())
        if len(shapes) > 1 or super_res_model:
            raise NotImplementedError("schedules of more than one size (resample, super-resolution) are not ported yet")
        tile_size = diffusion.image_size if tile_size is None else tile_size
        if stitch and min(shapes[0]) > tile_size:
            raise NotImplementedError("tiled synthesis (destitch / restitch) is not ported yet")
        if gen is None:
            gen = torch.Generator(device=diffusion.device).manual_seed(0)

        img = initialize_image(init, shapes[0], gen)
        if verbose:
            print(f"Current size: {shapes[0][1]}x{shapes[0][0]}")
        if pre_hook:
            img = pre_hook(img)
        # the content target is the init image at this size (the reference resamples it; here the size is its own)
        content_kwargs = dict(path=content) if content is not None else dict(img=((img + 1.0) / 2.0).cpu().numpy())
        prompts = [ContentPrompt(**content_kwargs)]
        if style is not None:
            prompts.append(StylePrompt(path=style, size=shapes[0]))
        if text is not None:
            prompts.append(TextPrompt(text))
        if image is not None:
            prompts.append(ImagePrompt(path=image))
        img = diffusion(img, prompts, t_starts[0], verbose=verbose, gen=gen, noise=noise, stage_times=stage_times)
        if post_hook:
            img = post_hook(img)
        return img


def get_output_name(text=None, image=None, style=None, init=None, unique=True):
    out_name = str(uuid4())[:6] if unique else "out"
    if text is not None:
        out_name = f"{text.replace(' ', '_')}_{out_name}"
    if image is not None:
        out_name = f"{Path(image).stem}_{out_name}"
    if style is not None:
        out_name = f"{Path(style).stem}_{out_name}"
    if init is not None and init not in ("random", "perlin"):
        out_name = f"{Path(init).stem}_{out_name}"
    return out_name


def image_sample(
    init: str = "random",
    text: Optional[str] = None,
    image: Optional[str] = None,
    content: Optional[str] = None,
    style: Optional[str] = None,
    sizes=((512, 512),),
    skips=(0.0,),
    diffusion: Union[str, BaseDiffusionProcessor] = "stable",
    timesteps: int = 50,
    sampler: str = "lms",
    guidance_speed: str = "fast",
    clip_scale: float = 0.0,
    lpips_scale: float = 0.0,
    style_scale: float = 0.0,
    color_match_scale: float = 0.0,
    cfg_scale: float = 5.0,
    super_res_model: Optional[str] = None,
    tile_size: Optional[int] = None,
    stitch: bool = True,
    max_batch: int = 4,
    match_hist: bool = False,
    sharpness: float = 0.0,
    verbose: bool = True,
    seed: int = 0,
    noise=None,
    stage_times: Optional[Dict] = None,
    **model_kwargs,
) -> torch.Tensor:
    """Text-to-image entry point: (1, H, W, 3) in [-1, 1] on the model's
    device (`device=` in model_kwargs; cuda unless the caller names
    another). Draws come from a torch.Generator seeded with `seed`;
    `noise` (1, H/8, W/8, 4) replaces the latent draw."""
    if match_hist and style is not None:
        raise NotImplementedError("match_hist is not ported yet")
    if sharpness > 0:
        raise NotImplementedError("sharpness is not ported yet")
    model = get_diffusion_model(
        diffusion, timesteps=timesteps, sampler=sampler, guidance_speed=guidance_speed,
        clip_scale=clip_scale, lpips_scale=lpips_scale, style_scale=style_scale,
        color_match_scale=color_match_scale, cfg_scale=cfg_scale, image=image, **model_kwargs,
    )
    schedule = {tuple(s): float(k) for s, k in zip(sizes, list(skips) + [skips[-1]] * (len(sizes) - len(skips)))}
    return MultiResolutionDiffusionProcessor()(
        diffusion=model, init=init, text=text, image=image, content=content, style=style,
        schedule=schedule, super_res_model=super_res_model, tile_size=tile_size, stitch=stitch,
        max_batch=max_batch, verbose=verbose, gen=torch.Generator(device=model.device).manual_seed(seed),
        noise=noise, stage_times=stage_times,
    )


def main(args=None):
    # fmt: off
    parser = argparse.ArgumentParser(description="diffusion image synthesis (Stable Diffusion, text to image)")
    parser.add_argument("--init", default="random", type=str)
    parser.add_argument("--text", default=None, type=str)
    parser.add_argument("--image", default=None, type=str)
    parser.add_argument("--content", default=None, type=str)
    parser.add_argument("--style", default=None, type=str)
    parser.add_argument("--sizes", default="512,512", type=str, help="semicolon-separated h,w pairs")
    parser.add_argument("--skips", default="0", type=str, help="comma-separated t_start per scale")
    parser.add_argument("--diffusion", default="stable", type=str)
    parser.add_argument("--timesteps", default=50, type=int)
    parser.add_argument("--sampler", default="lms", type=str)
    parser.add_argument("--cfg_scale", default=5.0, type=float)
    parser.add_argument("--number", default=1, type=int, help="how many images to render")
    parser.add_argument("--seed", default=0, type=int, help="seed of the random weights and of the first image")
    parser.add_argument("--device", default=None, type=str, help='default "cuda"; "cpu" runs the plain versions')
    parser.add_argument("--out_dir", default="output/", type=str)
    args = parser.parse_args(args)
    # fmt: on

    sizes = [tuple(int(v) for v in s.split(",")) for s in args.sizes.split(";")]
    skips = [float(s) for s in args.skips.split(",")]
    model = get_diffusion_model(args.diffusion, timesteps=args.timesteps, sampler=args.sampler,
                                cfg_scale=args.cfg_scale, image=args.image, device=args.device, seed=args.seed)
    Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    for n in range(args.number):
        img = image_sample(init=args.init, text=args.text, image=args.image, content=args.content, style=args.style,
                           sizes=sizes, skips=skips, diffusion=model, seed=args.seed + n)
        suffix = f"_{n}" if args.number > 1 else ""
        out = f"{args.out_dir}/{get_output_name(args.text, args.image, args.style, args.init)}{suffix}.png"
        save_image(img, out)
        print(out)

