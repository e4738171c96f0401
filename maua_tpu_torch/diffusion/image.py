"""Multi-resolution diffusion image pipeline and the `image_sample` entry point.

Port of `maua_tpu/diffusion/image.py` (round64, initialize_image,
get_diffusion_model, MultiResolutionDiffusionProcessor, get_output_name,
image_sample, main) with Stable Diffusion: a schedule of sizes, each
denoised from its own t_start; between sizes the image is upscaled by a
`super` registry model (skipped if the card runs out of memory) and
lanczos-resampled to the next size; a size larger than the tile is split
into overlapping tiles, denoised in batches of `max_batch` (halved if the
card runs out of memory) and blended back. Random, perlin and file inits;
histogram matching to the style image before and sharpening after each
size. Gradient guidance by CLIP (the text), LPIPS (the init or --content
image), VGG style and colour histograms (the --style image) through the
processor's decoder and model. The processors: Stable Diffusion (text, or
with --image its image-conditioned variant), guided diffusion (OpenAI's
256^2 UNet with the secondary model), latent diffusion, GLIDE and GLID3XL.
Images are NHWC in [-1, 1].

    python -m maua_tpu_torch diffusion image --text "a lighthouse" --sizes 512,512 --timesteps 50 --sampler lms
    python -m maua_tpu_torch diffusion image --text "a lighthouse" --sizes "512,512;1024,1024" --skips 0,0.5 \
        --super_res RealESRGAN-x4plus
    python -m maua_tpu_torch diffusion image --text "a lighthouse" --style s.png --clip_scale 2000 \
        --color_match_scale 500 --timesteps 10
    python -m maua_tpu_torch diffusion image --text "a lighthouse" --diffusion guided --sampler ddim --sizes 256,256 \
        --timesteps 25 --clip_scale 1000 --guidance_speed fast
"""

from __future__ import annotations

import argparse
import time
from functools import partial
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple, Union
from uuid import uuid4

import torch

from ..grad import CLIPGrads, ColorMatchGrads, LPIPSGrads, VGGGrads
from ..oom import is_oom_error
from ..ops.image import destitch, match_histogram, resample, restitch, sharpen
from ..ops.io import load_image, save_image
from ..ops.noise import create_perlin_noise
from ..ops.warp import resize
from ..prompt import ContentPrompt, ImagePrompt, StylePrompt, TextPrompt
from ..utility import resolve_device
from .processors.base import BaseDiffusionProcessor
from .processors.stable import StableDiffusion


def round64(n: float) -> int:
    return round(n / 64) * 64


def initialize_image(init: Optional[str], shape: Tuple[int, int], gen: torch.Generator) -> torch.Tensor:
    """The starting image (1, H, W, 3) in about [-1, 1] on gen's device:
    standard normal for "random"; for "perlin" a colour perlin image (4096^2)
    plus a grey one (1024^2), each bicubic-resized to the size; otherwise the
    image file `init`, lanczos-resampled to the size."""
    h, w = shape
    if init == "random":
        return torch.randn((1, h, w, 3), generator=gen, device=gen.device)
    if init == "perlin":
        col = create_perlin_noise(gen, [1.5**-i * 0.5 for i in range(12)], 1, 1, grayscale=False)
        gray = create_perlin_noise(gen, [1.5**-i * 0.5 for i in range(8)], 4, 4, grayscale=True)
        col, gray = (resize(n.permute(2, 0, 1)[None], (h, w), "bicubic") for n in (col, gray))
        return (col + gray - 1.0).permute(0, 2, 3, 1)
    if init is not None:
        img = torch.as_tensor(load_image(init) * 2.0 - 1.0, device=gen.device)
        return resample(img, (h, w))
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
    builds Stable Diffusion (plms / ddim / p become lms, as in the reference;
    with `image`, the image-conditioned variant), "guided" guided diffusion
    (`guidance_speed` "fast" or "hyper"), "latent" latent diffusion (plms or
    ddim), "glide" GLIDE's base and upsampler (DDIM), "glid3xl" latent
    diffusion conditioned by BERT (`sampler` as for "latent"). For "guided",
    "stable" and "glid3xl", a scale above 0 adds its grad module, with random
    perceptor weights on the processor's device. "latent" and "glide" take no
    grad modules from the scales, as in the reference, so they refuse a scale
    above 0 (pass `grad_modules` to LatentDiffusion instead)."""
    if isinstance(diffusion, BaseDiffusionProcessor):
        return diffusion
    scales = dict(clip_scale=clip_scale, lpips_scale=lpips_scale, style_scale=style_scale,
                  color_match_scale=color_match_scale)

    def grad_modules():
        if not any(s > 0 for s in scales.values()):
            return []
        device = resolve_device(model_kwargs.get("device"))
        return (([CLIPGrads(scale=clip_scale, device=device)] if clip_scale > 0 else [])
                + ([LPIPSGrads(scale=lpips_scale, device=device)] if lpips_scale > 0 else [])
                + ([VGGGrads(scale=style_scale, device=device)] if style_scale > 0 else [])
                + ([ColorMatchGrads(scale=color_match_scale, device=device)] if color_match_scale > 0 else []))

    if diffusion == "guided":
        from .processors.guided import GuidedDiffusion

        return GuidedDiffusion(grad_modules=grad_modules(), sampler=sampler, timesteps=timesteps,
                               speed=guidance_speed, **model_kwargs)
    if diffusion in ("latent", "glide") and any(s > 0 for s in scales.values()):
        raise ValueError(f"{diffusion} diffusion takes no guidance scales, got "
                         f"{[k for k, v in scales.items() if v > 0]}"
                         + ("; pass grad_modules to LatentDiffusion" if diffusion == "latent" else ""))
    if diffusion == "latent":
        from .processors.latent import LatentDiffusion

        smplr = sampler if sampler in ("plms", "ddim") else "plms"
        return LatentDiffusion(cfg_scale=cfg_scale, sampler=smplr, timesteps=timesteps, **model_kwargs)
    if diffusion == "glide":
        from .processors.glide import GLIDE

        return GLIDE(cfg_scale=cfg_scale, timesteps=timesteps, **model_kwargs)
    if diffusion == "glid3xl":
        from .processors.glide import GLID3XL

        smplr = sampler if sampler in ("plms", "ddim") else "plms"
        return GLID3XL(grad_modules=grad_modules(), cfg_scale=cfg_scale, sampler=smplr, timesteps=timesteps,
                       **model_kwargs)
    if diffusion == "stable":
        smplr = sampler if sampler not in ("plms", "ddim", "p") else "lms"
        model_kwargs.setdefault("image_cond", image is not None)
        return StableDiffusion(grad_modules=grad_modules(), cfg_scale=cfg_scale, sampler=smplr, timesteps=timesteps,
                               **model_kwargs)
    raise Exception(f"Diffusion model not recognized: {diffusion}")


def _timed(stage_times: Optional[Dict], name: str, device: torch.device, fn: Callable):
    """fn(); with `stage_times`, wait for the device and add its seconds to `name`."""
    if stage_times is None:
        return fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stage_times[name] = stage_times.get(name, 0.0) + time.perf_counter() - t0
    return out


class MultiResolutionDiffusionProcessor:
    """Runs a diffusion processor over a schedule of sizes."""

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
        """`schedule` maps each size (h, w) to its t_start. Draws come from
        `gen`; `noise` is a latent (B, h, w, z), or a list of them, one for
        each call of the processor in order (each size, or each batch of
        tiles), in place of its draw. `stage_times` collects the
        processor's stages and super_res, resample and stitch seconds."""
        schedule = schedule or {(512, 512): 0.5}
        shapes = [(round64(h), round64(w)) for h, w in schedule.keys()]
        t_starts = list(schedule.values())
        tile_size = diffusion.image_size if tile_size is None else tile_size
        if gen is None:
            gen = torch.Generator(device=diffusion.device).manual_seed(0)
        noises = list(noise) if isinstance(noise, (list, tuple)) else [noise]
        device = gen.device

        img = initialize_image(init, shapes[0], gen)
        # content guidance is anchored to the first size's init image at every size
        init_content = (img + 1.0) / 2.0

        for scale, t_start in enumerate(t_starts):
            if verbose:
                print(f"Current size: {shapes[scale][1]}x{shapes[scale][0]}")
            if scale != 0:
                if super_res_model:
                    from ..super.image import upscale_image

                    try:
                        img = _timed(stage_times, "super_res", device, lambda: upscale_image(
                            (img + 1) / 2, model_name=super_res_model, device=img.device) * 2 - 1)
                    except Exception as e:
                        # skip super-resolution if the card runs out of memory; the
                        # resample below still reaches the size
                        if not is_oom_error(e):
                            raise
                        print("device OOM during super-resolution; continuing without it")
                img = _timed(stage_times, "resample", device, lambda: resample(img, shapes[scale]))

            if pre_hook:
                img = pre_hook(img)

            needs_stitching = stitch and min(shapes[scale]) > tile_size
            if needs_stitching:
                img = _timed(stage_times, "stitch", device, lambda: destitch(img, tile_size=tile_size))

            prompts = []
            if not needs_stitching:
                prompts.append(ContentPrompt(path=content) if content is not None else
                               ContentPrompt(img=resample(init_content, shapes[scale]).cpu().numpy()))
            if style is not None:
                prompts.append(StylePrompt(path=style, size=shapes[scale]))
            if text is not None:
                prompts.append(TextPrompt(text))
            if image is not None:
                prompts.append(ImagePrompt(path=image))

            def denoise(batch, verbose):
                out = diffusion(batch, prompts, t_start, verbose=verbose, gen=gen, noise=noises[0] if noises else None,
                                stage_times=stage_times)
                del noises[:1]
                return out

            if img.shape[0] > max_batch:
                outs = []
                i = 0
                while i < img.shape[0]:
                    try:
                        outs.append(denoise(img[i : i + max_batch], False))
                    except Exception as e:
                        # halve the tile batch if the card runs out of memory, and retry
                        if not is_oom_error(e) or max_batch <= 1:
                            raise
                        max_batch = max(max_batch // 2, 1)
                        print(f"device OOM during tile batch; retrying with max_batch={max_batch}")
                        continue
                    i += max_batch
                img = torch.cat(outs)
            else:
                img = denoise(img, verbose)

            if needs_stitching:
                img = _timed(stage_times, "stitch", device, lambda: restitch(img, *shapes[scale]))

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
    `noise` replaces the latent draws (see MultiResolutionDiffusionProcessor).
    `match_hist` matches the image's colours to the --style image before
    each size; `sharpness` > 0 sharpens after each size."""
    model = get_diffusion_model(
        diffusion, timesteps=timesteps, sampler=sampler, guidance_speed=guidance_speed,
        clip_scale=clip_scale, lpips_scale=lpips_scale, style_scale=style_scale,
        color_match_scale=color_match_scale, cfg_scale=cfg_scale, image=image, **model_kwargs,
    )
    pre_hook = None
    if match_hist and style is not None:
        style_img = torch.as_tensor(StylePrompt(path=style).img, device=model.device)  # already [-1, 1]
        pre_hook = lambda img: match_histogram(img, style_img)  # noqa: E731
    post_hook = partial(sharpen, strength=sharpness) if sharpness > 0 else None
    schedule = {tuple(s): float(k) for s, k in zip(sizes, list(skips) + [skips[-1]] * (len(sizes) - len(skips)))}
    return MultiResolutionDiffusionProcessor()(
        diffusion=model, init=init, text=text, image=image, content=content, style=style,
        schedule=schedule, super_res_model=super_res_model, tile_size=tile_size, stitch=stitch,
        max_batch=max_batch, pre_hook=pre_hook, post_hook=post_hook, verbose=verbose,
        gen=torch.Generator(device=model.device).manual_seed(seed), noise=noise, stage_times=stage_times,
    )


def main(args=None):
    # fmt: off
    parser = argparse.ArgumentParser(description="diffusion image synthesis (stable, guided and latent diffusion)")
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
    parser.add_argument("--guidance_speed", default="fast", type=str)
    parser.add_argument("--clip_scale", default=0.0, type=float)
    parser.add_argument("--lpips_scale", default=0.0, type=float)
    parser.add_argument("--style_scale", default=0.0, type=float)
    parser.add_argument("--color_match_scale", default=0.0, type=float)
    parser.add_argument("--cfg_scale", default=5.0, type=float)
    parser.add_argument("--super_res", default=None, type=str, help="a super registry model to upscale between sizes")
    parser.add_argument("--tile_size", default=None, type=int)
    parser.add_argument("--stitch", action=argparse.BooleanOptionalAction, default=True,
                        help="tiled synthesis of images larger than --tile_size")
    parser.add_argument("--max_batch", default=4, type=int)
    parser.add_argument("--match_hist", action="store_true",
                        help="match the init histogram to the --style image before each scale")
    parser.add_argument("--sharpness", default=0.0, type=float,
                        help="sharpen after each diffusion scale (0 disables, 1.0 leaves unchanged)")
    parser.add_argument("--number", default=1, type=int, help="how many images to render")
    parser.add_argument("--seed", default=0, type=int, help="seed of the random weights and of the first image")
    parser.add_argument("--device", default=None, type=str, help='default "cuda"; "cpu" runs the plain versions')
    parser.add_argument("--out_dir", default="output/", type=str)
    args = parser.parse_args(args)
    # fmt: on

    sizes = [tuple(int(v) for v in s.split(",")) for s in args.sizes.split(";")]
    skips = [float(s) for s in args.skips.split(",")]
    model = get_diffusion_model(args.diffusion, timesteps=args.timesteps, sampler=args.sampler,
                                guidance_speed=args.guidance_speed, clip_scale=args.clip_scale,
                                lpips_scale=args.lpips_scale, style_scale=args.style_scale,
                                color_match_scale=args.color_match_scale, cfg_scale=args.cfg_scale,
                                image=args.image, device=args.device, seed=args.seed)
    Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    for n in range(args.number):
        img = image_sample(init=args.init, text=args.text, image=args.image, content=args.content, style=args.style,
                           sizes=sizes, skips=skips, diffusion=model, super_res_model=args.super_res,
                           tile_size=args.tile_size, stitch=args.stitch, max_batch=args.max_batch,
                           match_hist=args.match_hist, sharpness=args.sharpness, seed=args.seed + n)
        suffix = f"_{n}" if args.number > 1 else ""
        out = f"{args.out_dir}/{get_output_name(args.text, args.image, args.style, args.init)}{suffix}.png"
        save_image(img, out)
        print(out)

