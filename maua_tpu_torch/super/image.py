"""Image super-resolution: the model registry, the `Upscaler` with its tiled
inference and out-of-memory ladder, and the upscale entry points.

Port of `maua_tpu/super/image.py` (MODEL_REGISTRY, Upscaler, load_model,
upscale, upscale_image, compare, main). Images are NHWC in [0, 1] at the
API, as in maua_tpu; the models run NCHW. A checkpoint is looked up by
its published file name in `MODELZOO` (`MAUA_MODELZOO`): basicsr /
realesrgan `.pth` (a `params_ema` or `params` container or a bare state
dict), the official SwinIR `.pth`, waifu2x `.json`. As in the reference,
a checkpoint that fails to load prints a warning and the model runs
random weights (drawn from `seed`). Not ported yet, and raising: the
`latent-diffusion` entry (it waits for `diffusion/processors/latent.py`)
and `upscale_bulk_sharded` (it waits for `parallel/*`).

    python -m maua_tpu_torch super image in.png --model_name RealESRGAN-x4plus --out_dir output/
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Generator, Iterable, Optional

import numpy as np
import torch

from .. import utility
from ..oom import run_with_oom_fallback
from ..ops.image import destitch, resample, restitch
from ..ops.io import load_image, tensor2img
from ..utility import resolve_device, to_device
from .models import rrdbnet, swinir, waifu

# model name -> (architecture kind, config), the reference's registry
MODEL_REGISTRY = {
    "latent-diffusion": ("ldm", None),
    "RealESRGAN-x4plus": ("rrdb", rrdbnet.RRDBConfig()),
    "RealESRGAN-x4plus-anime": ("rrdb", rrdbnet.RRDBConfig(num_block=6)),
    "RealESRGAN-xsx4-animevideo": ("srvgg", rrdbnet.SRVGGConfig()),
    "RealESRGAN-pbaylies-wikiart": ("rrdb", rrdbnet.RRDBConfig()),
    "RealESRGAN-pbaylies-hr-paintings": ("rrdb", rrdbnet.RRDBConfig()),
    "SwinIR-L-DFOWMFC-GAN": ("swinir", swinir.SWINIR_L),
    "SwinIR-L-DFOWMFC-PSNR": ("swinir", swinir.SWINIR_L),
    "SwinIR-M-DFO-GAN": ("swinir", swinir.SWINIR_M),
    "SwinIR-M-DFO-PSNR": ("swinir", swinir.SWINIR_M),
    **{f"waifu2x-{w}-noise{n}": ("upconv7", waifu.UpConv7Config()) for w in ("anime", "photo") for n in range(4)},
    "CARN": ("carn", waifu.CARNConfig()),
    "BSRGAN": ("rrdb", rrdbnet.RRDBConfig()),
    "RealSR": ("rrdb", rrdbnet.RRDBConfig()),
}
MODEL_NAMES = list(MODEL_REGISTRY.keys())

_CHECKPOINT_FILES = {
    "RealESRGAN-x4plus": "RealESRGAN_x4plus.pth",
    "RealESRGAN-x4plus-anime": "RealESRGAN_x4plus_anime_6B.pth",
    "RealESRGAN-xsx4-animevideo": "RealESRGANv2-animevideo-xsx4.pth",
    "RealESRGAN-pbaylies-wikiart": "wikiart_g.pth",
    "RealESRGAN-pbaylies-hr-paintings": "hr-paintings_g.pth",
    "SwinIR-L-DFOWMFC-GAN": "SwinIR-L-DFOWMFC-GAN.pth",
    "SwinIR-L-DFOWMFC-PSNR": "SwinIR-L-DFOWMFC-PSNR.pth",
    "SwinIR-M-DFO-GAN": "SwinIR-M-DFO-GAN.pth",
    "SwinIR-M-DFO-PSNR": "SwinIR-M-DFO-PSNR.pth",
    **{f"waifu2x-{w}-noise{n}": f"waifu2x/{w}/noise{n}_scale2.0x_model.json"
       for w in ("anime", "photo") for n in range(4)},
    "CARN": "CARN_model_checkpoint.pt",
    "BSRGAN": "BSRGAN.pth",
    "RealSR": "RealSR.pth",
}

_INIT_FNS = {
    "rrdb": rrdbnet.init_params,
    "srvgg": rrdbnet.init_srvgg_params,
    "swinir": swinir.init_params,
    "upconv7": lambda gen, cfg: waifu.init_upconv7_params(gen),
    "carn": waifu.init_carn_params,
}
_FWD_FNS = {
    "rrdb": rrdbnet.forward,
    "srvgg": rrdbnet.srvgg_forward,
    "swinir": swinir.forward,
    "upconv7": waifu.upconv7_forward,
    "carn": waifu.carn_forward,
}


class Upscaler:
    """A registry model on `device` (cuda unless the caller names another).

    Parameters come from `params` (the port's layout) when given, else from
    the model's checkpoint in MODELZOO, else are drawn from `seed`."""

    def __init__(self, model_name: str = "RealESRGAN-x4plus", tile: int = 0, tile_overlap: int = 1, device=None,
                 seed: int = 0, params=None):
        if model_name not in MODEL_REGISTRY:
            raise ValueError(f"unknown model {model_name}; options: {MODEL_NAMES}")
        self.kind, self.cfg = MODEL_REGISTRY[model_name]
        if self.kind == "ldm":
            raise NotImplementedError("the latent-diffusion upscaler needs maua_tpu's diffusion/processors/latent.py, "
                                      "which is not ported yet")
        self.tile = tile
        self.tile_overlap = tile_overlap
        self.device = resolve_device(device)
        if params is None:
            ckpt = os.path.join(utility.MODELZOO, _CHECKPOINT_FILES.get(model_name, ""))
            if os.path.exists(ckpt):
                params = self._load_checkpoint(ckpt)
        if params is None:
            params = _INIT_FNS[self.kind](torch.Generator(device=self.device).manual_seed(seed), self.cfg)
        self.params = to_device(params, self.device)
        self._run_params = rrdbnet.prepare(self.params, self.cfg) if self.kind == "rrdb" else self.params
        self._fwd = _FWD_FNS[self.kind]

    def _load_checkpoint(self, path: str):
        try:
            if self.kind == "upconv7" and path.endswith(".json"):
                return waifu.upconv7_params_from_json(path)
            obj = torch.load(path, map_location="cpu", weights_only=True)
            sd = obj.get("params_ema", obj.get("params", obj)) if isinstance(obj, dict) else obj
            if self.kind == "rrdb":
                return rrdbnet.params_from_torch(sd, self.cfg)
            if self.kind == "swinir":
                return swinir.params_from_torch(sd, self.cfg)
            if self.kind == "upconv7":
                return waifu.upconv7_params_from_torch(sd)
            if self.kind == "srvgg":
                return rrdbnet.srvgg_params_from_torch(sd, self.cfg)
            print(f"warning: no checkpoint converter for kind {self.kind!r} — running RANDOM-INIT weights")
        except Exception as e:  # noqa: BLE001 - the reference's tolerant cascade
            print(f"checkpoint load failed ({e}); using random init")
        return None

    @property
    def scale(self) -> int:
        if self.kind in ("srvgg", "swinir"):
            return self.cfg.upscale
        return self.cfg.scale  # rrdb / upconv7 / carn

    def _run(self, img: torch.Tensor) -> torch.Tensor:
        """NHWC in, NHWC out; SwinIR's input is mirror-padded to its window
        multiple and the output cropped back."""
        x = img.permute(0, 3, 1, 2)
        h, w = x.shape[2], x.shape[3]
        if self.kind == "swinir":
            ws = self.cfg.window_size
            hp, wp = (-h) % ws, (-w) % ws
            if hp or wp:
                x = torch.cat([x, x.flip(2)], 2)[:, :, : h + hp]
                x = torch.cat([x, x.flip(3)], 3)[:, :, :, : w + wp]
        out = self._fwd(self._run_params, x, self.cfg)[:, :, : h * self.scale, : w * self.scale]
        return out.permute(0, 2, 3, 1)

    @torch.no_grad()
    def __call__(self, img) -> torch.Tensor:
        """img (B, H, W, C) in [0, 1] (array or tensor) -> the upscaled images
        in [0, 1], f32 on this upscaler's device.

        Out of memory, it walks the reference's ladder: smaller tiles, and
        last a lanczos upscale without the model."""
        if isinstance(img, torch.Tensor):
            img = img.to(device=self.device, dtype=torch.float32)
        else:
            img = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        h, w = img.shape[1], img.shape[2]

        def tiled(tile):
            def thunk():
                tiles = destitch(img, tile_size=tile, overtile=self.tile_overlap)
                up = restitch(self._run(tiles), h * self.scale, w * self.scale, overtile=self.tile_overlap,
                              scale=self.scale)
                return torch.clamp(up, 0, 1)

            return thunk

        if self.tile and min(h, w) > self.tile:
            attempts = [(f"tile {self.tile}", tiled(self.tile))]
            t = self.tile // 2
        else:
            attempts = [("full image", lambda: torch.clamp(self._run(img), 0, 1))]
            t = min(h, w) // 2
        while t >= 64:
            attempts.append((f"tile {t}", tiled(t)))
            t //= 2
        attempts.append(("lanczos-only fallback",
                         lambda: torch.clamp(resample(img, (h * self.scale, w * self.scale)), 0, 1)))
        return run_with_oom_fallback(attempts)


def load_model(model_name: str = "RealESRGAN-x4plus", **kw) -> Upscaler:
    return Upscaler(model_name, **kw)


def upscale(images: Iterable, model_name: str = "RealESRGAN-x4plus", model: Optional[Upscaler] = None,
            **kw) -> Generator[np.ndarray, None, None]:
    """Generator over upscaled images: paths, PIL images or arrays in, (1,
    H*scale, W*scale, C) numpy arrays in [0, 1] out."""
    model = model or Upscaler(model_name, **kw)
    for img in images:
        yield model(load_image(img)).cpu().numpy()


def upscale_image(image, model_name: str = "RealESRGAN-x4plus", model: Optional[Upscaler] = None, **kw):
    """One image (a path, or (B, H, W, C) in [0, 1]) -> the upscaled tensor."""
    model = model or Upscaler(model_name, **kw)
    return model(load_image(image) if isinstance(image, (str, Path)) else image)


def upscale_bulk_sharded(images: Iterable, model_name: str = "RealESRGAN-x4plus", batch_size: int = 8, mesh=None):
    raise NotImplementedError("upscale_bulk_sharded needs maua_tpu's parallel/* (the device mesh), "
                              "which is not ported yet; use upscale")


def compare(image, model_names=None, out_dir: str = "output/comparison", **kw):
    """Run every (or the selected) registered model on one image; writes one
    PNG per model and returns {name: array}."""
    results = {}
    os.makedirs(out_dir, exist_ok=True)
    arr = load_image(image) if isinstance(image, (str, Path)) else np.asarray(image)
    for name in model_names or MODEL_NAMES:
        out = Upscaler(name, **kw)(arr).cpu().numpy()
        results[name] = out
        tensor2img(out).save(f"{out_dir}/{name}.png")
    return results


def main(args=None):
    parser = argparse.ArgumentParser(description="image super-resolution")
    parser.add_argument("images", nargs="+")
    parser.add_argument("--model_name", default="RealESRGAN-x4plus", choices=MODEL_NAMES)
    parser.add_argument("--out_dir", default="output/")
    parser.add_argument("--tile", default=0, type=int)
    parser.add_argument("--postdownsample", default=1, type=int)
    parser.add_argument("--comparison", action="store_true",
                        help="run every registered model on each image (the reference's comparison subcommand)")
    parser.add_argument("--models", nargs="*", default=None, help="restrict --comparison to these registry names")
    parser.add_argument("--device", default=None, type=str, help='default "cuda"; "cpu" runs on the CPU')
    args = parser.parse_args(args)

    if args.comparison:
        for path in args.images:
            out_dir = f"{args.out_dir}/{Path(path).stem}_comparison"
            compare(path, model_names=args.models, out_dir=out_dir, tile=args.tile, device=args.device)
            print(out_dir)
        return

    os.makedirs(args.out_dir, exist_ok=True)
    model = Upscaler(args.model_name, tile=args.tile, device=args.device)
    for path in args.images:
        out_path = f"{args.out_dir}/{Path(path).stem}_{args.model_name}.png"
        if os.path.exists(out_path):
            continue
        im = tensor2img(model(load_image(path)))
        if args.postdownsample > 1:
            im = im.resize((im.size[0] // args.postdownsample, im.size[1] // args.postdownsample))
        im.save(out_path)
        print(out_path)
