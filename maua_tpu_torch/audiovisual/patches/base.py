"""Patch base classes: user-written recipes that map audio onto a GAN's inputs.

Port of `maua_tpu/audiovisual/patches/base.py` (MauaPatch with
`force_output_size`, StyleGAN2Patch, StyleGAN3Patch, get_patch_from_file).
A patch holds the audio as a tensor on its device and produces per-frame
synthesizer inputs. `process_outputs(video)` gets each render batch as a (B, H, W, C)
tensor in [-1, 1], the layout of maua_tpu.
"""

from __future__ import annotations

import importlib.util
import inspect
import sys
from pathlib import Path
from typing import Optional, Tuple

import torch

from ...audio.io import load_audio
from ...gan.stylegan3 import SG3Config, StyleGAN3
from ...gan.wrappers import StyleGAN2
from ...ops import warp as W
from ...utility import resolve_device


class MauaPatch:
    def __init__(self, audio_file: str, fps: float = 24, offset: float = 0, duration: float = -1, device=None):
        self.device = resolve_device(device)
        self.fps = fps
        self.audio_file = audio_file
        audio, self.sr, self.duration = load_audio(audio_file, offset, duration)
        self.audio = torch.from_numpy(audio).to(self.device)
        self.n_frames = round(self.duration * self.fps)

    def process_audio(self):
        pass

    def force_output_size(self, video: torch.Tensor) -> torch.Tensor:
        """Frames (T, H, W, C), floating point, resized to the synthesizer's
        output size (W, H) as jax.image.resize's antialiased lanczos3 does."""
        _, h, w, _ = video.shape
        out_w, out_h = self.synthesizer_output_size
        if (w, h) != (out_w, out_h):
            video = W.resize(video.permute(0, 3, 1, 2), (out_h, out_w), "lanczos3").permute(0, 2, 3, 1)
        return video


class StyleGAN2Patch(MauaPatch):
    def __init__(
        self,
        model_file: Optional[str],
        audio_file: str,
        fps: float = 24,
        offset: float = 0,
        duration: float = -1,
        output_size: Tuple[int, int] = (1024, 1024),
        resize_strategy: str = "stretch",
        resize_layer: int = 0,
        device=None,
        **stylegan_kwargs,
    ):
        super().__init__(audio_file, fps, offset, duration, device)
        self.stylegan2 = StyleGAN2(model_file, output_size, resize_strategy, resize_layer, device=self.device,
                                   **stylegan_kwargs)
        self.mapper = self.stylegan2.mapper
        self.synthesizer = self.stylegan2.synthesizer
        self.synthesizer_output_size = output_size

    def process_mapper_inputs(self):
        return {"latent_z": torch.randn(1, self.stylegan2.z_dim, device=self.device)}

    def process_synthesizer_inputs(self, latent_w):
        return {"latent_w_plus": latent_w}

    def process_outputs(self, video):
        return video


class StyleGAN3Patch(MauaPatch):
    """The alias-free variant: the synthesizer also takes per-frame
    translation and rotation, which drive the Fourier input transform.
    A `model_file` brings its own config; otherwise, without a `cfg` in
    `stylegan_kwargs`, the net is the default config at the output size's
    resolution."""

    def __init__(
        self,
        model_file: Optional[str],
        audio_file: str,
        fps: float = 24,
        offset: float = 0,
        duration: float = -1,
        output_size: Tuple[int, int] = (1024, 1024),
        resize_strategy: str = "stretch",  # SG3 has no layer hooks: these two
        resize_layer: int = 0,  # are accepted for generate.py's call and unused
        device=None,
        **stylegan_kwargs,
    ):
        super().__init__(audio_file, fps, offset, duration, device)
        cfg = stylegan_kwargs.pop("cfg", None) or SG3Config(img_resolution=max(output_size))
        self.stylegan3 = StyleGAN3(cfg=cfg, model_file=model_file, device=self.device, **stylegan_kwargs)
        self.mapper = self.stylegan3.mapper
        self.synthesizer = self.stylegan3.synthesizer
        self.synthesizer_output_size = output_size

    def process_mapper_inputs(self):
        return {"latent_z": torch.randn(1, self.stylegan3.z_dim, device=self.device)}

    def process_synthesizer_inputs(self, latent_w):
        return {"latent_w_plus": latent_w}

    def process_outputs(self, video):
        return video


def get_patch_from_file(filepath: str, class_name: Optional[str] = None):
    """The MauaPatch subclass defined in a user's .py file."""
    name = "maua_torch_user_patch_" + Path(filepath).stem
    spec = importlib.util.spec_from_file_location(name, filepath)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    for _, cls in inspect.getmembers(module, inspect.isclass):
        if issubclass(cls, MauaPatch) and cls not in (MauaPatch, StyleGAN2Patch, StyleGAN3Patch):
            if class_name is None or cls.__name__ == class_name:
                return cls
    raise ValueError(f"no MauaPatch subclass{'' if class_name is None else ' named ' + class_name} in {filepath}")
