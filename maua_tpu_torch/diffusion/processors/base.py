"""Diffusion processor interface.

Port of `maua_tpu/diffusion/processors/base.py`: every diffusion model is
a partial-denoise transform over [-1, 1] images with the signature
forward(img, prompts, t_start, t_end=1).
"""

from __future__ import annotations


class BaseDiffusionProcessor:
    image_size: int = 512

    def forward(self, img, prompts, t_start, t_end=1.0, verbose=True):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)
