"""Coarse-to-fine multi-resolution style transfer schedules.

Port of `maua_tpu/style/multires.py`: transfer at increasing sizes, each
scale's output (resized) the next scale's initial image.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..ops.image import resample
from . import image as style_image


def transfer_multires(content_img, style_imgs, sizes: Sequence[int] = (256, 512),
                      n_iters_per_scale: Optional[Sequence[int]] = None, **kwargs):
    """`style_image.transfer` at each size, from the content at the first and from the previous
    scale's output after; returns the last (1, H, W, 3) in [-1, 1]."""
    iters = list(n_iters_per_scale or [512 // len(sizes)] * len(sizes))
    out = None
    for size, n_iters in zip(sizes, iters):
        init = None if out is None else (resample(out, size) + 1) / 2
        out = style_image.transfer(content_img, style_imgs, init_img=init,
                                   init_type="content" if init is None else "init_img", size=size, n_iters=n_iters,
                                   **kwargs)
    return out


def transfer_multires_video(video_file, style_imgs, sizes: Sequence[int] = (128, 256),
                            n_iters_per_scale: Optional[Sequence[int]] = None, passes_per_scale: int = 6,
                            first_scale_passes: int = 16, **kwargs):
    """Coarse-to-fine video style transfer: the first (coarsest) scale runs `first_scale_passes`
    from the content; each later scale starts from the previous scale's frames and runs
    `passes_per_scale`."""
    from . import video as style_video

    iters = list(n_iters_per_scale or [256 // len(sizes)] * len(sizes))
    video = None
    for scale_i, (size, n_iters) in enumerate(zip(sizes, iters)):
        video = style_video.transfer(
            video_file, style_imgs, init_type="content" if video is None else "init_video",
            init_video=None if video is None else (video + 1) / 2, size=size, n_iters=n_iters,
            n_passes=first_scale_passes if scale_i == 0 else passes_per_scale, **kwargs)
    return video
