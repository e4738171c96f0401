"""Renderers: drive the synthesizer over per-frame inputs and deliver frames.

Port of `maua_tpu/audiovisual/render.py`: MemMap gathers the frames into
one array; FFMPEG streams them into a video file through ffmpeg, or
through OpenCV where there is no ffmpeg binary.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np


def _split_inputs(synthesizer_inputs: Dict):
    """Latents, camera motion and noise maps from a patch's input dict."""
    latents = synthesizer_inputs.get("latent_w_plus", synthesizer_inputs.get("latent_w"))
    noises = {k: v for k, v in synthesizer_inputs.items()
              if k.startswith(("noise", "b")) and hasattr(v, "ndim") and v.ndim >= 3}
    return (latents, synthesizer_inputs.get("translation"), synthesizer_inputs.get("zoom"),
            synthesizer_inputs.get("rotation"), noises or None)


class FFMPEG:
    """Stream frames into a threaded video writer (`ops/video.VideoWriter`:
    ffmpeg, or OpenCV where there is no ffmpeg binary).

    Frames travel as planar I420 by default (`pix_fmt="yuv420p"`, half the
    bytes of rgb24, converted on the device). `pix_fmt="dct"` (maua_tpu's
    default) encodes each batch with the DCT frame codec on the device, copies
    only its packed bytes and decodes them to I420 on the host; it goes the
    yuv420p way for sizes that are not 16-aligned. "rgb24" pipes raw RGB. Odd
    frame sizes fall back to rgb24. The writer receives I420 for both
    yuv420p and dct."""

    def __init__(self, output_file: str, fps: float = 24, audio_file: Optional[str] = None,
                 batch_size: int = 32, pix_fmt: Optional[str] = None, **writer_kwargs):
        self.output_file = output_file
        self.fps = fps
        self.audio_file = audio_file
        self.batch_size = batch_size
        self.pix_fmt = pix_fmt
        self.writer_kwargs = writer_kwargs

    def __call__(self, synthesizer_render, synthesizer_inputs: Dict, postprocess: Optional[Callable] = None):
        from ..ops.video import VideoWriter

        pix_fmt = self.pix_fmt or "yuv420p"
        latents, translation, zoom, rotation, noises = _split_inputs(synthesizer_inputs)

        def make_iter(fmt):
            return synthesizer_render(latents, noises=noises, translation=translation, zoom=zoom,
                                      rotation=rotation, batch_size=self.batch_size, postprocess=postprocess,
                                      pix_fmt=fmt)

        frame_iter = make_iter(pix_fmt)
        try:
            first = next(frame_iter)
        except ValueError as e:
            # odd frame dimensions cannot be I420: the rgb24 pipe pads them
            if pix_fmt not in ("yuv420p", "dct") or "even frame dimensions" not in str(e):
                raise
            pix_fmt = "rgb24"
            frame_iter = make_iter(pix_fmt)
            first = next(frame_iter)
        writer_fmt = "yuv420p" if pix_fmt in ("yuv420p", "dct") else pix_fmt
        if writer_fmt == "yuv420p":
            h, w = first.shape[0] * 2 // 3, first.shape[1]
        else:
            h, w = first.shape[0], first.shape[1]
        duration = latents.shape[0] / self.fps
        with VideoWriter(self.output_file, (w, h), self.fps, audio_file=self.audio_file, audio_duration=duration,
                         value_range=(0, 255), pix_fmt=writer_fmt, **self.writer_kwargs) as video:
            video.write(first.tobytes())
            for frame in frame_iter:
                video.write(frame.tobytes())
        return self.output_file


class MemMap:
    def __init__(self, batch_size: int = 8, **_):
        self.batch_size = batch_size

    def __call__(self, synthesizer_render, synthesizer_inputs: Dict, postprocess: Optional[Callable] = None):
        latents, translation, zoom, rotation, noises = _split_inputs(synthesizer_inputs)
        return np.stack(list(synthesizer_render(latents, noises=noises, translation=translation, zoom=zoom,
                                                rotation=rotation, batch_size=self.batch_size,
                                                postprocess=postprocess)))


def get_output_class(renderer: str):
    if renderer == "ffmpeg":
        return FFMPEG
    if renderer == "memmap":
        return MemMap
    raise ValueError(f"unknown renderer {renderer}")
