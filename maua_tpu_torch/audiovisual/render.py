"""Renderers: drive the synthesizer over per-frame inputs and deliver frames.

Port of `maua_tpu/audiovisual/render.py`: MemMap gathers the frames into
one array; FFMPEG streams them into a video file through an ffmpeg pipe
(it needs the ffmpeg binary).
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
    def __init__(self, output_file: str, fps: float = 24, audio_file: Optional[str] = None, batch_size: int = 8,
                 ffmpeg_preset: str = "fast", **_):
        self.output_file = output_file
        self.fps = fps
        self.audio_file = audio_file
        self.batch_size = batch_size
        self.preset = ffmpeg_preset

    def __call__(self, synthesizer_render, synthesizer_inputs: Dict, postprocess: Optional[Callable] = None):
        from ..ops.video import VideoWriter

        latents, translation, zoom, rotation, noises = _split_inputs(synthesizer_inputs)
        frames = synthesizer_render(latents, noises=noises, translation=translation, zoom=zoom, rotation=rotation,
                                    batch_size=self.batch_size, postprocess=postprocess)
        writer = None
        try:
            for frame in frames:
                if writer is None:
                    h, w = frame.shape[:2]
                    writer = VideoWriter(self.output_file, (w, h), self.fps, audio_file=self.audio_file,
                                         preset=self.preset)
                writer.write(frame)
        finally:
            if writer is not None:
                writer.close()
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
