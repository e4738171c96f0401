"""Video writing through an ffmpeg pipe.

Port of the writer the audio-reactive CLI needs from
`maua_tpu/ops/video.py`: uint8 RGB frames go to the ffmpeg binary's
stdin and come out as H.264 in yuv420p, muxed with the audio when one
is given. Without an ffmpeg binary on PATH it raises.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np


class VideoWriter:
    def __init__(self, output_file: str, size: Tuple[int, int], fps: float = 24, audio_file: Optional[str] = None,
                 preset: str = "fast", crf: int = 18):
        if shutil.which("ffmpeg") is None:
            raise RuntimeError("writing video needs the ffmpeg binary on PATH")
        w, h = size
        cmd = ["ffmpeg", "-y", "-v", "error", "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{w}x{h}",
               "-r", str(fps), "-i", "-"]
        if audio_file is not None:
            cmd += ["-i", audio_file, "-c:a", "aac", "-shortest"]
        cmd += ["-c:v", "libx264", "-preset", preset, "-crf", str(crf), "-pix_fmt", "yuv420p",
                "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2", output_file]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)

    def write(self, frame: np.ndarray) -> None:
        self.proc.stdin.write(np.ascontiguousarray(frame, np.uint8).tobytes())

    def close(self) -> None:
        self.proc.stdin.close()
        if self.proc.wait() != 0:
            raise RuntimeError(f"ffmpeg exited with code {self.proc.returncode}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_video(frames: np.ndarray, output_file: str, fps: float = 24, audio_file: Optional[str] = None) -> None:
    """Write (T, H, W, 3) uint8 frames to a video file."""
    t, h, w, _ = frames.shape
    with VideoWriter(output_file, (w, h), fps, audio_file=audio_file) as video:
        for f in frames:
            video.write(f)
