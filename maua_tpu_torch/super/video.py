"""Video super-resolution and frame-rate interpolation.

Port of `maua_tpu/super/video.py` (upscale_video, interpolate_video,
main). Videos are decoded with OpenCV (`ops/video.read_video`) and written
through `ops/video.VideoWriter`: ffmpeg where its binary is on PATH (the
frames then converted to I420 on the card), else OpenCV's mp4v. Upscaled
batches reach the writer through `pipelined_frames`.

    python -m maua_tpu_torch super video clip.mp4 --mode upscale --model_name RealESRGAN-x4plus
    python -m maua_tpu_torch super video clip.mp4 --mode interpolate -if 4
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import torch

from ..ops.video import VideoWriter, ffmpeg_available, pipelined_frames, read_video
from . import rife
from .image import Upscaler


def upscale_video(video_file: str, output_file: Optional[str] = None, model_name: str = "RealESRGAN-x4plus",
                  batch_size: int = 4, max_frames: Optional[int] = None, device=None) -> str:
    """Upscale every frame with a registry model; returns the output path."""
    frames, fps = read_video(video_file, max_frames=max_frames)
    model = Upscaler(model_name, device=device)
    t, h, w, _ = frames.shape
    wo, ho = w * model.scale, h * model.scale
    # convert to the encoder's colorspace on the card: half the bytes to copy
    yuv = ffmpeg_available() and ho % 2 == 0 and wo % 2 == 0
    out_file = output_file or str(Path(video_file).with_suffix("")) + f"_{model_name}.mp4"
    with VideoWriter(out_file, (wo, ho), fps, value_range=(0, 1), pix_fmt="yuv420p" if yuv else "rgb24") as writer:
        def batches():
            for i in range(0, t, batch_size):
                up = model(frames[i : i + batch_size])
                if yuv:
                    up = torch.clamp(torch.round(up * 255.0), 0, 255).to(torch.uint8)
                yield up

        for f in pipelined_frames(batches(), "yuv420p" if yuv else "rgb24"):
            writer.write(f)
    return out_file


def interpolate_video(video_file: str, output_file: Optional[str] = None, factor: int = 2, slower: int = 1,
                      decimate: int = 1, max_frames: Optional[int] = None, params=None,
                      cfg: rife.RIFEConfig = rife.RIFEConfig(), device=None) -> str:
    """RIFE 2^n frame-rate boost; returns the output path.

    Output frame rate = original fps * factor / slower / decimate: `slower`
    keeps every frame and slows playback, `decimate` keeps every d'th frame."""
    frames, fps = read_video(video_file, max_frames=max_frames)
    t, h, w, _ = frames.shape
    yuv = ffmpeg_available() and h % 2 == 0 and w % 2 == 0
    pix_fmt = "yuv420p" if yuv else "rgb24"
    out_fps = fps * factor / max(slower, 1) / max(decimate, 1)
    out_file = output_file or str(Path(video_file).with_suffix("")) + f"_{factor}x.mp4"
    with VideoWriter(out_file, (w, h), out_fps, value_range=(0, 1), pix_fmt=pix_fmt) as writer:
        stream = rife.interpolate(frames, factor=factor, params=params, cfg=cfg, pix_fmt=pix_fmt, device=device)
        for i, frame in enumerate(stream):
            if i % max(decimate, 1) == 0:
                writer.write(frame)
    return out_file


def main(args=None):
    parser = argparse.ArgumentParser(
        description="video super-resolution / frame interpolation. interpolate-mode output "
                    "frame rate = original_fps * interpolation_factor / slower / decimate")
    parser.add_argument("video_files", type=str, nargs="+")
    parser.add_argument("--mode", default="upscale", choices=["upscale", "interpolate"])
    parser.add_argument("--model_name", default="RealESRGAN-x4plus", type=str)
    parser.add_argument("-if", "--interpolation_factor", "--factor", dest="factor", default=2, type=int,
                        help="framerate multiplier (interpolate mode)")
    parser.add_argument("-s", "--slower", default=1, type=int,
                        help="factor to decrease output framerate by (interpolate mode)")
    parser.add_argument("-d", "--decimate", default=1, type=int,
                        help="alternative to --slower that keeps only every d'th frame")
    parser.add_argument("--batch_size", default=4, type=int)
    parser.add_argument("--max_frames", default=None, type=int)
    parser.add_argument("--output_file", default=None, type=str, help="only valid with a single input video")
    parser.add_argument("--device", default=None, type=str, help='default "cuda"; "cpu" runs on the CPU')
    args = parser.parse_args(args)

    if args.output_file and len(args.video_files) > 1:
        raise SystemExit("--output_file requires a single input video")
    for video_file in args.video_files:
        if args.mode == "upscale":
            out = upscale_video(video_file, output_file=args.output_file, model_name=args.model_name,
                                batch_size=args.batch_size, max_frames=args.max_frames, device=args.device)
        else:
            out = interpolate_video(video_file, output_file=args.output_file, factor=args.factor,
                                    slower=args.slower, decimate=args.decimate, max_frames=args.max_frames,
                                    device=args.device)
        print(out)
    return 0
