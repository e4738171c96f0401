"""Audio-reactive generation driver and CLI.

Port of `maua_tpu/audiovisual/generate.py`: patch file -> audio features
-> mapper -> per-frame synthesizer inputs -> renderer, with the stage
times recorded. Runs on `device` (cuda unless told otherwise).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple
from uuid import uuid4

import torch

from ..utility import resolve_device
from .patches.base import get_patch_from_file
from .render import get_output_class


def generate_audiovisual_from_patch(
    audio_file: str,
    model_file: Optional[str],
    patch_file: str,
    patch_name: Optional[str] = None,
    renderer: str = "ffmpeg",
    renderer_kwargs: Optional[dict] = None,
    fps: float = 24,
    out_size: Tuple[int, int] = (1024, 1024),
    resize_strategy: str = "stretch",
    resize_layer: int = 0,
    device=None,
    stylegan_kwargs: Optional[dict] = None,
    stage_times: Optional[Dict[str, float]] = None,
):
    """Render a patch over an audio file. Returns (video, (audio, sr)):
    the frames array for "memmap", the output path for "ffmpeg".

    `stylegan_kwargs` go to the patch's StyleGAN2 or StyleGAN3 (cfg,
    params, seed; dtype, which also sets a `model_file` checkpoint's
    compute dtype); `stage_times`, when given,
    receives the seconds of each stage (audio_features, mapper,
    modulation, render), each ending in a device synchronization."""
    device = resolve_device(device)
    renderer_kwargs = dict(renderer_kwargs or {})
    patch = get_patch_from_file(patch_file, patch_name)(
        model_file, audio_file, fps=fps, offset=0, duration=-1, output_size=out_size,
        resize_strategy=resize_strategy, resize_layer=resize_layer, device=device, **(stylegan_kwargs or {}),
    )
    stage_t = {} if stage_times is None else stage_times

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stage_t[name] = time.perf_counter() - t0
        return out

    stage("audio_features", patch.process_audio)
    mapper_inputs = patch.process_mapper_inputs()
    mapped_inputs = stage("mapper", lambda: patch.mapper(**mapper_inputs))
    synthesizer_inputs = stage("modulation", lambda: patch.process_synthesizer_inputs(mapped_inputs))
    if not isinstance(synthesizer_inputs, dict):
        synthesizer_inputs = {"latent_w_plus": synthesizer_inputs}

    renderer_kwargs.setdefault("fps", patch.fps)
    if renderer == "ffmpeg":
        renderer_kwargs.setdefault("audio_file", patch.audio_file)
    model = getattr(patch, "stylegan2", None) or getattr(patch, "stylegan3", None)
    video = stage("render", lambda: get_output_class(renderer)(**renderer_kwargs)(
        model.render, synthesizer_inputs, patch.process_outputs))
    print("audiovisual stages: " + ", ".join(f"{k} {v:.2f}s" for k, v in stage_t.items()), file=sys.stderr)
    return video, (patch.audio, patch.sr)


def main(args=None):
    # fmt: off
    parser = argparse.ArgumentParser(description="audio-reactive GAN video synthesis")
    parser.add_argument("--audio_file", required=True, type=str, help="Path to audio file")
    parser.add_argument("--model_file", default=None, type=str, help="Path to checkpoint of the model to use")
    parser.add_argument("--patch_file", required=True, type=str, help="The file defining the audio-reactive modulations of the GAN inputs")
    parser.add_argument("--patch_name", default=None, type=str, help="Which patch class to use (if multiple in the file)")
    parser.add_argument("--renderer", default="ffmpeg", type=str, choices=["ffmpeg", "memmap"])
    parser.add_argument("--ffmpeg_preset", default="fast", type=str)
    parser.add_argument("--fps", default=24, type=float)
    parser.add_argument("--out_size", default="1024,1024", type=str)
    parser.add_argument("--resize_strategy", default="stretch", type=str)
    parser.add_argument("--resize_layer", default=0, choices=list(range(18)), type=int)
    parser.add_argument("--out_dir", default="./output/", type=str)
    parser.add_argument("--unique", action="store_true")
    parser.add_argument("--device", default="cuda", type=str, help="Device to run on (cuda or cpu)")
    args = parser.parse_args(args)
    # fmt: on

    checkpoint_name = Path(str(args.model_file).replace("/network-snapshot", "")).stem
    output_file = (
        f"{args.out_dir}/{Path(args.audio_file).stem}_{checkpoint_name}_{args.resize_strategy}_"
        f"{args.out_size.replace(',', 'x')}.mp4"
    )
    if args.unique:
        output_file = output_file.replace(".mp4", f"-{str(uuid4())[:6]}.mp4")
    out_size = tuple(int(s) for s in args.out_size.split(","))

    Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    renderer_kwargs = {}
    if args.renderer == "ffmpeg":
        renderer_kwargs = dict(output_file=output_file, ffmpeg_preset=args.ffmpeg_preset)

    video, _ = generate_audiovisual_from_patch(
        audio_file=args.audio_file,
        model_file=args.model_file,
        patch_file=args.patch_file,
        patch_name=args.patch_name,
        renderer=args.renderer,
        renderer_kwargs=renderer_kwargs,
        fps=args.fps,
        out_size=out_size,
        resize_strategy=args.resize_strategy,
        resize_layer=args.resize_layer,
        device=args.device,
    )
    if args.renderer == "memmap":
        from ..ops.video import write_video

        write_video(video, output_file, fps=args.fps, value_range=(0, 255), audio_file=args.audio_file)
    print(output_file)


if __name__ == "__main__":
    main()
