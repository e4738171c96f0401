"""Self-supervised audio-reactive video: audio -> music information -> a
seeded random Patch -> latent and noise windows -> StyleGAN2 -> video.

Port of `maua_tpu/audiovisual/selfsupervised/sample.py` (generate, main),
on `device` (cuda unless told otherwise). The synthesis gets every
layer's noise explicitly and no output resize, so the StyleGAN2 facade
renders on its space-to-depth route; frames are delivered through
`pipelined_frames` into the `VideoWriter`.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ...audio.io import load_audio
from ...gan.wrappers import StyleGAN2, layer_names
from ...ops.signal import resample_1d
from ...ops.video import VideoWriter, ffmpeg_available, pipelined_frames
from ...utility import StageClock, resolve_device
from . import patch as P
from .mir import retrieve_music_information


def generate(
    audio_file: str,
    model_file: Optional[str] = None,
    output_file: Optional[str] = None,
    fps: float = 24,
    seed: int = 42,
    batch_size: int = 8,
    downscale_factor: int = 1,
    n_palette: int = 16,
    stylegan_kwargs: Optional[dict] = None,
    max_seconds: Optional[float] = None,
    verbose: bool = True,
    device=None,
    stage_times: Optional[Dict[str, float]] = None,
) -> str:
    """Render a seeded random patch over an audio file; returns the video's
    path. `stage_times`, when given, receives the seconds of mir, patch
    (realization) and render (the frame loop to the closed file), of that
    the host seconds of the noise windows, of the synthesis and of the
    writes, and on a card the ms between the CUDA events that end each of
    the first two (StageClock)."""
    device = resolve_device(device)
    clock = StageClock(device, stage_times)
    audio, sr, duration = load_audio(audio_file, duration=max_seconds or -1)
    features, segmentations, tempo = clock.stage(
        "mir", lambda: retrieve_music_information(torch.from_numpy(audio).to(device), sr))

    gan = StyleGAN2(model_file, device=device, **(stylegan_kwargs or {}))
    n_frames = round(duration * fps)

    # features are at hop 1024; resample everything to the render's fps
    features = {k: resample_1d(v, n_frames) for k, v in features.items()}
    seg_t = next(iter(segmentations.values())).shape[0]
    frame_idx = np.clip((np.arange(n_frames) * seg_t / n_frames).astype(int), 0, seg_t - 1)
    segmentations = {k: np.asarray(v)[frame_idx] for k, v in segmentations.items()}

    patch = P.Patch(features, segmentations, tempo, fps=fps, seed=seed)
    if verbose:
        print(patch)

    names = layer_names(gan.cfg)[1:]
    # per-layer noise sizes follow the synthesis layer resolutions
    sizes = [int(n.split(".")[0][1:]) for n in names]

    def realize():
        palette = gan.mapper(P.seeded_normal(seed, (n_palette, gan.z_dim), device))
        return patch(palette, downscale_factor=downscale_factor, noise_sizes=sizes)

    latents, noise_modules = clock.stage("patch", realize)
    # broadcast latents to w+ when the patch produced (T, 1, D)
    if latents.shape[1] != gan.num_ws:
        latents = latents[:, :1].repeat(1, gan.num_ws, 1)

    out_file = output_file or f"output/{Path(audio_file).stem}_patch{seed}.mp4"
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    res = gan.rcfg.output_size or (gan.res, gan.res)
    pix_fmt = "yuv420p" if ffmpeg_available() and res[0] % 2 == 0 and res[1] % 2 == 0 else "rgb24"

    def batches():
        for i in range(0, n_frames, batch_size):
            b = min(batch_size, n_frames - i)
            t0 = clock.mark()
            noises = {name: mod(i, b)[:, None] for name, mod in zip(names, noise_modules)}
            t1 = clock.mark("noise_windows", t0)
            imgs = gan.synthesizer(latents[i : i + b], noises=noises).permute(0, 2, 3, 1)
            frames = ((imgs + 1) * 127.5).clamp(0, 255).to(torch.uint8)
            clock.mark("synthesis", t1)
            yield frames
            if verbose and (i // batch_size) % 10 == 0:
                print(f"frame {i}/{n_frames}")

    def render():
        write_s = 0.0
        with VideoWriter(out_file, res, fps, audio_file=audio_file, value_range=(0, 255), pix_fmt=pix_fmt) as vid:
            for f in pipelined_frames(batches(), pix_fmt):
                t0 = time.perf_counter()
                vid.write(f.tobytes())
                write_s += time.perf_counter() - t0
            t0 = time.perf_counter()
        return write_s + time.perf_counter() - t0

    write_s = clock.stage("render", render)
    if stage_times is not None:
        stage_times["write"] = write_s
    clock.finish()
    return out_file


def main(args=None):
    import argparse

    parser = argparse.ArgumentParser(description="self-supervised audio-reactive generation")
    parser.add_argument("--audio_file", required=True)
    parser.add_argument("--model_file", default=None)
    parser.add_argument("--output_file", default=None)
    parser.add_argument("--fps", default=24, type=float)
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--device", default="cuda", type=str, help="Device to run on (cuda or cpu)")
    args = parser.parse_args(args)
    print(generate(args.audio_file, args.model_file, args.output_file, fps=args.fps, seed=args.seed,
                   batch_size=args.batch_size, device=args.device))


if __name__ == "__main__":
    main()
